// Predicate -> packed bitset (B5), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/bitset_pack.py:predicate_bitset
// (body _kernel): the build side of the paper's §3.2.2 Alternative 2.
// Bit j of word w of a row is column[row, 32 w + j] == value; the pad bits
// past the row's n columns are 0.  Each row is packed from bit 0 (the
// node-stacked layout: one row per node).
//
// Bound on this card: bytes, 4 B read per column and one bit written.
//
// Design.  A warp takes a tile of consecutive columns of one row and
// issues all of the tile's loads before it tests any.  Large inputs run
// on a persistent grid (as many blocks as fit the card at once, sized by
// the occupancy API) whose warps walk the (row, tile) pairs with a stride
// of the grid's warps, tiles of 512 columns (16 words, 64 bytes in flight
// a thread), so any number of rows runs in one launch.  An input whose
// words fit the card in one wave at one word a warp (and fewer than
// 65,536 rows) runs that grid instead, its row the grid's y index: its
// time is then one load and a ballot a warp, with no division on the way
// to the load (on q21's 412 KB input the persistent tiles took 0.1-0.6 us
// longer).  Two variants of the persistent tile:
// - 16-byte loads, where every row starts on 16 bytes (n % 4 == 0 and the
//   column does): lane l of step u loads columns 128 u + 4 l .. + 3 as one
//   int4 and forms a nibble; the 8 lanes of a word OR their shifted
//   nibbles in three __shfl_xor_sync steps, and lane u gathers the step's
//   4 words, which it stores as one 16-byte store where the output row
//   allows (else word by word).
// - scalar loads, everywhere else: lane l of step u tests column
//   32 u + l and __ballot_sync assembles the word; lane u stores it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps a block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// The persistent grid's tiles are 512 columns: 4 steps of 128 columns (4
// words) a lane in the 16-byte variant, 16 steps of 32 (a word) in the
// scalar one.
constexpr int kTileCols = 512;
constexpr int kVecSteps = kTileCols / 128;
constexpr int kScalarSteps = kTileCols / 32;

__device__ __forceinline__ void store4(uint32_t* p, long long w,
                                       long long words, uint4 v) {
  // words w .. w + 3 of an output row at p
  uint32_t* q = p + w;
  if (w + 4 <= words && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    *reinterpret_cast<uint4*>(q) = v;
    return;
  }
  if (w < words) q[0] = v.x;
  if (w + 1 < words) q[1] = v.y;
  if (w + 2 < words) q[2] = v.z;
  if (w + 3 < words) q[3] = v.w;
}

// The tile from column col0 of a row: src points at the row's column
// col0, dst at the row's first output word, left is the row's columns
// from col0.
__device__ __forceinline__ void vec_tile(const int* src, uint32_t* dst,
                                         long long left, long long col0,
                                         long long words, int value,
                                         int lane) {
  const int4* s = reinterpret_cast<const int4*>(src);
  int4 v[kVecSteps];
#pragma unroll
  for (int u = 0; u < kVecSteps; ++u)
    v[u] = 128 * u + 4 * lane < left ? __ldg(s + 32 * u + lane)
                                     : make_int4(0, 0, 0, 0);
  // lane 8 g + u keeps word g of step u (every lane of group g holds it)
  uint32_t keep = 0;
#pragma unroll
  for (int u = 0; u < kVecSteps; ++u) {
    uint32_t nib = 0;
    if (128 * u + 4 * lane < left)   // n % 4 == 0: all 4 columns or none
      nib = (uint32_t)(v[u].x == value) | (uint32_t)(v[u].y == value) << 1 |
            (uint32_t)(v[u].z == value) << 2 |
            (uint32_t)(v[u].w == value) << 3;
    uint32_t w = nib << (4 * (lane & 7));
    w |= __shfl_xor_sync(kFull, w, 1);
    w |= __shfl_xor_sync(kFull, w, 2);
    w |= __shfl_xor_sync(kFull, w, 4);
    if ((lane & 7) == u) keep = w;
  }
  // lane u < kVecSteps gathers step u's 4 words and stores them at once
  const int u = lane & 7;
  const uint4 four = make_uint4(
      __shfl_sync(kFull, keep, u), __shfl_sync(kFull, keep, 8 + u),
      __shfl_sync(kFull, keep, 16 + u), __shfl_sync(kFull, keep, 24 + u));
  if (lane < kVecSteps) store4(dst, col0 / 32 + 4 * lane, words, four);
}

__device__ __forceinline__ void scalar_tile(const int* src, uint32_t* dst,
                                            long long left, long long col0,
                                            long long words, int value,
                                            int lane) {
  int v[kScalarSteps];
#pragma unroll
  for (int u = 0; u < kScalarSteps; ++u)
    v[u] = 32 * u + lane < left ? __ldg(src + 32 * u + lane) : 0;
  uint32_t mine = 0;
#pragma unroll
  for (int u = 0; u < kScalarSteps; ++u) {
    const uint32_t bits =
        __ballot_sync(kFull, 32 * u + lane < left && v[u] == value);
    if (lane == u) mine = bits;
  }
  const long long w = col0 / 32 + lane;
  if (lane < kScalarSteps && w < words) dst[w] = mine;
}

// one word a warp, lane j testing column 32 w + j: row blockIdx.y (n
// fits 32 bits here: the whole input fits one wave)
__global__ void __launch_bounds__(kThreads)
bitset_wave_kernel(const int* __restrict__ column, uint32_t* __restrict__ out,
                   int n, int words, int value) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= words) return;            // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int i = w * 32 + lane;
  const long long row = blockIdx.y;
  const bool hit = i < n && __ldg(column + row * n + i) == value;
  const uint32_t bits = __ballot_sync(kFull, hit);
  if (lane == 0) out[row * words + w] = bits;
}

// persistent: warps walk the (row, tile) pairs
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
bitset_persistent_kernel(const int* __restrict__ column,
                         uint32_t* __restrict__ out, long long n,
                         long long words, long long tiles, long long total,
                         int value) {
  const int lane = threadIdx.x & 31;
  const bool small = total <= 0xffffffffLL;   // 32-bit division then
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       item < total; item += stride) {
    const long long row =
        small ? (long long)((uint32_t)item / (uint32_t)tiles) : item / tiles;
    const long long col0 = (item - row * tiles) * kTileCols;
    const int* src = column + row * n + col0;
    uint32_t* dst = out + row * words;
    if constexpr (VEC)
      vec_tile(src, dst, n - col0, col0, words, value, lane);
    else
      scalar_tile(src, dst, n - col0, col0, words, value, lane);
  }
}

// blocks of a kernel that fit the card at once, asked once for each
template <auto kernel>
long long resident_blocks() {
  static int per_sm = 0;
  static int sms = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    if (per_sm < 1) per_sm = 1;
  }
  return (long long)per_sm * sms;
}

template <bool VEC>
int launch(const int* column, uint32_t* out, long long rows, long long n,
           int value, cudaStream_t stream) {
  const long long words = (n + 31) / 32;
  const long long wave_blocks = (words + kWarps - 1) / kWarps;
  if (rows <= 65535 &&
      rows * wave_blocks <= resident_blocks<bitset_wave_kernel>()) {
    bitset_wave_kernel<<<dim3((unsigned)wave_blocks, (unsigned)rows),
                         kThreads, 0, stream>>>(column, out, (int)n,
                                                (int)words, value);
    return (int)cudaGetLastError();
  }
  // persistent grid: as many blocks as fit the card at once, and no more
  // than one for each kWarps work items
  const long long tiles = (n + kTileCols - 1) / kTileCols;
  const long long total = rows * tiles;
  long long blocks = (total + kWarps - 1) / kWarps;
  const long long resident = resident_blocks<bitset_persistent_kernel<VEC>>();
  if (blocks > resident) blocks = resident;
  bitset_persistent_kernel<VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      column, out, n, words, tiles, total, value);
  return (int)cudaGetLastError();
}

}  // namespace

// column: (rows, n) int32; out: (rows, ceil(n / 32)) uint32.  vec: every
// row starts on 16 bytes (n % 4 == 0 and the column does): 16-byte loads.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_predicate_bitset(const void* column, void* out,
                                      long long rows, long long n, int value,
                                      int vec, void* stream) {
  if (rows == 0 || n == 0) return 0;
  const int* c = (const int*)column;
  uint32_t* o = (uint32_t*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch<true>(c, o, rows, n, value, st)
             : launch<false>(c, o, rows, n, value, st);
}
