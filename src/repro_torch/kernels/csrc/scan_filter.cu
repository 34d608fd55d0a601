// Predicate-on-packed scan (B1), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/scan_filter.py:scan_filter_pallas
// (body _kernel / _group_scan).  Codes are bit-packed at `width` bits
// (1..30) into 32-bit words; 32 consecutive rows occupy exactly `width`
// words from a word boundary.  For each group of 32 rows the kernel tests
// lo <= code <= hi (optionally negated) and writes one validity word: bit
// j of word g is the test of row 32 g + j; rows >= `rows` are never valid,
// negated or not.  lo and hi are any int32.
//
// Bounds, as the TPU kernel's (1, 2) bounds block: `lanes` pairs (lo, hi)
// read from device memory (a (lanes, 2) int32 array, one pair a prepared
// binding), or, without that array, one pair passed by value.  Every lane
// is tested in the one pass over the words: lane b's bitset is out[b].
// Each lane's range is clipped into [0, 2^width) here on the device.
//
// Bound on this card: bytes.  Per row it reads width/32 of a word and
// writes one bit a lane, and does a handful of integer operations a lane,
// so the least time is (packed words + lanes * bitset words) * 4 B over
// the memory rate; at many lanes the compares (about four integer
// operations a row and lane) come near it.
//
// Design.  The node-stacked (nodes, groups * width) words are one
// contiguous stream of nodes * groups groups; a group's node row only sets
// which rows are past `rows` (g mod groups).  A warp takes a tile of 32
// consecutive groups (32 * width words, 128 * width bytes): it loads them
// coalesced (16-byte vectors where the stream starts on 16 bytes: a tile
// spans a multiple of 16 bytes, so then every tile does) into shared
// memory, each thread builds the word of its own group from the shared
// copy, and the warp stores its 32 words of each lane of bounds as one
// 128-byte store.  Each group's row in shared memory has an odd stride
// (width, or width + 1), so the 32 threads reading word i of their groups
// hit 32 banks.  `width`
// is a template parameter (one switch over 1..30), so every word index
// and shift of the 32 codes is a constant, as in the TPU kernel's static
// j loop.  The grid is persistent: each warp walks tiles with a stride of
// the grid's warps and issues the next tile's loads into registers before
// it tests the current one, so an SM keeps tens of KB in flight.  A
// thread extracts its group's 32 codes into registers once and tests them
// against every lane of bounds in turn.  The range test is one unsigned
// compare, (code - lo') <= hi' - lo', with lo and hi clipped to
// [0, 2^width) (an empty range never passes).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;          // warps a block
constexpr int kThreads = kWarps * 32;

template <int W, bool VEC>
struct Tile {
  // a tile's words in registers: VEC, chunk c = lane + 32 p of 4 words;
  // scalar, word k = lane + 32 r
  static constexpr int kChunks = 8 * W;                 // 16-byte chunks
  static constexpr int kRegs = VEC ? (kChunks + 31) / 32 : W;
  using Reg = typename std::conditional<VEC, uint4, uint32_t>::type;
  Reg r[kRegs];
};

template <int W>
__device__ __forceinline__ int smem_index(int k) {
  // word k of a tile -> its place in shared memory, rows of odd stride
  if constexpr (W & 1) return k;
  else return k + k / W;
}

template <int W, bool VEC>
__device__ __forceinline__ void load_tile(Tile<W, VEC>& t,
                                          const uint32_t* __restrict__ words,
                                          long long tile, long long total,
                                          int lane) {
  const uint32_t* base = words + tile * (32LL * W);
  const bool full = tile * 32 + 32 <= total;
  const long long nwords = full ? 32LL * W : (total - tile * 32) * W;
  if constexpr (VEC) {
#pragma unroll
    for (int p = 0; p < Tile<W, VEC>::kRegs; ++p) {
      const int c = lane + 32 * p;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (c < Tile<W, VEC>::kChunks) {
        if (full) {
          v = __ldg(reinterpret_cast<const uint4*>(base) + c);
        } else {
          const int k = 4 * c;
          if (k < nwords) v.x = __ldg(base + k);
          if (k + 1 < nwords) v.y = __ldg(base + k + 1);
          if (k + 2 < nwords) v.z = __ldg(base + k + 2);
          if (k + 3 < nwords) v.w = __ldg(base + k + 3);
        }
      }
      t.r[p] = v;
    }
  } else {
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const int k = lane + 32 * r;
      t.r[r] = (full || k < nwords) ? __ldg(base + k) : 0u;
    }
  }
}

template <int W, bool VEC>
__device__ __forceinline__ void store_tile(const Tile<W, VEC>& t,
                                           uint32_t* sm, int lane) {
  if constexpr (VEC) {
#pragma unroll
    for (int p = 0; p < Tile<W, VEC>::kRegs; ++p) {
      const int c = lane + 32 * p;
      if (c >= Tile<W, VEC>::kChunks) continue;
      const uint4 v = t.r[p];
      if constexpr (W & 1) {
        reinterpret_cast<uint4*>(sm)[c] = v;   // stride W: the tile as is
      } else {
        const int k = 4 * c;
        sm[smem_index<W>(k)] = v.x;
        sm[smem_index<W>(k + 1)] = v.y;
        sm[smem_index<W>(k + 2)] = v.z;
        sm[smem_index<W>(k + 3)] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < W; ++r)
      sm[smem_index<W>(lane + 32 * r)] = t.r[r];
  }
}

// Clip (lo, hi) into the codes' range [0, 2^W): lo' and span = hi' - lo'.
// An empty range gets lo' = 2^W, so code - lo' wraps above span = 0 for
// every code.
template <int W>
__device__ __forceinline__ void clip_bounds(int lo, int hi, uint32_t& lo_u,
                                            uint32_t& span) {
  constexpr int kTop = (1 << W) - 1;
  const int lo_c = lo < 0 ? 0 : lo;
  const int hi_c = hi > kTop ? kTop : hi;
  lo_u = lo_c > hi_c ? (uint32_t)kTop + 1u : (uint32_t)lo_c;
  span = lo_c > hi_c ? 0u : (uint32_t)(hi_c - lo_c);
}

template <int W, bool VEC>
__global__ void __launch_bounds__(kThreads)
scan_filter_kernel(const uint32_t* __restrict__ words,
                   uint32_t* __restrict__ out, long long total,
                   long long groups, long long rows,
                   const int* __restrict__ bounds, int lanes, int lo_arg,
                   int hi_arg, uint32_t flip) {
  constexpr int S = W | 1;                    // odd stride of a group's row
  constexpr uint32_t kMask = (1u << W) - 1u;
  __shared__ __align__(16) uint32_t smem[kWarps][32 * S];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  uint32_t* sm = smem[wid];
  const long long ntiles = (total + 31) / 32;
  const long long stride = (long long)gridDim.x * kWarps;
  long long tile = (long long)blockIdx.x * kWarps + wid;
  if (tile >= ntiles) return;                 // uniform across the warp
  Tile<W, VEC> t;
  load_tile<W, VEC>(t, words, tile, total, lane);
  while (tile < ntiles) {
    __syncwarp();                             // the last tile's reads done
    store_tile<W, VEC>(t, sm, lane);
    __syncwarp();
    const long long next = tile + stride;
    if (next < ntiles) load_tile<W, VEC>(t, words, next, total, lane);
    const long long g = tile * 32 + lane;
    if (g < total) {
      uint32_t code[32];
      {
        uint32_t w[W];
#pragma unroll
        for (int i = 0; i < W; ++i) w[i] = sm[lane * S + i];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int bit = j * W;
          const int wi = bit >> 5;
          const int off = bit & 31;
          uint32_t v = w[wi] >> off;
          // off + W > 32 implies off > 0, so the shift below is < 32
          if (off + W > 32) v |= w[wi + 1] << (32 - off);
          code[j] = v & kMask;
        }
      }
      // the group's index in its node: 32-bit division where it fits
      const long long in_node =
          total <= 0xffffffffLL ? (long long)((uint32_t)g % (uint32_t)groups)
                                : g % groups;
      const long long live = rows - in_node * 32;
      const uint32_t rmask = live >= 32 ? 0xffffffffu
                             : live <= 0 ? 0u
                                         : (1u << (int)live) - 1u;
      for (int b = 0; b < lanes; ++b) {
        // the same address in every thread of the warp: one broadcast
        const int lo = bounds ? __ldg(bounds + 2 * b) : lo_arg;
        const int hi = bounds ? __ldg(bounds + 2 * b + 1) : hi_arg;
        uint32_t lo_u, span;
        clip_bounds<W>(lo, hi, lo_u, span);
        uint32_t bits = 0;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          bits |= (uint32_t)((code[j] - lo_u) <= span) << j;
        out[(long long)b * total + g] = (bits ^ flip) & rmask;
      }
    }
    tile = next;
  }
}

template <int W, bool VEC>
int launch(const uint32_t* words, uint32_t* out, long long total,
           long long groups, long long rows, const int* bounds, int lanes,
           int lo, int hi, uint32_t flip, cudaStream_t stream) {
  // persistent grid: as many blocks as fit the card at once, and no more
  // than one for each kWarps tiles; the occupancy is asked once for each
  // instantiation
  static int per_sm = 0;
  static int sms = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scan_filter_kernel<W, VEC>, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  const long long ntiles = (total + 31) / 32;
  long long blocks = (ntiles + kWarps - 1) / kWarps;
  const long long resident = (long long)per_sm * sms;
  if (blocks > resident) blocks = resident;
  scan_filter_kernel<W, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      words, out, total, groups, rows, bounds, lanes, lo, hi, flip);
  return (int)cudaGetLastError();
}

template <int W>
int launch_width(bool vec, const uint32_t* words, uint32_t* out,
                 long long total, long long groups, long long rows,
                 const int* bounds, int lanes, int lo, int hi, uint32_t flip,
                 cudaStream_t stream) {
  return vec ? launch<W, true>(words, out, total, groups, rows, bounds,
                               lanes, lo, hi, flip, stream)
             : launch<W, false>(words, out, total, groups, rows, bounds,
                                lanes, lo, hi, flip, stream);
}

}  // namespace

// words: (nodes, groups * width) uint32; out: (lanes, nodes, groups)
// uint32.  bounds: a (lanes, 2) int32 array in device memory, or null for
// one lane whose bounds are lo and hi.  vec: the words start on 16 bytes
// (16-byte loads).  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_scan_filter(const void* words, void* out, int nodes,
                                 long long groups, long long rows, int width,
                                 const void* bounds, int lanes, int lo,
                                 int hi, int negate, int vec, void* stream) {
  if (nodes == 0 || groups == 0 || lanes == 0) return 0;
  const uint32_t flip = negate ? 0xffffffffu : 0u;
  const long long total = (long long)nodes * groups;
  const uint32_t* w = (const uint32_t*)words;
  uint32_t* o = (uint32_t*)out;
  const int* bd = (const int*)bounds;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool v = vec != 0;
#define REPRO_SCAN_CASE(W)                                                \
  case W:                                                                 \
    return launch_width<W>(v, w, o, total, groups, rows, bd, lanes, lo, hi, \
                           flip, st);
  switch (width) {
    REPRO_SCAN_CASE(1) REPRO_SCAN_CASE(2) REPRO_SCAN_CASE(3)
    REPRO_SCAN_CASE(4) REPRO_SCAN_CASE(5) REPRO_SCAN_CASE(6)
    REPRO_SCAN_CASE(7) REPRO_SCAN_CASE(8) REPRO_SCAN_CASE(9)
    REPRO_SCAN_CASE(10) REPRO_SCAN_CASE(11) REPRO_SCAN_CASE(12)
    REPRO_SCAN_CASE(13) REPRO_SCAN_CASE(14) REPRO_SCAN_CASE(15)
    REPRO_SCAN_CASE(16) REPRO_SCAN_CASE(17) REPRO_SCAN_CASE(18)
    REPRO_SCAN_CASE(19) REPRO_SCAN_CASE(20) REPRO_SCAN_CASE(21)
    REPRO_SCAN_CASE(22) REPRO_SCAN_CASE(23) REPRO_SCAN_CASE(24)
    REPRO_SCAN_CASE(25) REPRO_SCAN_CASE(26) REPRO_SCAN_CASE(27)
    REPRO_SCAN_CASE(28) REPRO_SCAN_CASE(29) REPRO_SCAN_CASE(30)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_SCAN_CASE
}
