// Elias–Fano wire codec (B3), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of repro/kernels/wire_codec.py: the lane
// kernels _mask_fold_kernel, _mask_unfold_kernel, _lower_pack_kernel and
// _lower_unpack_kernel (launched through _row_call) and the jnp code around
// them in ef_encode / ef_decode.  Each entry point below computes the whole
// function that repro.kernels.ops.{mask_fold, mask_unfold, ef_encode,
// ef_decode} computes, and is bit-identical to the plain version in
// repro_torch/kernels/ref.py.
//
// Packed request row (uint32 words; l, uw, lw from compression.ef_params):
//   [ upper: uw words | lower: lw words | mask: ceil(cap/32) words ]
// Slot j of a row holds key k_j under mask bit m_j.  Valid keys of a row
// are an ascending prefix.  off_j = clamp(k_j - base, 0, domain - 1);
// hi_j = off_j >> l is at most 15; valid slot j sets upper bit hi_j + j;
// its low part off_j & (2^l - 1) is packed at width l from bit j * l.
//
// Bound on this card: bytes.  Encode reads 5 B per slot (int32 key, bool
// mask) and writes the row; decode reads the row and writes 5 B per slot;
// fold/unfold move 1 B per column and 1 bit.  Each slot costs a handful of
// integer operations, far below what the card can issue per byte.
//
// Design.  One warp covers 32 slots, so a grid of (row, chunk of warps)
// fills the card even when a launch has few rows (q4_sj: 64 rows of 8 M
// slots).
//  * ef_encode: warp g writes upper word g, mask word g and lower words
//    [g * l, g * l + l): 32 values of l bits are exactly l words.  Upper
//    word g holds the bits of slots [32 g - 15, 32 g + 31] (hi <= 15), so
//    each lane tests its slot of group g and, for lanes 17..31, the slot 32
//    earlier; __reduce_or_sync assembles the word.  No atomics, no zeroing
//    pass, no per-row pre-pass: the words are the same in any launch order.
//  * ef_decode: a per-row pass (one block per row) scans the zero counts of
//    the upper words with a block prefix sum until it has met the first 15
//    zeros, and records H[v] = (position of zero v+1) - v, the number of
//    keys with high part <= v.  Then one thread per slot: hi_j =
//    #{v : H[v] <= j}, the low part read across the word straddle, key =
//    base + ((hi << l) | lo), 0 on a masked slot.
//  * mask_fold: one warp per word, __ballot_sync.  mask_unfold: one thread
//    per column.
// Shifts by 32 are undefined in C: a low part that straddles words has a
// non-zero bit offset sh, so the shift 32 - sh is below 32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per block, warp-per-word kernels
constexpr int kThreads = kWarps * 32;
constexpr int kZeroThreads = 1024;      // threads of the per-row zero scan
constexpr int kMarkers = 15;            // EF_UNIVERSE - 1
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long clamp_off(int key, long long base,
                                               long long domain) {
  long long off = (long long)key - base;
  off = off < 0 ? 0 : off;
  return off > domain - 1 ? domain - 1 : off;
}

__global__ void mask_fold_kernel(const uint8_t* __restrict__ mask,
                                 uint32_t* __restrict__ out, long long cols,
                                 long long words) {
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= words) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const long long row = blockIdx.y;
  const long long j = g * 32 + lane;
  const bool v = j < cols && mask[row * cols + j];
  const uint32_t w = __ballot_sync(kFull, v);
  if (lane == 0) out[row * words + g] = w;
}

__global__ void mask_unfold_kernel(const uint32_t* __restrict__ words,
                                   uint8_t* __restrict__ out,
                                   long long in_words, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const long long row = blockIdx.y;
  out[row * n + j] = (__ldg(words + row * in_words + (j >> 5)) >> (j & 31)) & 1u;
}

__global__ void ef_encode_kernel(const int* __restrict__ keys,
                                 const uint8_t* __restrict__ mask,
                                 const long long* __restrict__ base,
                                 uint32_t* __restrict__ out, long long cap,
                                 long long domain, int l, long long uw,
                                 long long lw, long long row_words) {
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= uw) return;  // uniform across the warp; uw >= ceil(cap / 32)
  const int lane = threadIdx.x & 31;
  const long long row = blockIdx.y;
  const int* k = keys + row * cap;
  const uint8_t* m = mask + row * cap;
  uint32_t* o = out + row * row_words;
  const long long b = base[row];

  const long long j = g * 32 + lane;
  const bool v = j < cap && m[j];
  const long long off = v ? clamp_off(k[j], b, domain) : 0;
  uint32_t up = 0;
  if (v) {
    const long long pos = (off >> l) + j;
    if ((pos >> 5) == g) up = 1u << (pos & 31);
  }
  if (lane >= 32 - kMarkers && g > 0) {
    // slots 32 g - 15 .. 32 g - 1 may reach into word g (hi <= 15)
    const long long j2 = j - 32;
    if (j2 < cap && m[j2]) {
      const long long pos2 = (clamp_off(k[j2], b, domain) >> l) + j2;
      if ((pos2 >> 5) == g) up |= 1u << (pos2 & 31);
    }
  }
  up = __reduce_or_sync(kFull, up);
  if (lane == 0) o[g] = up;

  if (g * 32 >= cap) return;  // past the last slot group: upper words only
  const uint32_t mw = __ballot_sync(kFull, v);
  if (lane == 0) o[uw + lw + g] = mw;
  if (l == 0) return;
  const uint32_t lo = v ? (uint32_t)(off & ((1LL << l) - 1)) : 0u;
  uint32_t mine = 0;
  for (int kk = 0; kk < l; ++kk) {
    // bit offset of this lane's value inside word kk of the group
    const int b0 = lane * l - 32 * kk;
    uint32_t c = 0;
    if (b0 > -l && b0 < 32) c = b0 >= 0 ? (lo << b0) : (lo >> -b0);
    const uint32_t w = __reduce_or_sync(kFull, c);
    if (lane == kk) mine = w;
  }
  const long long wi = g * l + lane;
  if (lane < l && wi < lw) o[uw + wi] = mine;
}

// One block per row: H[row, v] for the first 15 zeros of the upper words.
__global__ void ef_zeros_kernel(const uint32_t* __restrict__ words,
                                int* __restrict__ H, long long uw,
                                long long row_words) {
  __shared__ int warp_incl[kZeroThreads / 32];
  const long long row = blockIdx.x;
  const uint32_t* up = words + row * row_words;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // a well-formed row always has 15 zeros; a malformed one decodes hi = 0
  if (threadIdx.x < kMarkers) H[row * kMarkers + threadIdx.x] = 0x7fffffff;
  int seen = 0;  // zeros before this chunk, the same in every thread
  for (long long c0 = 0; c0 < uw; c0 += blockDim.x) {
    const long long w = c0 + threadIdx.x;
    const uint32_t x = w < uw ? __ldg(up + w) : kFull;
    const int z = 32 - __popc(x);
    int incl = z;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_incl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int s = lane < nwarps ? warp_incl[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += t;
      }
      if (lane < nwarps) warp_incl[lane] = s;
    }
    __syncthreads();
    const int before = seen + (warp ? warp_incl[warp - 1] : 0) + incl - z;
    // this word holds zeros number before+1 .. before+z (1-based)
    for (int v = before + 1; v <= before + z && v <= kMarkers; ++v) {
      uint32_t inv = ~x;
      for (int r = v - 1 - before; r > 0; --r) inv &= inv - 1;
      const int pos = __ffs(inv) - 1;
      H[row * kMarkers + v - 1] = (int)(w * 32 + pos) - (v - 1);
    }
    seen += warp_incl[nwarps - 1];
    __syncthreads();  // warp_incl is rewritten by the next chunk
    if (seen >= kMarkers) break;
  }
}

__global__ void ef_decode_kernel(const uint32_t* __restrict__ words,
                                 const long long* __restrict__ base,
                                 const int* __restrict__ H,
                                 int* __restrict__ keys,
                                 uint8_t* __restrict__ mask, long long cap,
                                 int l, long long uw, long long lw,
                                 long long row_words) {
  __shared__ int h[kMarkers];
  const long long row = blockIdx.y;
  if (threadIdx.x < kMarkers) h[threadIdx.x] = H[row * kMarkers + threadIdx.x];
  __syncthreads();
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;
  const uint32_t* w = words + row * row_words;
  const bool v = (__ldg(w + uw + lw + (j >> 5)) >> (j & 31)) & 1u;
  int key = 0;
  if (v) {
    int hi = 0;
#pragma unroll
    for (int q = 0; q < kMarkers; ++q) hi += h[q] <= j;
    uint32_t lo = 0;
    if (l) {
      const long long bit = j * l;
      const long long wk = bit >> 5;
      const int sh = (int)(bit & 31);
      lo = __ldg(w + uw + wk) >> sh;
      if (sh + l > 32) lo |= __ldg(w + uw + wk + 1) << (32 - sh);
      lo &= (1u << l) - 1u;
    }
    key = (int)(base[row] + (((long long)hi << l) | lo));
  }
  keys[row * cap + j] = key;
  mask[row * cap + j] = v;
}

unsigned blocks_for(long long n, long long per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

}  // namespace

// All pointers are device pointers on the current device; each function
// launches on `stream` and returns the cudaError_t of its launches.

// mask: (rows, cols) bool -> out: (rows, words) uint32, words = ceil(cols/32)
extern "C" int repro_mask_fold(const void* mask, void* out, int rows,
                               long long cols, long long words,
                               void* stream) {
  if (rows == 0 || words == 0) return 0;
  mask_fold_kernel<<<dim3(blocks_for(words, kWarps), rows), kThreads, 0,
                     (cudaStream_t)stream>>>((const uint8_t*)mask,
                                             (uint32_t*)out, cols, words);
  return (int)cudaGetLastError();
}

// words: (rows, in_words) uint32 -> out: (rows, n) bool
extern "C" int repro_mask_unfold(const void* words, void* out, int rows,
                                 long long in_words, long long n,
                                 void* stream) {
  if (rows == 0 || n == 0) return 0;
  mask_unfold_kernel<<<dim3(blocks_for(n, kThreads), rows), kThreads, 0,
                       (cudaStream_t)stream>>>((const uint32_t*)words,
                                               (uint8_t*)out, in_words, n);
  return (int)cudaGetLastError();
}

// keys: (rows, cap) int32, mask: (rows, cap) bool, base: (rows,) int64
// -> out: (rows, uw + lw + ceil(cap/32)) uint32
extern "C" int repro_ef_encode(const void* keys, const void* mask,
                               const void* base, void* out, int rows,
                               long long cap, long long domain, int l,
                               long long uw, long long lw, void* stream) {
  if (rows == 0) return 0;
  const long long row_words = uw + lw + (cap + 31) / 32;
  ef_encode_kernel<<<dim3(blocks_for(uw, kWarps), rows), kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const int*)keys, (const uint8_t*)mask, (const long long*)base,
      (uint32_t*)out, cap, domain, l, uw, lw, row_words);
  return (int)cudaGetLastError();
}

// words: (rows, row_words) uint32, base: (rows,) int64, scratch: (rows, 15)
// int32 -> keys: (rows, cap) int32, mask: (rows, cap) bool
extern "C" int repro_ef_decode(const void* words, const void* base,
                               void* scratch, void* keys, void* mask,
                               int rows, long long cap, int l, long long uw,
                               long long lw, long long row_words,
                               void* stream) {
  if (rows == 0) return 0;
  ef_zeros_kernel<<<rows, kZeroThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int*)scratch, uw, row_words);
  int err = (int)cudaGetLastError();
  if (err) return err;
  ef_decode_kernel<<<dim3(blocks_for(cap, kThreads), rows), kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const long long*)base, (const int*)scratch,
      (int*)keys, (uint8_t*)mask, cap, l, uw, lw, row_words);
  return (int)cudaGetLastError();
}
