// Per-block top-k (B4), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/topk_select.py:block_topk (body
// _kernel): step 1 of the paper's §3.2.3 scheme.  Each row of values is
// cut into blocks of `block` elements (the last one padded with -inf and
// key INT32_MAX); per block, the k largest values and their keys in the
// order k masked-argmax sweeps emit them: value descending, ties to the
// lowest index (jnp.argmax).  Masked elements are -inf, and a block with
// F < k finite elements emits (-inf, key of its element 0) at every
// position j >= F, as a sweep over an all -inf block takes element 0.
//
// Bound on this card: bytes (each value and mask byte read once, the
// winners' values and keys gathered, k values and keys written a block).
//
// Design: one block of 256 threads per (row, block), a selection whose
// cost does not grow with k (the TPU kernel's k sweeps each end in a block
// reduction, two barriers apiece):
//  1. The block is staged in shared memory as order-preserving uint32 keys
//     (16-byte loads where the row allows): bits ^ 0x80000000 for x >= 0,
//     ~bits for x < 0, with -0.0 folded onto +0.0 so the two tie, and
//     -inf, masked elements and pads at 0, below every other key.  Bit
//     patterns are compared, never flushed values (the build has no
//     -ftz), so subnormals order exactly.
//  2. A radix select finds the k-th largest key T: 8-bit digits from the
//     top, a 256-bin shared-memory histogram per pass (warp-aggregated
//     atomics), a suffix scan of the bins picks the digit; it stops early
//     once every key of the bucket is needed.  At most four passes over
//     shared memory, whatever k is.
//  3. Compaction in index order (per-warp ballots over contiguous warp
//     segments, a scan of the warp counts): every key above T, and the
//     lowest-index keys equal to T until there are k.
//  4. A bitonic sort of the k candidates in shared memory by (key desc,
//     index asc), one 64-bit word each.
//  5. Only the winners' values and keys are read from global memory; a
//     candidate at key 0 emits (-inf, key of element 0).
// k = 1 is one pass: a block-wide maximum of (key, ~index).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving key of a float's bits; 0 for -inf.
__device__ __forceinline__ uint32_t order_key(uint32_t u) {
  if (u == 0x80000000u) u = 0u;  // -0.0 ties +0.0
  if (u == 0xff800000u) return 0u;  // -inf
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t elem_key(const float* v,
                                             const uint8_t* mk, int i) {
  if (mk != nullptr && !mk[i]) return 0u;
  return order_key(__float_as_uint(v[i]));
}

__device__ __forceinline__ unsigned long long warp_max64(
    unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// Stage keys [0, block) of one block: elements at or past len are pads.
__device__ void stage_keys(uint32_t* sk, const float* v, const uint8_t* mk,
                           int len, int block) {
  const int tid = threadIdx.x;
  int head = (int)(((16u - ((uintptr_t)v & 15u)) & 15u) >> 2);
  if (head > len) head = len;
  const bool vec = mk == nullptr || (((uintptr_t)(mk + head)) & 3u) == 0;
  const int body = vec ? (len - head) & ~3 : 0;
  for (int i = tid; i < block; i += kThreads) {
    if (i >= head && i < head + body) continue;
    sk[i] = i < len ? elem_key(v, mk, i) : 0u;
  }
  const float4* v4 = reinterpret_cast<const float4*>(v + head);
  const uchar4* m4 =
      mk != nullptr ? reinterpret_cast<const uchar4*>(mk + head) : nullptr;
  for (int j = tid; j < body / 4; j += kThreads) {
    const float4 x = __ldg(v4 + j);
    uchar4 m = make_uchar4(1, 1, 1, 1);
    if (m4 != nullptr) m = m4[j];
    uint32_t* d = sk + head + 4 * j;
    d[0] = m.x ? order_key(__float_as_uint(x.x)) : 0u;
    d[1] = m.y ? order_key(__float_as_uint(x.y)) : 0u;
    d[2] = m.z ? order_key(__float_as_uint(x.z)) : 0u;
    d[3] = m.w ? order_key(__float_as_uint(x.w)) : 0u;
  }
}

__device__ __forceinline__ void emit(unsigned long long c, const float* v,
                                     const int* keys, float* out_v,
                                     int* out_k) {
  const uint32_t key = (uint32_t)(c >> 32);
  const uint32_t idx = ~(uint32_t)c;
  if (key == 0u) {  // -inf: a sweep over an all -inf block takes element 0
    *out_v = -INFINITY;
    *out_k = keys[0];
  } else {
    *out_v = v[idx];
    *out_k = keys[idx];
  }
}

__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const float* __restrict__ values,
                  const int* __restrict__ keys,
                  const uint8_t* __restrict__ mask, float* __restrict__ out_v,
                  int* __restrict__ out_k, long long n, int block,
                  long long nblocks, int k, int P) {
  extern __shared__ unsigned long long cand[];  // (P,) then the keys
  __shared__ uint32_t hist[256];
  __shared__ uint32_t wsum[kWarps];
  __shared__ uint32_t wgt[kWarps], weq[kWarps];
  __shared__ unsigned long long wbest[kWarps];
  __shared__ uint32_t sel_digit, sel_rank, sel_count;

  const long long row = blockIdx.x / nblocks;
  const long long b = blockIdx.x % nblocks;
  const long long start = b * block;
  const long long left = n - start;
  const int len = left < block ? (int)left : block;
  const long long base = row * n + start;
  const float* v = values + base;
  const int* kb = keys + base;
  const uint8_t* mk = mask != nullptr ? mask + base : nullptr;
  const long long out0 = (row * nblocks + b) * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (k == 1) {  // one pass: the largest (key, ~index)
    unsigned long long best = 0;
    for (int i = tid; i < len; i += kThreads) {
      const unsigned long long c =
          ((unsigned long long)elem_key(v, mk, i) << 32) | (uint32_t)~i;
      best = c > best ? c : best;
    }
    best = warp_max64(best);
    if (lane == 0) wbest[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < kWarps ? wbest[lane] : 0ull;
      best = warp_max64(best);
      if (lane == 0) emit(best, v, kb, out_v + out0, out_k + out0);
    }
    return;
  }

  uint32_t* sk = reinterpret_cast<uint32_t*>(cand + P);
  stage_keys(sk, v, mk, len, block);
  for (int j = k + tid; j < P; j += kThreads) cand[j] = 0ull;

  // -- radix select of the k-th largest key ----------------------------------
  uint32_t prefix = 0, rank = (uint32_t)k;
  int shift = 24;
  for (;; shift -= 8) {
    hist[tid] = 0u;
    __syncthreads();
    for (int i0 = 0; i0 < block; i0 += kThreads) {
      const int i = i0 + tid;
      uint32_t digit = 256u;
      if (i < block) {
        const uint32_t key = sk[i];
        if (shift == 24 || (key >> (shift + 8)) == prefix)
          digit = (key >> shift) & 255u;
      }
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit < 256u && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], (uint32_t)__popc(peers));
    }
    __syncthreads();
    // thread t holds bin 255 - t: an inclusive scan counts the keys of the
    // prefix at or above that digit
    const uint32_t c = hist[255 - tid];
    uint32_t incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += wsum[w];
    const uint32_t excl = incl - c;
    if (excl < rank && rank <= incl) {
      sel_digit = 255u - (uint32_t)tid;
      sel_rank = rank - excl;
      sel_count = c;
    }
    __syncthreads();
    prefix = (prefix << 8) | sel_digit;
    rank = sel_rank;
    if (sel_count == rank || shift == 0) break;
  }
  // selected: (key >> shift) > prefix, or == prefix among the first `rank`

  // -- compaction in index order ---------------------------------------------
  const int seg = (block + kWarps * 32 - 1) / (kWarps * 32) * 32;
  const int s0 = warp * seg < block ? warp * seg : block;
  const int s1 = s0 + seg < block ? s0 + seg : block;
  uint32_t ngt = 0, neq = 0;
  for (int i0 = s0; i0 < s1; i0 += 32) {
    const int i = i0 + lane;
    const uint32_t top = i < s1 ? sk[i] >> shift : 0u;
    ngt += __popc(__ballot_sync(kFull, i < s1 && top > prefix));
    neq += __popc(__ballot_sync(kFull, i < s1 && top == prefix));
  }
  if (lane == 0) {
    wgt[warp] = ngt;
    weq[warp] = neq;
  }
  __syncthreads();
  uint32_t gt_before = 0, eq_before = 0;
  for (int w = 0; w < warp; ++w) {
    gt_before += wgt[w];
    eq_before += weq[w];
  }
  const unsigned lt = (1u << lane) - 1u;
  for (int i0 = s0; i0 < s1; i0 += 32) {
    const int i = i0 + lane;
    const uint32_t key = i < s1 ? sk[i] : 0u;
    const uint32_t top = key >> shift;
    const bool gt = i < s1 && top > prefix;
    const bool eq = i < s1 && top == prefix;
    const unsigned bg = __ballot_sync(kFull, gt);
    const unsigned be = __ballot_sync(kFull, eq);
    const uint32_t gb = gt_before + __popc(bg & lt);
    const uint32_t eb = eq_before + __popc(be & lt);
    if (gt || (eq && eb < rank))
      cand[gb + (eb < rank ? eb : rank)] =
          ((unsigned long long)key << 32) | (uint32_t)~i;
    gt_before += __popc(bg);
    eq_before += __popc(be);
  }
  __syncthreads();

  // -- bitonic sort, descending ------------------------------------------------
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = cand[i], c2 = cand[j];
        if (((i & size) == 0) == (a < c2)) {
          cand[i] = c2;
          cand[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < k; j += kThreads)
    emit(cand[j], v, kb, out_v + out0 + j, out_k + out0 + j);
}

}  // namespace

// values: (rows, n) f32; keys: (rows, n) int32; mask: (rows, n) uint8 or
// null; out_v, out_k: (rows, nblocks, k).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int repro_block_topk(const void* values, const void* keys,
                                const void* mask, void* out_v, void* out_k,
                                long long rows, long long n, int block, int k,
                                void* stream) {
  const long long nblocks = (n + block - 1) / block;
  if (rows == 0 || nblocks == 0 || k == 0) return 0;
  int P = 1;
  while (P < k) P <<= 1;
  const size_t smem =
      k == 1 ? 0 : (size_t)P * sizeof(unsigned long long) +
                       (size_t)block * sizeof(uint32_t);
  // the static shared memory (about 1.2 KB) counts against the default
  // 48 KB
  if (smem > 46 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  block_topk_kernel<<<(unsigned)(rows * nblocks), kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const float*)values, (const int*)keys, (const uint8_t*)mask,
      (float*)out_v, (int*)out_k, n, block, nblocks, k, P);
  return (int)cudaGetLastError();
}
