// Per-block top-k (B4), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/topk_select.py:block_topk (body
// _kernel): step 1 of the paper's §3.2.3 scheme.  Each row of values is
// cut into blocks of `block` elements (the last one padded with -inf and
// key INT32_MAX); per block, k masked-argmax sweeps each emit the block's
// maximum and its key and set that element to -inf.  Masked elements are
// -inf.  Ties take the lowest index, as jnp.argmax does, so a block that
// runs out of finite elements repeats the key of its element 0.
//
// Bound on this card: bytes for small k (each value, key and mask byte
// read once, k values and keys written per block); the k sweeps are
// k * block compare-selects per block, operations for large k.
//
// Design: one block of 256 threads per (row, block), the values staged in
// shared memory (block * 4 bytes, 16 KB at the default 4,096).  Thread t
// owns elements t, t + 256, ... and keeps the best (value desc, index asc)
// of them in registers.  A sweep reduces the 256 candidates (warp
// shuffles, then one warp over the 8 warp winners), writes the winner, and
// only the thread that owns the winner sets it to -inf and rescans its
// elements: after the first sweep a sweep costs one reduction, not a pass
// over the block.  Keys are read from global memory for the k winners only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, o);
    const int oi = __shfl_down_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void block_topk_kernel(const float* __restrict__ values,
                                  const int* __restrict__ keys,
                                  const uint8_t* __restrict__ mask,
                                  float* __restrict__ out_v,
                                  int* __restrict__ out_k, long long n,
                                  int block, long long nblocks, int k) {
  extern __shared__ float sv[];  // (block,)
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int win;
  const long long row = blockIdx.x / nblocks;
  const long long b = blockIdx.x % nblocks;
  const long long start = b * block;
  const long long left = n - start;
  const int len = left < block ? (int)left : block;
  const float* v = values + row * n + start;
  const uint8_t* mk = mask ? mask + row * n + start : nullptr;
  const int tid = threadIdx.x;
  for (int i = tid; i < block; i += kThreads) {
    float x = -INFINITY;
    if (i < len && (!mk || mk[i])) x = v[i];
    sv[i] = x;
  }
  // each thread's own elements are only read and written by itself: the
  // scan needs no barrier before it
  float bv = -INFINITY;
  int bi = block;
  for (int i = tid; i < block; i += kThreads)
    if (better(sv[i], i, bv, bi)) {
      bv = sv[i];
      bi = i;
    }
  const int lane = tid & 31, warp = tid >> 5;
  const long long out0 = (row * nblocks + b) * k;
  for (int j = 0; j < k; ++j) {
    float rv = bv;
    int ri = bi;
    warp_best(rv, ri);
    if (lane == 0) {
      wv[warp] = rv;
      wi[warp] = ri;
    }
    __syncthreads();
    if (warp == 0) {
      rv = lane < kWarps ? wv[lane] : -INFINITY;
      ri = lane < kWarps ? wi[lane] : block;
      warp_best(rv, ri);
      if (lane == 0) {
        win = ri;
        out_v[out0 + j] = rv;
        out_k[out0 + j] = ri < len ? keys[row * n + start + ri] : INT32_MAX;
      }
    }
    __syncthreads();
    const int w = win;
    if (w % kThreads == tid) {  // the owner retires the winner, rescans
      sv[w] = -INFINITY;
      bv = -INFINITY;
      bi = block;
      for (int i = tid; i < block; i += kThreads)
        if (better(sv[i], i, bv, bi)) {
          bv = sv[i];
          bi = i;
        }
    }
  }
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
  const size_t smem = (size_t)block * sizeof(float);
  // the static shared memory (80 bytes) counts against the default 48 KB
  if (smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  block_topk_kernel<<<(unsigned)(rows * nblocks), kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const float*)values, (const int*)keys, (const uint8_t*)mask,
      (float*)out_v, (int*)out_k, n, block, nblocks, k);
  return (int)cudaGetLastError();
}
