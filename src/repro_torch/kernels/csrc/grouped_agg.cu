// Fused filter + grouped aggregation (B2), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/grouped_agg.py:filtered_group_sum
// (body _kernel): out[p, g, c] = sum over rows n of node p with
// pred[p, n] <= cutoff and groups[p, n] == g of measures[p, n, c].
// G <= 512 groups, C <= 64 measures, f32 accumulation.
//
// Bound on this card: bytes.  At Q1's G = 6, C = 6 each row moves 32 B
// (six f32 measures, the group id, the predicate) for six adds, far below
// the rate at which the card can add; the one-hot contraction the TPU
// kernel runs on its matrix unit would only multiply by zeros here.
//
// Design: deterministic two-pass reduction, no atomics, so the same
// inputs give bit-identical sums from run to run.
//  1. fgs_partial: grid (row chunks, nodes).  A block of slabs * C threads
//     owns one chunk of rows.  Thread (s, c) walks rows s, s + slabs, ...
//     of the chunk in order and adds measure c into ITS OWN slab s of a
//     shared (slabs, G, C) accumulator: no two threads ever update one
//     cell, so the order of every sum is fixed.  A chunk is
//     slabs * kRowsPerThread rows, so no f32 accumulator sums more than
//     kRowsPerThread rows (a single accumulator over millions of rows
//     drifts by ~1e-4 relative).  The block then sums its slabs in slab
//     order into partial[node, block, G, C].
//  2. fgs_reduce: one block per (node, cell) sums the block partials with a
//     fixed strided split and a fixed shared-memory tree.
// The shared accumulator is slabs * G * C * 4 bytes; above the default
// 48 KB (G * C > 12288, e.g. 512 x 64 = 128 KB) the launch opts in to
// dynamic shared memory with cudaFuncSetAttribute.
#include <cuda_runtime.h>

namespace {

constexpr int kReduceThreads = 256;

__global__ void fgs_partial(const float* __restrict__ measures,
                            const int* __restrict__ groups,
                            const int* __restrict__ pred,
                            float* __restrict__ partial, long long n, int C,
                            int G, int cutoff, int slabs, long long chunk) {
  extern __shared__ float acc[];  // (slabs, G, C)
  const int GC = G * C;
  for (int i = threadIdx.x; i < slabs * GC; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const long long node = blockIdx.y;
  const long long block = blockIdx.x;
  const int s = threadIdx.x / C;
  const int c = threadIdx.x % C;
  if (s < slabs) {
    const long long r0 = block * chunk;
    const long long r1 = r0 + chunk < n ? r0 + chunk : n;
    const float* m = measures + node * n * C;
    const int* gp = groups + node * n;
    const int* pp = pred + node * n;
    float* mine = acc + s * GC + c;
    for (long long r = r0 + s; r < r1; r += slabs) {
      const int g = __ldg(gp + r);
      if (__ldg(pp + r) <= cutoff && g >= 0 && g < G)
        mine[g * C] += __ldg(m + r * C + c);
    }
  }
  __syncthreads();

  float* dst = partial + (node * gridDim.x + block) * GC;
  for (int i = threadIdx.x; i < GC; i += blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < slabs; ++k) sum += acc[k * GC + i];
    dst[i] = sum;
  }
}

__global__ void fgs_reduce(const float* __restrict__ partial,
                           float* __restrict__ out, int nblocks, int GC) {
  __shared__ float buf[kReduceThreads];
  const long long node = blockIdx.y;
  const int cell = blockIdx.x;
  const float* src = partial + node * nblocks * GC + cell;
  float sum = 0.f;
  for (int k = threadIdx.x; k < nblocks; k += kReduceThreads)
    sum += src[(long long)k * GC];
  buf[threadIdx.x] = sum;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[node * GC + cell] = buf[0];
}

}  // namespace

// measures: (nodes, n, C) f32; groups, pred: (nodes, n) int32;
// partial: (nodes, nblocks, G, C) f32 scratch; out: (nodes, G, C) f32.
// nblocks = ceil(n / chunk), chunk = slabs * rows per thread, all chosen
// by the Python wrapper.  Returns the first failing cudaError_t, else 0.
extern "C" int repro_filtered_group_sum(const void* measures,
                                        const void* groups, const void* pred,
                                        void* partial, void* out, int nodes,
                                        long long n, int C, int G,
                                        int cutoff, int slabs,
                                        long long chunk, int nblocks,
                                        void* stream) {
  if (nodes == 0 || n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)slabs * G * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fgs_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fgs_partial<<<dim3((unsigned)nblocks, (unsigned)nodes), slabs * C, smem,
                st>>>((const float*)measures, (const int*)groups,
                      (const int*)pred, (float*)partial, n, C, G, cutoff,
                      slabs, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fgs_reduce<<<dim3((unsigned)(G * C), (unsigned)nodes), kReduceThreads, 0,
               st>>>((const float*)partial, (float*)out, nblocks, G * C);
  return (int)cudaGetLastError();
}
