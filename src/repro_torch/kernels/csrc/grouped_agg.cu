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
// inputs give bit-identical sums from run to run.  The first pass has two
// variants; the wrapper picks one by (G, C) alone
// (grouped_agg.uses_registers).
//  1a. fgs_registers, for C <= 8 and G * C <= 64 (Q1: 6 x 6): each thread
//     keeps its (G, C) sums in registers.  A thread takes four consecutive
//     rows at a time: one 16-byte load of their groups, one of their
//     predicates, and C 16-byte loads of their 4 C measures (the wrapper
//     takes the scalar variant, kVec = false, where N % 4 != 0 or a
//     pointer is not 16-byte aligned).  A register array indexed by a
//     dynamic group spills to local memory, so each row adds into the
//     sums by an unrolled compare over g (C is a template argument, the
//     groups at most 64 / C).  A chunk of 32,768 rows gives each thread 32
//     quads strided across the block, so a warp's loads are contiguous and
//     no accumulator sums more than 128 rows.  The block then sums its
//     threads in a fixed tree (warp shuffles, then the 8 warps in order in
//     shared memory) into partial[node, chunk, G, C].  Blocks resident on
//     the whole card walk the (node, chunk) pairs.
//  1b. fgs_partial, for the rest: grid (row chunks, nodes).  A block of
//     slabs * C threads owns one chunk of rows.  Thread (s, c) walks rows
//     s, s + slabs, ... of the chunk in order and adds measure c into ITS
//     OWN slab s of a shared (slabs, G, C) accumulator: no two threads
//     ever update one cell, so the order of every sum is fixed.  A chunk is
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
constexpr int kRegThreads = 256;
constexpr int kRegQuads = 32;       // quads of rows a thread takes a chunk
constexpr long long kRegChunk = 4LL * kRegQuads * kRegThreads;
constexpr int kRegCells = 64;       // G * C of the register variant, at most
constexpr unsigned kFull = 0xffffffffu;

template <int C, bool kVec>
__global__ void __launch_bounds__(kRegThreads, 2)
fgs_registers(const float* __restrict__ measures,
              const int* __restrict__ groups, const int* __restrict__ pred,
              float* __restrict__ partial, long long n, int G, int cutoff,
              long long nchunks, long long nodes) {
  constexpr int kG = kRegCells / C;  // groups the registers can hold
  __shared__ float red[kRegThreads / 32][kG * C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long it = blockIdx.x; it < nodes * nchunks; it += gridDim.x) {
    const long long node = it / nchunks;
    const long long chunk = it - node * nchunks;
    const float* m = measures + node * n * C;
    const int* gp = groups + node * n;
    const int* pp = pred + node * n;
    float acc[kG][C];
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] = 0.f;

    for (long long r = chunk * kRegChunk + 4 * threadIdx.x,
                   r_end = r + kRegChunk;
         r < r_end && r < n; r += 4 * kRegThreads) {
      int g4[4], p4[4];
      float mv[4 * C];  // the quad's measures, row-major
      if (kVec) {  // N % 4 == 0: the whole quad exists, 16-byte aligned
        const int4 gv = __ldg(reinterpret_cast<const int4*>(gp + r));
        const int4 pv = __ldg(reinterpret_cast<const int4*>(pp + r));
        g4[0] = gv.x; g4[1] = gv.y; g4[2] = gv.z; g4[3] = gv.w;
        p4[0] = pv.x; p4[1] = pv.y; p4[2] = pv.z; p4[3] = pv.w;
        const float4* mq = reinterpret_cast<const float4*>(m + r * C);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const float4 v = __ldg(mq + q);
          mv[4 * q] = v.x; mv[4 * q + 1] = v.y;
          mv[4 * q + 2] = v.z; mv[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool in = r + i < n;
          g4[i] = in ? __ldg(gp + r + i) : -1;
          p4[i] = in ? __ldg(pp + r + i) : 0;
#pragma unroll
          for (int c = 0; c < C; ++c)
            mv[i * C + c] = in ? __ldg(m + (r + i) * C + c) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = p4[i] <= cutoff && g4[i] >= 0 && g4[i] < G ? g4[i] : -1;
#pragma unroll
        for (int gg = 0; gg < kG; ++gg) {
          if (gg >= G) break;  // uniform
          if (g == gg) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[gg][c] += mv[i * C + c];
          }
        }
      }
    }

    // the block's sums in a fixed order: a butterfly in each warp, then
    // the warps in order
#pragma unroll
    for (int gg = 0; gg < kG; ++gg) {
      if (gg >= G) break;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v = acc[gg][c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        if (lane == 0) red[warp][gg * C + c] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < G * C) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kRegThreads / 32; ++w) sum += red[w][threadIdx.x];
      partial[it * G * C + threadIdx.x] = sum;
    }
    __syncthreads();  // red is rewritten by the next chunk
  }
}

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

namespace {

template <int C, bool kVec>
cudaError_t launch_registers(const float* measures, const int* groups,
                             const int* pred, float* partial, long long n,
                             int G, int cutoff, long long nchunks,
                             long long nodes, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fgs_registers<C, kVec>, kRegThreads, 0);
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long work = nodes * nchunks;
  fgs_registers<C, kVec>
      <<<(unsigned)(work < resident ? work : resident), kRegThreads, 0, st>>>(
          measures, groups, pred, partial, n, G, cutoff, nchunks, nodes);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t dispatch_registers(int C, const float* measures,
                               const int* groups, const int* pred,
                               float* partial, long long n, int G, int cutoff,
                               long long nchunks, long long nodes,
                               cudaStream_t st) {
  switch (C) {
#define REPRO_FGS_CASE(c)                                                  \
  case c:                                                                  \
    return launch_registers<c, kVec>(measures, groups, pred, partial, n, G, \
                                     cutoff, nchunks, nodes, st);
    REPRO_FGS_CASE(1) REPRO_FGS_CASE(2) REPRO_FGS_CASE(3) REPRO_FGS_CASE(4)
    REPRO_FGS_CASE(5) REPRO_FGS_CASE(6) REPRO_FGS_CASE(7) REPRO_FGS_CASE(8)
#undef REPRO_FGS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The register variant (C <= 8, G * C <= 64): partial is (nodes, nchunks,
// G, C) f32 scratch, nchunks = ceil(n / 32,768); vec selects the 16-byte
// loads (n % 4 == 0, every pointer 16-byte aligned).  Arguments and result
// otherwise as repro_filtered_group_sum's.
extern "C" int repro_filtered_group_sum_registers(
    const void* measures, const void* groups, const void* pred, void* partial,
    void* out, int nodes, long long n, int C, int G, int cutoff,
    long long nchunks, int vec, void* stream) {
  if (nodes == 0 || n == 0) return 0;
  if (C > 8 || G * C > kRegCells) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* m = (const float*)measures;
  const auto* g = (const int*)groups;
  const auto* p = (const int*)pred;
  auto* part = (float*)partial;
  cudaError_t err =
      vec ? dispatch_registers<true>(C, m, g, p, part, n, G, cutoff, nchunks,
                                     nodes, st)
          : dispatch_registers<false>(C, m, g, p, part, n, G, cutoff,
                                      nchunks, nodes, st);
  if (err != cudaSuccess) return (int)err;
  fgs_reduce<<<dim3((unsigned)(G * C), (unsigned)nodes), kReduceThreads, 0,
               st>>>(part, (float*)out, (int)nchunks, G * C);
  return (int)cudaGetLastError();
}

// The shared-slab variant.
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
