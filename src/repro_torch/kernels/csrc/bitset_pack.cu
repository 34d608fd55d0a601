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
// Design: one warp per 32 columns; lane j tests column 32 w + j and
// __ballot_sync assembles the word, so a warp reads 128 contiguous bytes
// and lane 0 writes one word.  The row is grid dimension y.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void predicate_bitset_kernel(const int* __restrict__ column,
                                        uint32_t* __restrict__ out,
                                        long long n, long long words,
                                        int value) {
  const long long w =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= words) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const long long row = blockIdx.y;
  const long long i = w * 32 + lane;
  const bool hit = i < n && __ldg(column + row * n + i) == value;
  const uint32_t bits = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) out[row * words + w] = bits;
}

}  // namespace

// column: (rows, n) int32; out: (rows, ceil(n / 32)) uint32.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_predicate_bitset(const void* column, void* out,
                                      int rows, long long n, int value,
                                      void* stream) {
  const long long words = (n + 31) / 32;
  if (rows == 0 || words == 0) return 0;
  const dim3 grid(
      (unsigned)((words + kWarpsPerBlock - 1) / kWarpsPerBlock),
      (unsigned)rows);
  predicate_bitset_kernel<<<grid, kWarpsPerBlock * 32, 0,
                            (cudaStream_t)stream>>>(
      (const int*)column, (uint32_t*)out, n, words, value);
  return (int)cudaGetLastError();
}
