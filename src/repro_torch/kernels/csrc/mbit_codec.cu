// m-bit partial-sum encoder (B6), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/mbit_codec.py:encode (body
// _kernel): the §3.2.5 encoder.  Per group of `group` consecutive values
// of a row, shift = max(0, bits(max) - m) and code = q >> shift; the codes
// are packed LSB first at m bits (m divides 32, so no code straddles a
// word), each row from bit 0 into ceil(K m / 32) words.  `group` only has
// to divide K: it may be smaller than 32 / m, so one word may hold codes
// of several groups, and a row may end in a half-filled word (the layout
// of the §3.2.5 plan's per-destination pack_bits).
//
// Bound on this card: bytes, 4 B read per value, m / 8 B written per code
// and 4 B per group shift.
//
// Design: two launches.  mbit_shifts computes each group's shift: a warp
// per group (lanes stride over it, __reduce_max_sync) when the group holds
// 32 or more values, else a thread per group.  mbit_pack then writes one
// word per thread: its 32 / m codes are consecutive values, shifted by
// their own group's shift.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t shift_of(uint32_t gmax, int m) {
  const int bits = 32 - __clz(gmax);  // __clz(0) == 32
  return bits > m ? (uint32_t)(bits - m) : 0u;
}

__global__ void mbit_shifts(const uint32_t* __restrict__ q,
                            uint32_t* __restrict__ shifts, long long ngroups,
                            int group, int m, int lanes) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long g = t / lanes;  // lanes == 32: uniform across the warp
  if (g >= ngroups) return;
  const uint32_t* v = q + g * group;
  uint32_t mx = 0;
  if (lanes == 1) {
    for (int i = 0; i < group; ++i) mx = max(mx, __ldg(v + i));
    shifts[g] = shift_of(mx, m);
    return;
  }
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < group; i += 32) mx = max(mx, __ldg(v + i));
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) shifts[g] = shift_of(mx, m);
}

__global__ void mbit_pack(const uint32_t* __restrict__ q,
                          const uint32_t* __restrict__ shifts,
                          uint32_t* __restrict__ words, long long rows,
                          long long K, long long W, int group, int m) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * W) return;
  const long long row = t / W;
  const long long w = t % W;
  const int per = 32 / m;
  const uint32_t code_mask = m == 32 ? 0xffffffffu : (1u << m) - 1u;
  const uint32_t* v = q + row * K;
  const uint32_t* s = shifts + row * (K / group);
  uint32_t word = 0;
  const long long c0 = w * per;
  for (int j = 0; j < per && c0 + j < K; ++j) {
    const long long c = c0 + j;
    const uint32_t code = (__ldg(v + c) >> __ldg(s + c / group)) & code_mask;
    word |= code << (m * j);
  }
  words[t] = word;
}

}  // namespace

// q: (rows, K) uint32 (values < 2**31); words: (rows, ceil(K m / 32));
// shifts: (rows, K / group).  Returns the cudaError_t of the first failed
// launch (0 on success).
extern "C" int repro_mbit_encode(const void* q, void* words, void* shifts,
                                 long long rows, long long K, int m,
                                 int group, void* stream) {
  if (rows == 0 || K == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long ngroups = rows * (K / group);
  const int lanes = group >= 32 ? 32 : 1;
  const long long t1 = ngroups * lanes;
  mbit_shifts<<<(unsigned)((t1 + kThreads - 1) / kThreads), kThreads, 0,
                st>>>((const uint32_t*)q, (uint32_t*)shifts, ngroups, group,
                      m, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long W = (K * m + 31) / 32;
  const long long t2 = rows * W;
  mbit_pack<<<(unsigned)((t2 + kThreads - 1) / kThreads), kThreads, 0,
              st>>>((const uint32_t*)q, (const uint32_t*)shifts,
                    (uint32_t*)words, rows, K, W, group, m);
  return (int)cudaGetLastError();
}
