// m-bit partial-sum encoder (B6), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/mbit_codec.py:encode (body
// _kernel): the §3.2.5 encoder.  Per group of `group` consecutive values
// of a row, shift = max(0, bits(max) - m) and code = q >> shift; the codes
// are packed LSB first at m bits (m divides 32, so no code straddles a
// word), each row from bit 0 into ceil(K m / 32) words.  `group` only has
// to divide K: it may be smaller than 32 / m, so one word may hold codes
// of several groups, and a row may end in a half-filled word whose upper
// bits are 0 (the layout of the §3.2.5 plan's per-destination pack_bits).
//
// Bound on this card: bytes, 4 B read per value, m / 8 B written per code
// and 4 B per group shift.
//
// Design: one launch.  A row is cut into segments of L = lcm(group, 32/m)
// values (the last one ends at the row's end), each of whole groups and
// starting on a word boundary, so one unit of work computes its groups'
// maxima, writes their shifts and packs its words, and each word and
// shift has one writer.  Where L <= 16 (the §3.2.5 plan's groups of 2
// and 4) the unit is a thread: its values stay in registers (one 16-byte
// load where rows and segments lie on 16 bytes), m and L are template
// parameters, and every index is a constant of the unrolled loops.  Else
// the unit is a warp: for groups of 32 or more the lanes stride over a
// group and __reduce_max_sync takes its maximum, for smaller groups lane
// i scans group i (a segment holds at most 32 / gcd(group, 32/m) <= 32
// groups, so lane i keeps group i's shift); then each lane packs whole
// words, reading the segment's values again (L1), with the shift of a
// code's group from its lane by __shfl_sync.  No division runs per code.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kThreadValues = 16;    // the thread unit's largest segment

__device__ __forceinline__ uint32_t shift_of(uint32_t gmax, int m) {
  const int bits = 32 - __clz(gmax);  // __clz(0) == 32
  return bits > m ? (uint32_t)(bits - m) : 0u;
}

// One thread a segment of LEN <= 16 values (LEN = lcm(group, 32/M); a
// row's last segment may be shorter).  VEC: rows and segments lie on 16
// bytes (K and LEN multiples of 4, q on 16 bytes).
template <int M, int LEN, bool VEC>
__global__ void __launch_bounds__(kThreads)
mbit_thread(const uint32_t* __restrict__ q, uint32_t* __restrict__ words,
            uint32_t* __restrict__ shifts, long long units, long long nseg,
            long long K, long long W, int group) {
  constexpr int PER = 32 / M;                       // codes a word
  constexpr int NW = LEN / PER;                     // words a segment
  constexpr uint32_t MASK = M == 32 ? 0xffffffffu : (1u << M) - 1u;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= units) return;
  // 32-bit division where the count fits (one division a thread)
  const long long row = units <= 0xffffffffLL
                            ? (long long)((uint32_t)t / (uint32_t)nseg)
                            : t / nseg;
  const long long s = t - row * nseg;
  const long long c0 = s * LEN;
  const int len = (int)(K - c0 < LEN ? K - c0 : LEN);
  const uint32_t* v = q + row * K + c0;
  uint32_t x[LEN];
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < LEN / 4; ++i) {
      uint4 u = make_uint4(0, 0, 0, 0);
      if (4 * i < len) u = __ldg(reinterpret_cast<const uint4*>(v) + i);
      x[4 * i] = u.x;
      x[4 * i + 1] = u.y;
      x[4 * i + 2] = u.z;
      x[4 * i + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < LEN; ++i) x[i] = i < len ? __ldg(v + i) : 0u;
  }
  // forward: each group's maximum at its last value; its shift written
  uint32_t* sh = shifts + row * (K / group) + s * (LEN / group);
  uint32_t gm[LEN];
  uint32_t last = 0;                               // bit c: c ends a group
  uint32_t mx = 0;
  int cnt = 0, gi = 0;
#pragma unroll
  for (int c = 0; c < LEN; ++c) {
    gm[c] = 0;
    if (c < len) {
      mx = max(mx, x[c]);
      if (++cnt == group) {
        gm[c] = mx;
        last |= 1u << c;
        sh[gi++] = shift_of(mx, M);
        mx = 0;
        cnt = 0;
      }
    }
  }
  // backward: each code's shift from the end of its group; pack
  uint32_t wd[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) wd[w] = 0;
  uint32_t cur = 0;
#pragma unroll
  for (int c = LEN - 1; c >= 0; --c) {
    if (c < len) {
      if (last >> c & 1u) cur = shift_of(gm[c], M);
      wd[c / PER] |= ((x[c] >> cur) & MASK) << (M * (c % PER));
    }
  }
  uint32_t* out = words + row * W + c0 / PER;
  const int nw = (len * M + 31) / 32;
#pragma unroll
  for (int w = 0; w < NW; ++w)
    if (w < nw) out[w] = wd[w];
}

// One warp a segment (grid-stride over the segments of every row).
__global__ void __launch_bounds__(kThreads)
mbit_warp(const uint32_t* __restrict__ q, uint32_t* __restrict__ words,
          uint32_t* __restrict__ shifts, long long units, long long nseg,
          long long K, long long W, int L, int group, int m) {
  const int lane = threadIdx.x & 31;
  const int per = 32 / m;
  const uint32_t mask = m == 32 ? 0xffffffffu : (1u << m) - 1u;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long u = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       u < units; u += stride) {                   // uniform across the warp
    const long long row = u / nseg;
    const long long s = u - row * nseg;
    const long long c0 = s * L;
    const int len = (int)(K - c0 < L ? K - c0 : L);
    const int ng = len / group;                    // <= 32
    const uint32_t* v = q + row * K + c0;
    uint32_t my_shift = 0;                         // lane i: group i's
    if (group >= 32) {
      for (int g = 0; g < ng; ++g) {
        uint32_t mx = 0;
        const uint32_t* gv = v + (long long)g * group;
#pragma unroll 8
        for (int i = lane; i < group; i += 32) mx = max(mx, __ldg(gv + i));
        mx = __reduce_max_sync(0xffffffffu, mx);
        if (lane == g) my_shift = shift_of(mx, m);
      }
    } else if (lane < ng) {
      uint32_t mx = 0;
      const uint32_t* gv = v + lane * group;
      for (int i = 0; i < group; ++i) mx = max(mx, __ldg(gv + i));
      my_shift = shift_of(mx, m);
    }
    if (lane < ng)
      shifts[row * (K / group) + s * (L / group) + lane] = my_shift;
    const int nw = (len * m + 31) / 32;
    uint32_t* out = words + row * W + c0 / per;
    for (int w0 = 0; w0 < nw; w0 += 32) {          // uniform across the warp
      const int w = w0 + lane;
      const int cs = w * per;
      int gi = cs / group;                          // one division a word
      int next = (gi + 1) * group;
      uint32_t word = 0;
      for (int j = 0; j < per; ++j) {
        const int c = cs + j;
        if (c == next) {
          ++gi;
          next += group;
        }
        const uint32_t sh = __shfl_sync(0xffffffffu, my_shift, gi & 31);
        if (w < nw && c < len)
          word |= ((__ldg(v + c) >> sh) & mask) << (m * j);
      }
      if (w < nw) out[w] = word;
    }
  }
}

int warp_blocks() {
  // a persistent grid for mbit_warp: the blocks that fit the card at once
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mbit_warp,
                                                  kThreads, 0);
    blocks = (per_sm < 1 ? 1 : per_sm) * sms;
  }
  return blocks;
}

using ThreadKernel = void (*)(const uint32_t*, uint32_t*, uint32_t*,
                              long long, long long, long long, long long,
                              int);

// mbit_thread<M, LEN, VEC> for the segment L, LEN over the multiples of
// 32/M up to kThreadValues; null where L is none of them (or VEC and L is
// no multiple of 4)
template <int M, bool VEC, int LEN = 32 / M>
ThreadKernel thread_kernel(int L) {
  if constexpr (LEN > kThreadValues) {
    return nullptr;
  } else {
    if (L == LEN) {
      if constexpr (VEC && LEN % 4 != 0) {
        return nullptr;                  // 16-byte loads need LEN % 4 == 0
      } else {
        return mbit_thread<M, LEN, VEC>;
      }
    }
    return thread_kernel<M, VEC, LEN + 32 / M>(L);
  }
}

template <bool VEC>
ThreadKernel thread_kernel(int m, int L) {
  switch (m) {
    case 1: return thread_kernel<1, VEC>(L);
    case 2: return thread_kernel<2, VEC>(L);
    case 4: return thread_kernel<4, VEC>(L);
    case 8: return thread_kernel<8, VEC>(L);
    case 16: return thread_kernel<16, VEC>(L);
    case 32: return thread_kernel<32, VEC>(L);
    default: return nullptr;
  }
}

}  // namespace

// q: (rows, K) uint32 (values < 2**31); words: (rows, ceil(K m / 32));
// shifts: (rows, K / group).  L: the segment, lcm(group, 32 / m); unit: 0
// a warp a segment, 1 a thread (L <= 16), 2 a thread with 16-byte loads.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_mbit_encode(const void* q, void* words, void* shifts,
                                 long long rows, long long K, int m,
                                 int group, int L, int unit, void* stream) {
  if (rows == 0 || K == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long nseg = (K + L - 1) / L;
  const long long units = rows * nseg;
  const long long W = (K * m + 31) / 32;
  const uint32_t* qq = (const uint32_t*)q;
  uint32_t* ww = (uint32_t*)words;
  uint32_t* ss = (uint32_t*)shifts;
  if (unit == 0) {
    long long blocks = (units + kWarps - 1) / kWarps;
    if (blocks > warp_blocks()) blocks = warp_blocks();
    mbit_warp<<<(unsigned)blocks, kThreads, 0, st>>>(qq, ww, ss, units, nseg,
                                                     K, W, L, group, m);
    return (int)cudaGetLastError();
  }
  const ThreadKernel fn = unit == 2 ? thread_kernel<true>(m, L)
                                    : thread_kernel<false>(m, L);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  fn<<<(unsigned)((units + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      qq, ww, ss, units, nseg, K, W, group);
  return (int)cudaGetLastError();
}
