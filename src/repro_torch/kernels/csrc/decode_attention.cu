// Single-token decode attention (B9), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:decode_attention
// (body _kernel).  Grouped layout: q (BKV, G, D) one token per sequence in
// f32 / bf16; caches (BKV, Smax, D) in f32 / bf16, or int8 codes with
// (BKV, Smax) f32 scales (k = code * k_scale).  `length` is a 0-d int32 on
// the device, read by the kernel as the TPU kernel reads it from SMEM, so
// a launch captured in a CUDA graph stays right when the length changes.
// out = softmax(q / sqrt(D) . k^T over positions < length) . v in f32,
// written in q's dtype.  The TPU kernel's guards: masked scores are
// NEG_INF = -FLT_MAX, p = 0 where s <= NEG_INF / 2, the correction is 0
// while m is NEG_INF, out = acc / max(l, 1e-30) (zeros at length 0);
// positions at or past `length` are never read.
//
// Bound on this card: bytes.  Each position moves 2 D bytes of int8 codes
// and 8 bytes of scales (4 D bytes of a bf16 cache) for 4 G D FLOP: at
// G = 8, D = 128, 16 FLOP a byte, below the 20 f32 FLOP a byte at which
// the CUDA cores (67 TFLOP/s), not the memory (3.35 TB/s), would limit.
//
// Design: one launch.  The grid is (8, BKV) blocks in clusters of 8
// along x (the portable cluster size): cluster b owns BKV row b, and its
// 8 blocks split the row's `length` positions evenly, each block
// computing its share on the device (the grid never depends on `length`).
// A block (one an SM: up to 200 KB of shared memory) has eight warps,
// which split its share again; each warp walks its positions in tiles of 32 (one position a
// lane), staged with 16-byte cp.async into a ring of `stages` tiles (K
// rows, V rows and the positions' two scales, rows padded against bank
// conflicts), so the next tiles' loads are in flight while one computes.
// All G query rows (up to 8 at a time) stay resident, so the cache is
// read once per kv head.  The scores of bf16 q against a bf16 or int8
// cache run on the tensor cores (mma.sync m16n8k16: q's 8 rows as A
// fragments held in registers, int8 codes widened exactly to bf16 as B);
// otherwise lane j scores position j against every row in f32, q in
// shared memory.  Dequantisation is in registers (the k scale multiplies
// the dot product once, the v scale folds into p), p v stays in f32 on
// the CUDA cores, and the warp keeps an online softmax (m, l, acc) in
// registers.  The warps' partials merge in
// warp order into a block partial in shared memory, and the cluster's
// block partials merge in rank order through distributed shared memory
// (each rank finishes a share of the outputs), so the result repeats bit
// for bit with no global scratch and no atomics.  A block with no
// positions contributes (NEG_INF, 0, 0) and still joins both cluster
// barriers.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;      // query rows resident at once
constexpr int kTile = 32;     // positions of a warp tile, one a lane
constexpr int kPw = kTile + 4;  // row stride of p in shared memory (banks)
constexpr int kCluster = 8;   // blocks a BKV row, the portable cluster
constexpr int kMaxWarps = 8;
constexpr int kSmemBudget = 200 * 1024;  // one block an SM
constexpr int kMaxStages = 3;
constexpr float kNegInf = -FLT_MAX;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;      // (BKV, Smax) or null
  const float* vs;
  const int* length;    // 0-d int32 on the device
  void* out;
  int G, Smax, D;
  int ld;               // shared-memory row stride, bytes
  int cp;               // cp.async bytes a copy: 16, 8 or 4
  int stages;
  int warp_bytes;       // shared memory of one warp: p, then the ring
  float scale;
};

// -- cp.async ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  // src-size 0 fills the destination with zeros and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(N), "r"(ok ? N : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

// -- loads and conversions -------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// int8 codes to f32 without the conversion unit: the offset byte
// (code + 128) goes into the mantissa of 2^23, and 2^23 + 128 comes off
// again, exactly
__device__ __forceinline__ float byte_f32(uint32_t offset_bytes, int sel) {
  return __uint_as_float(__byte_perm(offset_bytes, 0x4b000000u, sel)) -
         8388736.f;
}
__device__ __forceinline__ float4 load4(const signed char* p) {
  const uint32_t b = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  return make_float4(byte_f32(b, 0x7440), byte_f32(b, 0x7441),
                     byte_f32(b, 0x7442), byte_f32(b, 0x7443));
}

// 16 bytes of shared memory as f32: 4 f32, 8 bf16 or 16 int8
__device__ __forceinline__ void unpack16(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const signed char* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = w[i] ^ 0x80808080u;
    x[4 * i] = byte_f32(b, 0x7440);
    x[4 * i + 1] = byte_f32(b, 0x7441);
    x[4 * i + 2] = byte_f32(b, 0x7442);
    x[4 * i + 3] = byte_f32(b, 0x7443);
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// -- the tensor-core scores ------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// B fragment of one lane: the cache's d's 4t .. 4t + 3 of a 16 (int8
// codes are integers, exact in bf16)
__device__ __forceinline__ void load_b(const signed char* p, uint32_t& b0,
                                       uint32_t& b1) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  b0 = pack_bf16(byte_f32(w, 0x7440), byte_f32(w, 0x7441));
  b1 = pack_bf16(byte_f32(w, 0x7442), byte_f32(w, 0x7443));
}
__device__ __forceinline__ void load_b(const __nv_bfloat16* p, uint32_t& b0,
                                       uint32_t& b1) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  b0 = u.x;
  b1 = u.y;
}

// d += a b for one m16n8k16 tile: a's rows 8..15 are zero (8 query rows)
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, uint32_t a0, uint32_t a2,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// Issue the copies of one warp tile: positions [t0, t0 + n) of the K and V
// rows (and scales) into `st`; the rest of the tile is zero-filled.
template <typename TC, int CP>
__device__ __forceinline__ void issue_rows(unsigned char* st, const TC* kr,
                                           const TC* vr, int t0, int n,
                                           int row_bytes, int ld) {
  const int lane = threadIdx.x & 31;
  const int chunks = row_bytes / CP;
  const char* kb = reinterpret_cast<const char*>(kr);
  const char* vb = reinterpret_cast<const char*>(vr);
  for (int x = lane; x < kTile * chunks; x += 32) {
    const int r = x / chunks, c = x - r * chunks;
    const bool ok = r < n;
    const long long off = ok ? (long long)(t0 + r) * row_bytes + c * CP : 0;
    cp_async<CP>(st + r * ld + c * CP, kb + off, ok);
    cp_async<CP>(st + (kTile + r) * ld + c * CP, vb + off, ok);
  }
}

template <typename TC>
__device__ __forceinline__ void issue_tile(const Args& a, unsigned char* st,
                                           const TC* kr, const TC* vr,
                                           const float* ksr, const float* vsr,
                                           int t0, int n) {
  const int row_bytes = a.D * (int)sizeof(TC);
  switch (a.cp) {
    case 16: issue_rows<TC, 16>(st, kr, vr, t0, n, row_bytes, a.ld); break;
    case 8: issue_rows<TC, 8>(st, kr, vr, t0, n, row_bytes, a.ld); break;
    default: issue_rows<TC, 4>(st, kr, vr, t0, n, row_bytes, a.ld); break;
  }
  if (ksr != nullptr) {
    const int lane = threadIdx.x & 31;
    const bool ok = lane < n;
    float* sks = reinterpret_cast<float*>(st + 2 * kTile * a.ld);
    cp_async<4>(sks + lane, ksr + (ok ? t0 + lane : 0), ok);
    cp_async<4>(sks + kTile + lane, vsr + (ok ? t0 + lane : 0), ok);
  }
}

// NC: float4 chunks of a row a lane holds in acc (D <= 128 NC).  MMA:
// the scores on the tensor cores (bf16 q, a bf16 or int8 cache), else on
// the CUDA cores in f32.
template <typename TQ, typename TC, int NC, bool MMA>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long bkv = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int D = a.D, D4 = D >> 2, G = a.G;
  const bool quant = a.ks != nullptr;

  float* qs = reinterpret_cast<float*>(smem);  // kRows x D, scaled
  float* bpm = qs + kRows * D;                   // block partial: m, l, acc
  float* bpl = bpm + kRows;
  float* bpa = bpl + kRows;
  unsigned char* wbase = reinterpret_cast<unsigned char*>(bpa + kRows * D) +
                         (long long)warp * a.warp_bytes;
  float* pw = reinterpret_cast<float*>(wbase);   // kRows x kPw
  unsigned char* ring = wbase + kRows * kPw * sizeof(float);
  const int stage_bytes = 2 * kTile * a.ld + 2 * kTile * (int)sizeof(float);

  // this block's share of the positions, then this warp's
  const int length = min(max(*a.length, 0), a.Smax);
  const int per_block = (length + kCluster - 1) / kCluster;
  const int b0 = min(rank * per_block, length);
  const int b1 = min(b0 + per_block, length);
  const int per_warp = (b1 - b0 + nwarps - 1) / nwarps;
  const int w0 = min(b0 + warp * per_warp, b1);
  const int w1 = min(w0 + per_warp, b1);
  const int ntiles = (w1 - w0 + kTile - 1) / kTile;

  const TC* kr = reinterpret_cast<const TC*>(a.k) + bkv * a.Smax * D;
  const TC* vr = reinterpret_cast<const TC*>(a.v) + bkv * a.Smax * D;
  const float* ksr = quant ? a.ks + bkv * a.Smax : nullptr;
  const float* vsr = quant ? a.vs + bkv * a.Smax : nullptr;
  const TQ* q = reinterpret_cast<const TQ*>(a.q);
  TQ* out = reinterpret_cast<TQ*>(a.out);

  for (int r0 = 0; r0 < G; r0 += kRows) {
    const int rows = min(kRows, G - r0);
    __syncthreads();  // the previous rows' readers of shared memory are done
    if (MMA && D % 16) {
      // the mma steps read each row to a multiple of 16 elements: zeros
      // past D, where the copies never write
      const int row_bytes = D * (int)sizeof(TC);
      const int pad = (a.ld - row_bytes) / 4;
      for (int x = lane; x < a.stages * 2 * kTile * pad; x += 32) {
        const int r = x / pad;
        reinterpret_cast<uint32_t*>(
            ring + (r / (2 * kTile)) * stage_bytes + (r % (2 * kTile)) * a.ld +
            row_bytes)[x - r * pad] = 0u;
      }
      __syncwarp();
    }
    // the first tiles' loads go out before q is read
    for (int j = 0; j < a.stages - 1; ++j) {
      if (j < ntiles)
        issue_tile(a, ring + j * stage_bytes, kr, vr, ksr, vsr,
                   w0 + j * kTile, min(kTile, w1 - w0 - j * kTile));
      cp_commit();
    }
    // q: scaled f32 rows in shared memory (CUDA cores), or raw bf16 pairs
    // in registers as mma A fragments, k permuted so that lane t's k
    // indices 2t, 2t + 1, 2t + 8, 2t + 9 are the d's 4t .. 4t + 3 of each
    // 16 (the same for B, so the sums are the same)
    uint32_t qa[MMA ? 8 * NC : 1][2];
    if constexpr (MMA) {
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int kk = 0; kk < 8 * NC; ++kk) {
        uint2 u = make_uint2(0u, 0u);
        if (g < rows && 16 * kk + 4 * t < D)
          u = *reinterpret_cast<const uint2*>(q + (bkv * G + r0 + g) * D +
                                              16 * kk + 4 * t);
        qa[kk][0] = u.x;
        qa[kk][1] = u.y;
      }
    } else {
      for (int i = tid; i < kRows * D4; i += nthreads) {
        const int r = i / D4, c = i - r * D4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows) {
          x = load4(q + (bkv * G + r0 + r) * D + 4 * c);
          x.x *= a.scale; x.y *= a.scale; x.z *= a.scale; x.w *= a.scale;
        }
        *reinterpret_cast<float4*>(qs + r * D + 4 * c) = x;
      }
      __syncthreads();
    }

    // online softmax: the mma path keeps lane's row (lane >> 2), the
    // CUDA-core path every row, in each lane
    float m[MMA ? 1 : kRows], l[MMA ? 1 : kRows], acc[kRows][4 * NC];
#pragma unroll
    for (int i = 0; i < (MMA ? 1 : kRows); ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
    for (int it = 0; it < ntiles; ++it) {
      const int nx = it + a.stages - 1;
      if (nx < ntiles)
        issue_tile(a, ring + (nx % a.stages) * stage_bytes, kr, vr, ksr, vsr,
                   w0 + nx * kTile, min(kTile, w1 - w0 - nx * kTile));
      cp_commit();
      cp_wait(a.stages - 1);
      __syncwarp();
      const unsigned char* st = ring + (it % a.stages) * stage_bytes;
      const int n = min(kTile, w1 - w0 - it * kTile);
      const float* sc = reinterpret_cast<const float*>(st + 2 * kTile * a.ld);
      float corr[kRows];

      if constexpr (MMA) {
        // scores on the tensor cores: 8 query rows (of 16) x 8 positions
        // an mma, four position tiles, D / 16 steps
        const int g = lane >> 2, t = lane & 3;
        float s[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
          const unsigned char* row = st + (8 * j + g) * a.ld;
#pragma unroll
          for (int kk = 0; kk < 8 * NC; ++kk) {
            if (16 * kk < D) {
              uint32_t b0, b1;
              load_b(reinterpret_cast<const TC*>(row) + 16 * kk + 4 * t, b0,
                     b1);
              mma_bf16(c0, c1, c2, c3, qa[kk][0], qa[kk][1], b0, b1);
            }
          }
          s[2 * j] = c0;
          s[2 * j + 1] = c1;
        }
        float mx = kNegInf;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int pos = 8 * (e >> 1) + 2 * t + (e & 1);
          s[e] = pos < n ? s[e] * a.scale * (quant ? sc[pos] : 1.f) : kNegInf;
          mx = fmaxf(mx, s[e]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[0], mx);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int pos = 8 * (e >> 1) + 2 * t + (e & 1);
          const float p = s[e] <= kNegInf * 0.5f ? 0.f : expf(s[e] - m_new);
          sum += p;
          pw[g * kPw + pos] = quant ? p * sc[kTile + pos] : p;
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        const float cr = m[0] <= kNegInf * 0.5f ? 0.f : expf(m[0] - m_new);
        l[0] = l[0] * cr + sum;
        m[0] = m_new;
#pragma unroll
        for (int i = 0; i < kRows; ++i) corr[i] = __shfl_sync(kFull, cr, 4 * i);
      } else {
        // scores on the CUDA cores: lane = position, every resident row
        float s[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) s[i] = 0.f;
        const TC* krow = reinterpret_cast<const TC*>(st + lane * a.ld);
        constexpr int E = 16 / (int)sizeof(TC);
        const int dv = D / E * E;
        for (int d0 = 0; d0 < dv; d0 += E) {
          float x[E];
          unpack16(krow + d0, x);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float* qr = qs + i * D + d0;
#pragma unroll
            for (int e = 0; e < E; e += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qr + e);
              s[i] = fmaf(qq.x, x[e], s[i]);
              s[i] = fmaf(qq.y, x[e + 1], s[i]);
              s[i] = fmaf(qq.z, x[e + 2], s[i]);
              s[i] = fmaf(qq.w, x[e + 3], s[i]);
            }
          }
        }
        for (int d0 = dv; d0 < D; d0 += 4) {  // rows not 16 bytes whole
          const float4 kk = load4(krow + d0);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float4 qq =
                *reinterpret_cast<const float4*>(qs + i * D + d0);
            s[i] = fmaf(qq.x, kk.x, s[i]);
            s[i] = fmaf(qq.y, kk.y, s[i]);
            s[i] = fmaf(qq.z, kk.z, s[i]);
            s[i] = fmaf(qq.w, kk.w, s[i]);
          }
        }
        const float ksl = quant ? sc[lane] : 1.f;
        const float vsl = quant ? sc[kTile + lane] : 1.f;
        const bool vis = lane < n;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float si = vis ? s[i] * ksl : kNegInf;
          const float m_new = fmaxf(m[i], warp_max(si));
          const float p = si <= kNegInf * 0.5f ? 0.f : expf(si - m_new);
          corr[i] = m[i] <= kNegInf * 0.5f ? 0.f : expf(m[i] - m_new);
          l[i] = l[i] * corr[i] + warp_sum(p);
          m[i] = m_new;
          pw[i * kPw + lane] = p * vsl;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= corr[i];
      __syncwarp();
      // acc += p v: lane holds the float4 chunks lane + 32 cc of each row
      const unsigned char* vbase = st + kTile * a.ld;
#pragma unroll 2
      for (int t4 = 0; t4 < n; t4 += 4) {
        float4 pp[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          pp[i] = *reinterpret_cast<const float4*>(pw + i * kPw + t4);
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          const TC* vrow = reinterpret_cast<const TC*>(vbase + (t4 + tt) * a.ld);
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            const int c = lane + 32 * cc;
            if (c < D4) {
              const float4 vv = load4(vrow + 4 * c);
#pragma unroll
              for (int i = 0; i < kRows; ++i) {
                const float pj = comp(pp[i], tt);
                acc[i][4 * cc + 0] = fmaf(pj, vv.x, acc[i][4 * cc + 0]);
                acc[i][4 * cc + 1] = fmaf(pj, vv.y, acc[i][4 * cc + 1]);
                acc[i][4 * cc + 2] = fmaf(pj, vv.z, acc[i][4 * cc + 2]);
                acc[i][4 * cc + 3] = fmaf(pj, vv.w, acc[i][4 * cc + 3]);
              }
            }
          }
        }
      }
      __syncwarp();  // the ring slot is rewritten by the next issue
    }
    cp_wait(0);
    __syncwarp();

    // the warp's partial, into its own (now idle) ring
    float* wm = reinterpret_cast<float*>(ring);
    float* wl = wm + kRows;
    float* wa = wl + kRows;
    if constexpr (MMA) {
      if ((lane & 3) == 0) {
        wm[lane >> 2] = m[0];
        wl[lane >> 2] = l[0];
      }
    } else if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        wm[i] = m[i];
        wl[i] = l[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = lane + 32 * cc;
        if (c < D4)
          *reinterpret_cast<float4*>(wa + i * D + 4 * c) =
              make_float4(acc[i][4 * cc], acc[i][4 * cc + 1],
                          acc[i][4 * cc + 2], acc[i][4 * cc + 3]);
      }
    __syncthreads();

    // the block's partial: the warps' merged in warp order
    for (int e = tid; e < rows * D; e += nthreads) {
      const int i = e / D;
      float M = kNegInf;
      for (int w = 0; w < nwarps; ++w) {
        const float* r = reinterpret_cast<const float*>(
            reinterpret_cast<unsigned char*>(bpa + kRows * D) +
            (long long)w * a.warp_bytes + kRows * kPw * sizeof(float));
        M = fmaxf(M, r[i]);
      }
      float L = 0.f, A = 0.f;
      for (int w = 0; w < nwarps; ++w) {
        const float* r = reinterpret_cast<const float*>(
            reinterpret_cast<unsigned char*>(bpa + kRows * D) +
            (long long)w * a.warp_bytes + kRows * kPw * sizeof(float));
        const float corr = r[i] <= kNegInf * 0.5f ? 0.f : expf(r[i] - M);
        L += r[kRows + i] * corr;
        A += r[2 * kRows + e] * corr;
      }
      bpa[e] = A;
      if (e - i * D == 0) {
        bpm[i] = M;
        bpl[i] = L;
      }
    }
    cluster.sync();

    // the cluster's partials merged in rank order; rank r finishes every
    // 8th share of the outputs
    for (int e = rank * nthreads + tid; e < rows * D;
         e += kCluster * nthreads) {
      const int i = e / D;
      // every remote load issued before the first is used
      float mr[kCluster], lr[kCluster], ar[kCluster];
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        mr[r] = cluster.map_shared_rank(bpm, r)[i];
        lr[r] = cluster.map_shared_rank(bpl, r)[i];
        ar[r] = cluster.map_shared_rank(bpa, r)[e];
      }
      float M = kNegInf;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) M = fmaxf(M, mr[r]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const float corr = mr[r] <= kNegInf * 0.5f ? 0.f : expf(mr[r] - M);
        L += lr[r] * corr;
        A += ar[r] * corr;
      }
      out[(bkv * G + r0 + i) * D + (e - i * D)] =
          from_f32<TQ>(A / fmaxf(L, 1e-30f));
    }
    cluster.sync();  // every rank's shared memory outlives the remote reads
  }
}

// -- launch configuration ------------------------------------------------------

struct Config {
  int warps, stages, smem, ld;
};

// Eight warps and the most ring stages (up to 3) that fit kSmemBudget
// bytes of shared memory a block; fewer warps for rows too wide for one
// stage each.
template <typename TC>
Config plan(int D) {
  Config c{};
  const int row_bytes = D * (int)sizeof(TC);
  c.ld = (row_bytes + 15) / 16 * 16 + 16;
  const int stage = 2 * kTile * c.ld + 2 * kTile * (int)sizeof(float);
  const int fixed = (2 * kRows * D + 2 * kRows) * (int)sizeof(float);
  const int pbuf = kRows * kPw * (int)sizeof(float);
  c.warps = kMaxWarps;
  c.stages = ((kSmemBudget - fixed) / c.warps - pbuf) / stage;
  while (c.stages < 1 && c.warps > 1) {  // wide f32 rows: fewer warps
    --c.warps;
    c.stages = ((kSmemBudget - fixed) / c.warps - pbuf) / stage;
  }
  if (c.stages < 1) c.stages = 1;
  if (c.stages > kMaxStages) c.stages = kMaxStages;
  c.smem = fixed + c.warps * (pbuf + c.stages * stage);
  return c;
}

template <typename TQ, typename TC, int NC, bool MMA>
int launch_nc(const Args& base, int BKV, Config* info, cudaStream_t st) {
  auto kern = decode_kernel<TQ, TC, NC, MMA>;
  const Config c = plan<TC>(base.D);
  // the attribute is set on the first (eager) call of a configuration,
  // never inside a stream capture of a later one
  static int smem_set = 0;
  if (c.smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = c.smem;
  }
  if (info != nullptr) *info = c;
  Args a = base;
  a.ld = c.ld;
  a.stages = c.stages;
  a.warp_bytes = kRows * kPw * (int)sizeof(float) +
                 c.stages * (2 * kTile * c.ld + 2 * kTile * (int)sizeof(float));
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)kCluster, (unsigned)BKV);
  cfg.blockDim = dim3((unsigned)(32 * c.warps));
  cfg.dynamicSmemBytes = (size_t)c.smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int launch(const Args& a, int BKV, Config* info, cudaStream_t st) {
  // the tensor cores for bf16 q against a bf16 or int8 cache
  constexpr bool kMma = std::is_same<TQ, __nv_bfloat16>::value &&
                        !std::is_same<TC, float>::value;
  return a.D <= 128 ? launch_nc<TQ, TC, 1, kMma>(a, BKV, info, st)
                    : launch_nc<TQ, TC, 2, kMma>(a, BKV, info, st);
}

template <typename TQ>
int by_cache(int cdtype, const Args& a, int BKV, Config* info,
             cudaStream_t st) {
  switch (cdtype) {
    case 0: return launch<TQ, float>(a, BKV, info, st);
    case 1: return launch<TQ, __nv_bfloat16>(a, BKV, info, st);
    case 3: return launch<TQ, signed char>(a, BKV, info, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qdtype: 0 f32, 1 bf16 (q and out); cdtype: 0 f32, 1 bf16, 3 int8 (both
// caches).  k_scale / v_scale: (BKV, Smax) f32, or null for an unscaled
// cache.  length: a 0-d int32 on the device, clipped to [0, Smax] by the
// kernel.  cp: bytes of each cache copy (16, 8 or 4; dividing D times the
// element size and both caches' addresses).  All contiguous; D % 4 == 0,
// D <= 256, BKV <= 65535 (checked by the Python wrapper).  config, when
// not null, receives {cluster, warps, stages, smem bytes}.  Returns the
// first failing cudaError_t, else 0.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale, const void* length,
                                      void* out, int qdtype, int cdtype,
                                      int BKV, int G, int Smax, int D, int cp,
                                      float scale, int* config, void* stream) {
  if (BKV == 0 || G == 0) return 0;
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = (const float*)k_scale;
  a.vs = (const float*)v_scale;
  a.length = (const int*)length;
  a.out = out;
  a.G = G;
  a.Smax = Smax;
  a.D = D;
  a.cp = cp;
  a.scale = scale;
  Config c{};
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  switch (qdtype) {
    case 0: err = by_cache<float>(cdtype, a, BKV, &c, st); break;
    case 1: err = by_cache<__nv_bfloat16>(cdtype, a, BKV, &c, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (config != nullptr) {
    config[0] = kCluster;
    config[1] = c.warps;
    config[2] = c.stages;
    config[3] = c.smem;
  }
  return err;
}
