// Single-token decode attention (B9), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:decode_attention
// (body _kernel).  Grouped layout: q (BKV, G, D) one token per sequence in
// f32 / bf16; caches (BKV, Smax, D) in f32 / bf16, or int8 codes with
// (BKV, Smax) f32 scales dequantised here (k = code * k_scale).
// out = softmax(q / sqrt(D) . k^T over positions < length) . v in f32,
// written in q's dtype.  The TPU kernel's guards: masked scores are
// NEG_INF = -FLT_MAX, p = 0 where s <= NEG_INF / 2, the correction is 0
// while m is NEG_INF, out = acc / max(l, 1e-30); cache blocks at or past
// `length` are never read.
//
// Bound on this card: bytes.  Each position read moves 2 D bytes of int8
// codes and 8 bytes of scales (4 D bytes of a bf16 cache) for 4 G D FLOP:
// at G = 8, D = 128, 16 FLOP a byte, below the 20 f32 FLOP a byte at which
// the CUDA cores (67 TFLOP/s), not the memory (3.35 TB/s), would limit.
//
// Design: a grid of (splits, BKV) one-warp blocks.  One block per BKV row,
// as the TPU grid (BKV, ns) suggests, would start 8 blocks on 132 SMs at
// batch 4 x 2 kv heads, so the `length` positions are cut into splits of
// `chunk` positions (the wrapper aims at about 8 blocks an SM), each split
// is a block, and
//  1. decode_partial: the warp walks its split in 32-position tiles
//     (staged dequantised as f32 in shared memory, rows padded to D + 4
//     floats), lane j scoring position j against up to 8 query rows, and
//     keeps an online softmax (m, l, acc) in registers, as the flash kernel
//     does; it writes its unnormalised partial (m, l, acc).
//  2. decode_combine: one block per (query row, BKV row), one thread per
//     d, merges the partials in split order (M = max m_s; L = sum l_s e^(m_s - M); A likewise), so the
//     result repeats bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kRows = 8;    // query rows per pass of the warp
constexpr int kTile = 32;   // positions per tile, one per lane
constexpr int kMaxD = 256;   // head dims up to this (one combine thread each)
constexpr float kNegInf = -FLT_MAX;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const signed char* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
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
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Stage positions [t0, t0 + 32) of one cache row block as f32 (times the
// position's scale when `scales` is given; zero at or past `end`).
// The loads of a batch are all issued before the first is used, so a
// lane has kBatch of them in flight: one warp alone has to hide the
// memory latency.
template <typename TC>
__device__ __forceinline__ void stage_tile(float* dst, const TC* cache,
                                           const float* scales, int t0,
                                           int end, int D, int ld) {
  constexpr int kBatch = 8;
  const int lane = threadIdx.x;
  const int D4 = D >> 2;
  const int n = kTile * D4;
  for (int base = 0; base < n; base += 32 * kBatch) {
    float4 x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + 32 * u + lane;
      const int j = i / D4, c = i - j * D4;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && t0 + j < end) {
        x[u] = load4(cache + (long long)(t0 + j) * D + 4 * c);
        if (scales != nullptr) {
          const float sc = scales[t0 + j];
          x[u].x *= sc; x[u].y *= sc; x[u].z *= sc; x[u].w *= sc;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + 32 * u + lane;
      const int j = i / D4, c = i - j * D4;
      if (i < n) *reinterpret_cast<float4*>(dst + j * ld + 4 * c) = x[u];
    }
  }
}

// NC: float4 chunks of a row per lane (D <= 128 NC).  One warp per block.
template <typename TQ, typename TC, int NC>
__global__ void __launch_bounds__(32)
decode_partial(const TQ* __restrict__ q, const TC* __restrict__ kc,
               const TC* __restrict__ vc, const float* __restrict__ kscale,
               const float* __restrict__ vscale, float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_acc,
               int G, int Smax, int D, int length, int chunk, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* qs = smem;                  // kRows x ld
  float* buf = qs + kRows * ld;      // kTile x ld: the k tile, then the v tile
  float* pw = buf + kTile * ld;      // kRows x kTile
  const int lane = threadIdx.x;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const long long bkv = blockIdx.y;
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, length);
  const int D4 = D >> 2;
  const TC* kr = kc + bkv * Smax * D;
  const TC* vr = vc + bkv * Smax * D;
  const float* ksr = kscale != nullptr ? kscale + bkv * Smax : nullptr;
  const float* vsr = vscale != nullptr ? vscale + bkv * Smax : nullptr;

  for (int r0 = 0; r0 < G; r0 += kRows) {
    __syncwarp();
    for (int i = lane; i < kRows * D4; i += 32) {
      const int r = i / D4, c = i - r * D4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < G) {
        x = load4(q + (bkv * G + r0 + r) * D + 4 * c);
        x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
      }
      *reinterpret_cast<float4*>(qs + r * ld + 4 * c) = x;
    }
    float m[kRows], l[kRows], acc[kRows][4 * NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
    }
    for (int t0 = s0; t0 < s1; t0 += kTile) {
      __syncwarp();
      stage_tile(buf, kr, ksr, t0, s1, D, ld);
      __syncwarp();
      float s[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] = 0.f;
      const float* krow = buf + lane * ld;
      for (int c = 0; c < D4; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(krow + 4 * c);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 qq = *reinterpret_cast<const float4*>(qs + i * ld + 4 * c);
          s[i] = fmaf(qq.x, kk.x, s[i]);
          s[i] = fmaf(qq.y, kk.y, s[i]);
          s[i] = fmaf(qq.z, kk.z, s[i]);
          s[i] = fmaf(qq.w, kk.w, s[i]);
        }
      }
      const bool vis = t0 + lane < s1;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float si = vis ? s[i] : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(si));
        const float p = si <= kNegInf * 0.5f ? 0.f : expf(si - m_new);
        const float corr = m[i] <= kNegInf * 0.5f ? 0.f : expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(p);
        m[i] = m_new;
        pw[i * kTile + lane] = p;
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= corr;
      }
      __syncwarp();
      stage_tile(buf, vr, vsr, t0, s1, D, ld);
      __syncwarp();
#pragma unroll
      for (int j4 = 0; j4 < kTile / 4; ++j4) {
        float4 pp[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          pp[i] = *reinterpret_cast<const float4*>(pw + i * kTile + 4 * j4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* vrow = buf + (4 * j4 + jj) * ld;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            const int c = lane + 32 * cc;
            if (c < D4) {
              const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * c);
#pragma unroll
              for (int i = 0; i < kRows; ++i) {
                const float pj = comp(pp[i], jj);
                acc[i][4 * cc + 0] = fmaf(pj, vv.x, acc[i][4 * cc + 0]);
                acc[i][4 * cc + 1] = fmaf(pj, vv.y, acc[i][4 * cc + 1]);
                acc[i][4 * cc + 2] = fmaf(pj, vv.z, acc[i][4 * cc + 2]);
                acc[i][4 * cc + 3] = fmaf(pj, vv.w, acc[i][4 * cc + 3]);
              }
            }
          }
        }
      }
    }
    // partials: (BKV, nsplit, G) m and l, (BKV, nsplit, G, D) acc
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int g = r0 + i;
      if (g >= G) break;
      const long long row = (bkv * nsplit + split) * G + g;
      if (lane == 0) {
        part_m[row] = m[i];
        part_l[row] = l[i];
      }
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = lane + 32 * cc;
        if (c < D4)
          *reinterpret_cast<float4*>(part_acc + row * D + 4 * c) = make_float4(
              acc[i][4 * cc], acc[i][4 * cc + 1], acc[i][4 * cc + 2],
              acc[i][4 * cc + 3]);
      }
    }
  }
}

// One block per (query row g, bkv row), one thread per d.
template <typename TQ>
__global__ void __launch_bounds__(kMaxD)
decode_combine(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc, TQ* __restrict__ out,
               int G, int D, int nsplit) {
  const int g = blockIdx.x, d = threadIdx.x;
  const long long bkv = blockIdx.y;
  const long long base = bkv * nsplit * G + g;
  float M = kNegInf;
#pragma unroll 4
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part_m[base + (long long)s * G]);
  float L = 0.f, A = 0.f;
#pragma unroll 4
  for (int s = 0; s < nsplit; ++s) {
    const long long row = base + (long long)s * G;
    const float ms = part_m[row];
    const float corr = ms <= kNegInf * 0.5f ? 0.f : expf(ms - M);
    L += part_l[row] * corr;
    A += part_acc[row * D + d] * corr;
  }
  out[(bkv * G + g) * D + d] = from_f32<TQ>(A / fmaxf(L, 1e-30f));
}

template <typename TQ, typename TC>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* part_m, void* part_l, void* part_acc,
           void* out, int BKV, int G, int Smax, int D, int length, int chunk,
           int nsplit, float scale, cudaStream_t st) {
  const int ld = D + 4;
  const size_t smem =
      (size_t)((kRows + kTile) * ld + kRows * kTile) * sizeof(float);
  if (nsplit > 0) {
    const dim3 grid((unsigned)nsplit, (unsigned)BKV);
    if (D <= 128)
      decode_partial<TQ, TC, 1><<<grid, 32, smem, st>>>(
          (const TQ*)q, (const TC*)k, (const TC*)v, (const float*)ks,
          (const float*)vs, (float*)part_m, (float*)part_l, (float*)part_acc,
          G, Smax, D, length, chunk, scale);
    else
      decode_partial<TQ, TC, 2><<<grid, 32, smem, st>>>(
          (const TQ*)q, (const TC*)k, (const TC*)v, (const float*)ks,
          (const float*)vs, (float*)part_m, (float*)part_l, (float*)part_acc,
          G, Smax, D, length, chunk, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  decode_combine<TQ><<<dim3((unsigned)G, (unsigned)BKV), D, 0, st>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      (TQ*)out, G, D, nsplit);
  return (int)cudaGetLastError();
}

template <typename TQ>
int by_cache(int cdtype, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, void* pm, void* pl, void* pa,
             void* out, int BKV, int G, int Smax, int D, int length, int chunk,
             int nsplit, float scale, cudaStream_t st) {
  switch (cdtype) {
    case 0:
      return launch<TQ, float>(q, k, v, ks, vs, pm, pl, pa, out, BKV, G, Smax,
                               D, length, chunk, nsplit, scale, st);
    case 1:
      return launch<TQ, __nv_bfloat16>(q, k, v, ks, vs, pm, pl, pa, out, BKV,
                                       G, Smax, D, length, chunk, nsplit,
                                       scale, st);
    case 3:
      return launch<TQ, signed char>(q, k, v, ks, vs, pm, pl, pa, out, BKV, G,
                                     Smax, D, length, chunk, nsplit, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qdtype: 0 f32, 1 bf16 (q and out); cdtype: 0 f32, 1 bf16, 3 int8 (both
// caches).  k_scale / v_scale: (BKV, Smax) f32, or null for
// an unscaled cache.  length: valid positions, already clipped to
// [0, Smax]; nsplit = ceil(length / chunk).  Scratch part_m, part_l
// (BKV, nsplit, G) and part_acc (BKV, nsplit, G, D) f32.  All contiguous;
// D % 4 == 0, D <= 256 (checked by the Python wrapper).  Returns the first
// failing cudaError_t, else 0.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale, void* part_m,
                                      void* part_l, void* part_acc, void* out,
                                      int qdtype, int cdtype, int BKV, int G,
                                      int Smax, int D, int length, int chunk,
                                      int nsplit, float scale, void* stream) {
  if (BKV == 0 || G == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (qdtype) {
    case 0:
      return by_cache<float>(cdtype, q, k, v, k_scale, v_scale, part_m, part_l,
                             part_acc, out, BKV, G, Smax, D, length, chunk,
                             nsplit, scale, st);
    case 1:
      return by_cache<__nv_bfloat16>(cdtype, q, k, v, k_scale, v_scale, part_m,
                                     part_l, part_acc, out, BKV, G, Smax, D,
                                     length, chunk, nsplit, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
