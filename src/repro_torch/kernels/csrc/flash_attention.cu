// Flash-attention forward (B7), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd_grouped (body _kernel).  GQA-grouped layout:
// q (BKV, G, S, D), k and v (BKV, Sk, D), any of f32 / bf16 / f16 (one type
// for all three); out (BKV, G, S, D) in that type, lse (BKV, G, S) f32.
// Query i sees key j when not causal, or when j <= i (and j > i - window
// with a window) or j < prefix.  The arithmetic is f32, as on the TPU, with
// its guards: masked scores are NEG_INF = -FLT_MAX (not -inf), p = 0 where
// s <= NEG_INF / 2, the correction is 0 while m is still NEG_INF,
// out = acc / max(l, 1e-30) (0 on a fully masked row) and
// lse = m + log(max(l, 1e-30)).  Any S and Sk: ragged tails are masked.
//
// Bound on this card: operations.  At the prefill shape (8 x 8 heads,
// S = 4096, D = 128, causal) the work is 4 D BKV G S (S + 1) / 2 = 2.75e11
// FLOP over 33.6 MB of q, k, v and out; in f32 on the CUDA cores (67
// TFLOP/s) that is 4.1 ms, in bf16 on the tensor cores (989 TFLOP/s) 0.28 ms.
// This first kernel computes in f32 on the CUDA cores; wgmma is later work.
//
// Design: one block of 8 warps per (query tile, bkv row).  The tile holds
// bq = 64 / G positions of all G heads that share the kv row, 64 query rows
// in all, staged once in shared memory as f32 pre-scaled by 1/sqrt(D).
// The block walks 32-key tiles of k and v (staged as f32, rows padded to
// D + 4 floats so the float4 reads hit distinct banks) and skips the whole
// tiles above the diagonal unless the prefix reaches into them.  Each warp
// owns 8 query rows and keeps their running m, l and acc (f32) in
// registers: lane j scores key j against the 8 rows, the warp reduces max
// and sum by shuffles (every lane ends with the same value, so the sums
// repeat bit for bit), writes p to a per-warp shared row, and then lane t
// accumulates d = 4t .. 4t + 3 (and + 128 for D > 128) of p @ v.  For
// D <= 128 the registers are held to 128 a thread, so that two blocks
// (16 warps) share an SM.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 32;                     // keys per tile, one per lane
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
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
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

// Stage rows [0, n) of a (rows, D) matrix as f32 times `mul` into shared
// rows of stride ld; row_ptr(r) gives the row's source or nullptr for a
// zero row.  A thread issues a batch of kBatch loads before it stores the
// first, so that their latencies overlap.
template <typename T, typename RowPtr>
__device__ __forceinline__ void stage(float* dst, int n, int D, int ld,
                                      float mul, RowPtr row_ptr) {
  constexpr int kBatch = 4;
  const int D4 = D >> 2;
  const int total = n * D4;
  const int step = blockDim.x;
  for (int base = threadIdx.x; base < total; base += kBatch * step) {
    float4 x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * step;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total) {
        const int r = i / D4, c = i - r * D4;
        const T* src = row_ptr(r);
        if (src != nullptr) x[u] = load4(src + 4 * c);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * step;
      if (i < total) {
        const int r = i / D4, c = i - r * D4;
        float4 y = x[u];
        y.x *= mul; y.y *= mul; y.z *= mul; y.w *= mul;
        *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = y;
      }
    }
  }
}

// Stage key rows [k0, k0 + kTile) of k and of v together (zero past Sk),
// all of a thread's loads of both issued before its first store.
template <typename T>
__device__ __forceinline__ void stage_kv(float* ks, float* vs, const T* k,
                                         const T* v, int k0, int Sk, int D,
                                         int ld) {
  constexpr int kBatch = 4;
  const int D4 = D >> 2;
  const int total = kTile * D4;
  const int step = blockDim.x;
  for (int base = threadIdx.x; base < total; base += kBatch * step) {
    float4 xk[kBatch], xv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * step;
      const int j = i / D4, c = i - j * D4;
      xk[u] = xv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total && k0 + j < Sk) {
        const long long off = (long long)(k0 + j) * D + 4 * c;
        xk[u] = load4(k + off);
        xv[u] = load4(v + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * step;
      const int j = i / D4, c = i - j * D4;
      if (i < total) {
        *reinterpret_cast<float4*>(ks + j * ld + 4 * c) = xk[u];
        *reinterpret_cast<float4*>(vs + j * ld + 4 * c) = xv[u];
      }
    }
  }
}

// NC: float4 chunks of a row per lane (D <= 128 NC).
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32, 3 - NC)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ lse, int G, int S, int Sk, int D, int bq,
          int causal, int has_window, int window, int prefix, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* qs = smem;                     // kRows x ld
  float* ks = qs + kRows * ld;          // kTile x ld
  float* vs = ks + kTile * ld;          // kTile x ld
  float* ps = vs + kTile * ld;          // kWarps x kRowsPerWarp x kTile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bkv = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int rows = G * bq;
  const int D4 = D >> 2;

  stage<T>(qs, kRows, D, ld, scale, [&](int r) -> const T* {
    if (r >= rows) return nullptr;
    const int g = r / bq, qp = q0 + r % bq;
    return qp < S ? q + ((bkv * G + g) * S + qp) * D : nullptr;
  });

  const int row0 = warp * kRowsPerWarp;
  const bool active = row0 < rows;
  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4 * NC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qpos[i] = q0 + (row0 + i) % bq;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  // whole key tiles above the diagonal contribute nothing, unless the
  // bidirectional prefix reaches into them
  const int ntiles = (Sk + kTile - 1) / kTile;
  int tiles = ntiles;
  if (causal) {
    const int last = max(q0 + bq - 1, prefix - 1);
    tiles = min(ntiles, last / kTile + 1);
  }
  float* pw = ps + warp * kRowsPerWarp * kTile;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile is consumed
    stage_kv(ks, vs, k + bkv * Sk * D, v + bkv * Sk * D, k0, Sk, D, ld);
    __syncthreads();
    if (!active) continue;

    // scores of key k0 + lane against the warp's 8 rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = ks + lane * ld;
    for (int c = 0; c < D4; ++c) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + 4 * c);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(qs + (row0 + i) * ld + 4 * c);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool vis = kp < Sk;
      if (causal) {
        bool c = kp <= qpos[i];
        if (has_window) c = c && kp > qpos[i] - window;
        if (prefix) c = c || kp < prefix;
        vis = vis && c;
      }
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

    // acc += p @ v, lane t holding d = 4 (t + 32 cc) .. + 3
#pragma unroll
    for (int j4 = 0; j4 < kTile / 4; ++j4) {
      float4 pp[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        pp[i] = *reinterpret_cast<const float4*>(pw + i * kTile + 4 * j4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (4 * j4 + jj) * ld;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int c = lane + 32 * cc;
          if (c < D4) {
            const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * c);
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
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
    __syncwarp();
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + i;
    if (r >= rows || qpos[i] >= S) continue;
    const long long row = (bkv * G + r / bq) * S + qpos[i];
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + row * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (c < D4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * c + e] = from_f32<T>(acc[i][4 * cc + e] / den);
      }
    }
    if (lane == 0) lse[row] = m[i] + logf(den);
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BKV, int G, int S, int Sk, int D, int causal, int has_window,
           int window, int prefix, float scale, cudaStream_t st) {
  const int bq = kRows / G;
  const size_t smem =
      (size_t)((kRows + 2 * kTile) * (D + 4) + kWarps * kRowsPerWarp * kTile) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + bq - 1) / bq), (unsigned)BKV);
  flash_fwd<T, NC><<<grid, kWarps * 32, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, G, S, Sk, D,
      bq, causal, has_window, window, prefix, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_nc(const void* q, const void* k, const void* v, void* out,
                void* lse, int BKV, int G, int S, int Sk, int D, int causal,
                int has_window, int window, int prefix, float scale,
                cudaStream_t st) {
  if (D <= 128)
    return launch<T, 1>(q, k, v, out, lse, BKV, G, S, Sk, D, causal,
                        has_window, window, prefix, scale, st);
  return launch<T, 2>(q, k, v, out, lse, BKV, G, S, Sk, D, causal, has_window,
                      window, prefix, scale, st);
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16 (q, k, v and out alike).  All tensors
// contiguous; D % 4 == 0, D <= 256, 1 <= G <= 64, BKV <= 65535 (checked by
// the Python wrapper).  has_window = 0 ignores window.  Returns the first
// failing cudaError_t, else 0.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int dtype, int BKV, int G, int S,
                                         int Sk, int D, int causal,
                                         int has_window, int window,
                                         int prefix, float scale,
                                         void* stream) {
  if (BKV == 0 || S == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch_nc<float>(q, k, v, out, lse, BKV, G, S, Sk, D, causal,
                                has_window, window, prefix, scale, st);
    case 1:
      return dispatch_nc<__nv_bfloat16>(q, k, v, out, lse, BKV, G, S, Sk, D,
                                        causal, has_window, window, prefix,
                                        scale, st);
    case 2:
      return dispatch_nc<__half>(q, k, v, out, lse, BKV, G, S, Sk, D, causal,
                                 has_window, window, prefix, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
