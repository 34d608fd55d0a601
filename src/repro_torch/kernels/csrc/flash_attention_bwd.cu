// Flash-attention backward (B8), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention_bwd.py:
// flash_attention_bwd (bodies _dq_kernel and _dkv_kernel).  GQA-grouped
// layout, as the forward (B7): q, out and dout (BKV, G, S, D), k and v
// (BKV, Sk, D), one of f32 / bf16 / f16 for all five; lse (BKV, G, S) f32
// from the forward.  Writes dq (BKV, G, S, D), dk and dv (BKV, Sk, D) in
// that type, and delta (BKV, G, S) f32 scratch.  The arithmetic is f32, as
// on the TPU, with its guards: masked scores are NEG_INF = -FLT_MAX,
// p = exp(s - lse) with p = 0 where s <= NEG_INF / 2, so a fully masked row
// gives zero gradients.  Any S and Sk: ragged tails are masked.
//
// Three launches on the caller's stream, no atomics, so results repeat bit
// for bit:
//   1. delta: delta = rowsum(dout * out), one warp per row.
//   2. dq: one block of 8 warps per (query tile, bkv row), the tile being
//      64 / G positions of the G heads that share the kv row (64 query rows,
//      as B7), q (pre-scaled by 1/sqrt(D)) and dout staged once as f32.  It
//      walks the visible 32-key tiles of k and v; lane j scores key j
//      against the warp's 8 rows (s = q.k, dp = dout.v), forms
//      ds = p (dp - delta) and, through a per-warp shared row, accumulates
//      dq += ds k with lane t holding d = 4t .. 4t + 3 (+ 128 for D > 128);
//      dq = acc / sqrt(D).
//   3. dk/dv: one block of 8 warps per (32-key tile, bkv row), each warp
//      owning 4 keys.  It loops over the G query heads of the kv row and,
//      within each, over the 32-query tiles that can see the keys (from the
//      diagonal on, under a causal mask, unless the prefix reaches the
//      tile), staging q (pre-scaled), dout, lse and delta of each; lane j
//      scores query j against the warp's 4 keys and the warp accumulates
//      dv += p^T dout, then dk += ds^T (q / sqrt(D)), in registers.  The
//      loop over heads is GQA's sum.
//
// Bound on this card: operations.  At the training shape (2 x 2 kv heads of
// 8 query heads, S = 4096, D = 128, causal) the work is 5 products of 2 D
// FLOP per visible (q, k) pair, 3.44e11 FLOP; in bf16 on the tensor cores
// (989 TFLOP/s) 0.35 ms, in f32 on the CUDA cores (67 TFLOP/s) 5.1 ms.
// This first kernel computes in f32 on the CUDA cores, tiles staged in
// shared memory; wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;               // dq: query rows a warp
constexpr int kRows = kWarps * kRowsPerWarp;  // dq: query rows a block
constexpr int kKeysPerWarp = 4;               // dk/dv: keys a warp
constexpr int kKeys = kWarps * kKeysPerWarp;  // dk/dv: keys a block
constexpr int kTile = 32;  // keys (dq) or queries (dk/dv) a tile, one a lane
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Does query qp see key kp?  Positions past S or Sk see nothing.
__device__ __forceinline__ bool visible(int qp, int kp, int S, int Sk,
                                        int causal, int has_window,
                                        int window, int prefix) {
  bool vis = qp < S && kp < Sk;
  if (causal) {
    bool c = kp <= qp;
    if (has_window) c = c && kp > qp - window;
    if (prefix) c = c || kp < prefix;
    vis = vis && c;
  }
  return vis;
}

// p of score s (NEG_INF where masked) against its row's lse, with the TPU
// kernel's guard.
__device__ __forceinline__ float prob(float s, float lse) {
  return s <= kNegInf * 0.5f ? 0.f : expf(s - lse);
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

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dout * out), one warp per row of (BKV * G * S, D)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
                float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < (D >> 2); c += 32)
    acc = dot4(load4(o + 4 * c), load4(g + 4 * c), acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dq: one block per (query tile, bkv row)
// ---------------------------------------------------------------------------

// NC: float4 chunks of a row per lane (D <= 128 NC).
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32, 3 - NC)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int G, int S, int Sk, int D, int bq,
             int causal, int has_window, int window, int prefix,
             float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* qs = smem;                     // kRows x ld, q / sqrt(D)
  float* dos = qs + kRows * ld;         // kRows x ld
  float* ks = dos + kRows * ld;         // kTile x ld
  float* vs = ks + kTile * ld;          // kTile x ld
  float* ps = vs + kTile * ld;          // kWarps x kRowsPerWarp x kTile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bkv = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int rows = G * bq;
  const int D4 = D >> 2;

  auto q_row = [&](const T* base, int r) -> const T* {
    if (r >= rows) return nullptr;
    const int g = r / bq, qp = q0 + r % bq;
    return qp < S ? base + ((bkv * G + g) * S + qp) * D : nullptr;
  };
  stage<T>(qs, kRows, D, ld, scale, [&](int r) { return q_row(q, r); });
  stage<T>(dos, kRows, D, ld, 1.f, [&](int r) { return q_row(dout, r); });

  const int row0 = warp * kRowsPerWarp;
  const bool active = row0 < rows;
  int qpos[kRowsPerWarp];
  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp];
  float acc[kRowsPerWarp][4 * NC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + i;
    // a row past the tile (r >= rows) takes a position past S: masked
    qpos[i] = r < rows ? q0 + r % bq : S;
    lse_r[i] = delta_r[i] = 0.f;
    if (qpos[i] < S) {
      const long long row = (bkv * G + r / bq) * S + qpos[i];
      lse_r[i] = lse[row];
      delta_r[i] = delta[row];
    }
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
  const T* kb = k + bkv * Sk * D;
  const T* vb = v + bkv * Sk * D;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile is consumed
    auto k_row = [&](const T* base, int j) -> const T* {
      return k0 + j < Sk ? base + (long long)(k0 + j) * D : nullptr;
    };
    stage<T>(ks, kTile, D, ld, 1.f, [&](int j) { return k_row(kb, j); });
    stage<T>(vs, kTile, D, ld, 1.f, [&](int j) { return k_row(vb, j); });
    __syncthreads();
    if (!active) continue;

    // s and dp of key k0 + lane against the warp's 8 rows
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
    const float* krow = ks + lane * ld;
    const float* vrow = vs + lane * ld;
    for (int c = 0; c < D4; ++c) {
      const float4 kk = load4(krow + 4 * c);
      const float4 vv = load4(vrow + 4 * c);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        s[i] = dot4(load4(qs + (row0 + i) * ld + 4 * c), kk, s[i]);
        dp[i] = dot4(load4(dos + (row0 + i) * ld + 4 * c), vv, dp[i]);
      }
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool vis = visible(qpos[i], kp, S, Sk, causal, has_window,
                               window, prefix);
      const float p = prob(vis ? s[i] : kNegInf, lse_r[i]);
      pw[i * kTile + lane] = p * (dp[i] - delta_r[i]);
    }
    __syncwarp();

    // acc += ds @ k, lane t holding d = 4 (t + 32 cc) .. + 3
#pragma unroll
    for (int j4 = 0; j4 < kTile / 4; ++j4) {
      float4 dd[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        dd[i] = load4(pw + i * kTile + 4 * j4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* kr = ks + (4 * j4 + jj) * ld;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int c = lane + 32 * cc;
          if (c < D4) {
            const float4 kk = load4(kr + 4 * c);
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
              const float dj = comp(dd[i], jj);
              acc[i][4 * cc + 0] = fmaf(dj, kk.x, acc[i][4 * cc + 0]);
              acc[i][4 * cc + 1] = fmaf(dj, kk.y, acc[i][4 * cc + 1]);
              acc[i][4 * cc + 2] = fmaf(dj, kk.z, acc[i][4 * cc + 2]);
              acc[i][4 * cc + 3] = fmaf(dj, kk.w, acc[i][4 * cc + 3]);
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
    if (qpos[i] >= S) continue;
    const long long row = (bkv * G + r / bq) * S + qpos[i];
    T* o = dq + row * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (c < D4) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[4 * c + e] = from_f32<T>(acc[i][4 * cc + e] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dk, dv: one block per (key tile, bkv row)
// ---------------------------------------------------------------------------

// acc[i] += sum_j w[i][j] x[j] over the kTile rows of x (shared, stride ld)
// for the warp's keys i, weights w in the warp's shared row; lane t holds
// d = 4 (t + 32 cc) .. + 3.
template <int NC>
__device__ __forceinline__ void accumulate(float (&acc)[kKeysPerWarp][4 * NC],
                                           const float* w, const float* x,
                                           int ld, int D4, int lane) {
#pragma unroll
  for (int j4 = 0; j4 < kTile / 4; ++j4) {
    float4 ww[kKeysPerWarp];
#pragma unroll
    for (int i = 0; i < kKeysPerWarp; ++i)
      ww[i] = load4(w + i * kTile + 4 * j4);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* xr = x + (4 * j4 + jj) * ld;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = lane + 32 * cc;
        if (c < D4) {
          const float4 xx = load4(xr + 4 * c);
#pragma unroll
          for (int i = 0; i < kKeysPerWarp; ++i) {
            const float wj = comp(ww[i], jj);
            acc[i][4 * cc + 0] = fmaf(wj, xx.x, acc[i][4 * cc + 0]);
            acc[i][4 * cc + 1] = fmaf(wj, xx.y, acc[i][4 * cc + 1]);
            acc[i][4 * cc + 2] = fmaf(wj, xx.z, acc[i][4 * cc + 2]);
            acc[i][4 * cc + 3] = fmaf(wj, xx.w, acc[i][4 * cc + 3]);
          }
        }
      }
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32, NC == 1 ? 2 : 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int G, int S, int Sk,
              int D, int causal, int has_window, int window, int prefix,
              float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* ks = smem;                     // kKeys x ld
  float* vs = ks + kKeys * ld;          // kKeys x ld
  float* qs = vs + kKeys * ld;          // kTile x ld, q / sqrt(D)
  float* dos = qs + kTile * ld;         // kTile x ld
  float* ps = dos + kTile * ld;         // kWarps x kKeysPerWarp x kTile
  float* ls = ps + kKeys * kTile;       // kTile: lse of the query tile
  float* dls = ls + kTile;              // kTile: delta of the query tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bkv = blockIdx.y;
  const int k0 = blockIdx.x * kKeys;
  const int D4 = D >> 2;

  auto k_row = [&](const T* base, int j) -> const T* {
    return k0 + j < Sk ? base + (bkv * Sk + k0 + j) * D : nullptr;
  };
  stage<T>(ks, kKeys, D, ld, 1.f, [&](int j) { return k_row(k, j); });
  stage<T>(vs, kKeys, D, ld, 1.f, [&](int j) { return k_row(v, j); });

  const int key0 = warp * kKeysPerWarp;
  float acc_k[kKeysPerWarp][4 * NC], acc_v[kKeysPerWarp][4 * NC];
#pragma unroll
  for (int i = 0; i < kKeysPerWarp; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  }

  // under a causal mask no query before the block's first key sees it,
  // unless the bidirectional prefix reaches into the block
  const int qlo = (causal && k0 >= prefix) ? k0 : 0;
  float* pw = ps + warp * kKeysPerWarp * kTile;
  for (int g = 0; g < G; ++g) {
    const long long hrow = (bkv * G + g) * S;
    for (int s0 = qlo; s0 < S; s0 += kTile) {
      __syncthreads();  // the previous query tile is consumed
      auto q_row = [&](const T* base, int j) -> const T* {
        return s0 + j < S ? base + (hrow + s0 + j) * D : nullptr;
      };
      stage<T>(qs, kTile, D, ld, scale, [&](int j) { return q_row(q, j); });
      stage<T>(dos, kTile, D, ld, 1.f, [&](int j) { return q_row(dout, j); });
      if (threadIdx.x < kTile) {
        const bool in = s0 + threadIdx.x < S;
        ls[threadIdx.x] = in ? lse[hrow + s0 + threadIdx.x] : 0.f;
        dls[threadIdx.x] = in ? delta[hrow + s0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // s and dp of query s0 + lane against the warp's 4 keys
      float s[kKeysPerWarp], dp[kKeysPerWarp];
#pragma unroll
      for (int i = 0; i < kKeysPerWarp; ++i) s[i] = dp[i] = 0.f;
      const float* qrow = qs + lane * ld;
      const float* drow = dos + lane * ld;
      for (int c = 0; c < D4; ++c) {
        const float4 qq = load4(qrow + 4 * c);
        const float4 gg = load4(drow + 4 * c);
#pragma unroll
        for (int i = 0; i < kKeysPerWarp; ++i) {
          s[i] = dot4(qq, load4(ks + (key0 + i) * ld + 4 * c), s[i]);
          dp[i] = dot4(gg, load4(vs + (key0 + i) * ld + 4 * c), dp[i]);
        }
      }
      const int qp = s0 + lane;
      const float lse_j = ls[lane], delta_j = dls[lane];
      float ds[kKeysPerWarp];
#pragma unroll
      for (int i = 0; i < kKeysPerWarp; ++i) {
        const bool vis = visible(qp, k0 + key0 + i, S, Sk, causal,
                                 has_window, window, prefix);
        const float p = prob(vis ? s[i] : kNegInf, lse_j);
        ds[i] = p * (dp[i] - delta_j);
        pw[i * kTile + lane] = p;
      }
      __syncwarp();
      accumulate<NC>(acc_v, pw, dos, ld, D4, lane);  // dv += p^T dout
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kKeysPerWarp; ++i) pw[i * kTile + lane] = ds[i];
      __syncwarp();
      accumulate<NC>(acc_k, pw, qs, ld, D4, lane);   // dk += ds^T q
      __syncwarp();
    }
  }

#pragma unroll
  for (int i = 0; i < kKeysPerWarp; ++i) {
    const int kp = k0 + key0 + i;
    if (kp >= Sk) continue;
    T* ok = dk + (bkv * Sk + kp) * D;
    T* ov = dv + (bkv * Sk + kp) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (c < D4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ok[4 * c + e] = from_f32<T>(acc_k[i][4 * cc + e]);
          ov[4 * c + e] = from_f32<T>(acc_v[i][4 * cc + e]);
        }
      }
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* lse, const void* dout, void* delta, void* dq, void* dk,
           void* dv, int BKV, int G, int S, int Sk, int D, int causal,
           int has_window, int window, int prefix, float scale,
           cudaStream_t st) {
  const long long rows = (long long)BKV * G * S;
  const int ld = D + 4;
  if (rows > 0) {
    flash_bwd_delta<T><<<(unsigned)((rows + kWarps - 1) / kWarps),
                         kWarps * 32, 0, st>>>(
        (const T*)out, (const T*)dout, (float*)delta, rows, D);
    const int err = (int)cudaGetLastError();
    if (err) return err;

    const int bq = kRows / G;
    const size_t smem = (size_t)((2 * kRows + 2 * kTile) * ld +
                                 kWarps * kRowsPerWarp * kTile) *
                        sizeof(float);
    int e = set_smem(flash_bwd_dq<T, NC>, smem);
    if (e) return e;
    const dim3 grid((unsigned)((S + bq - 1) / bq), (unsigned)BKV);
    flash_bwd_dq<T, NC><<<grid, kWarps * 32, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (T*)dq, G, S, Sk, D, bq,
        causal, has_window, window, prefix, scale);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  if (Sk > 0) {
    const size_t smem =
        (size_t)((2 * kKeys + 2 * kTile) * ld + kKeys * kTile + 2 * kTile) *
        sizeof(float);
    int e = set_smem(flash_bwd_dkv<T, NC>, smem);
    if (e) return e;
    const dim3 grid((unsigned)((Sk + kKeys - 1) / kKeys), (unsigned)BKV);
    flash_bwd_dkv<T, NC><<<grid, kWarps * 32, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, G, S, Sk, D,
        causal, has_window, window, prefix, scale);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  return 0;
}

template <typename T>
int dispatch_nc(const void* q, const void* k, const void* v, const void* out,
                const void* lse, const void* dout, void* delta, void* dq,
                void* dk, void* dv, int BKV, int G, int S, int Sk, int D,
                int causal, int has_window, int window, int prefix,
                float scale, cudaStream_t st) {
  if (D <= 128)
    return launch<T, 1>(q, k, v, out, lse, dout, delta, dq, dk, dv, BKV, G,
                        S, Sk, D, causal, has_window, window, prefix, scale,
                        st);
  return launch<T, 2>(q, k, v, out, lse, dout, delta, dq, dk, dv, BKV, G, S,
                      Sk, D, causal, has_window, window, prefix, scale, st);
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16 (q, k, v, out, dout, dq, dk and dv alike).
// All tensors contiguous; D % 4 == 0, D <= 256, 1 <= G <= 64,
// BKV <= 65535 (checked by the Python wrapper); delta is (BKV, G, S) f32
// scratch.  has_window = 0 ignores window.  Returns the first failing
// cudaError_t, else 0.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int dtype, int BKV, int G, int S, int Sk, int D, int causal,
    int has_window, int window, int prefix, float scale, void* stream) {
  if (BKV == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch_nc<float>(q, k, v, out, lse, dout, delta, dq, dk, dv,
                                BKV, G, S, Sk, D, causal, has_window, window,
                                prefix, scale, st);
    case 1:
      return dispatch_nc<__nv_bfloat16>(q, k, v, out, lse, dout, delta, dq,
                                        dk, dv, BKV, G, S, Sk, D, causal,
                                        has_window, window, prefix, scale,
                                        st);
    case 2:
      return dispatch_nc<__half>(q, k, v, out, lse, dout, delta, dq, dk, dv,
                                 BKV, G, S, Sk, D, causal, has_window, window,
                                 prefix, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
