// Flash-attention backward on the tensor cores (B8, Hopper variant), CUDA
// C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention_bwd.py:
// flash_attention_bwd (bodies _dq_kernel and _dkv_kernel) for bf16 and f16
// inputs with head dim D in {64, 128, 256}; flash_attention_bwd.cu serves
// the rest (f32, other D).  GQA-grouped layout, as the forward (B7): q, out
// and dout (BKV, G, S, D), k and v (BKV, Sk, D), one type for all five; lse
// (BKV, G, S) f32 from the forward.  Writes dq (BKV, G, S, D), dk and dv
// (BKV, Sk, D) in that type, and delta (BKV, G, S) f32 scratch.  Masks and
// guards as flash_attention_bwd.cu: p = exp(s - lse) on visible keys, 0 on
// masked ones, so a fully masked row gives zero gradients.  Any S and Sk:
// ragged tails are masked.
//
// Arithmetic: every product runs on the tensor cores (wgmma, bf16 or f16
// operands, f32 accumulators).  p is rounded to the input type before
// P^T dO, and ds = p (dp - delta) (from the f32 p) before dS K and dS^T Q,
// as the reference's jnp.dot of f32 operands feeds bf16 to the TPU's
// matrix unit; kernels.ref.flash_attention_bwd(p_dtype=...) rounds at the
// same places.
//
// Bound on this card: operations.  At the training shape (2 x 2 kv heads of
// 8 query heads, S = 4096, D = 128, causal) the work is 5 products of 2 D
// FLOP per visible (q, k) pair, 3.44e11 FLOP; in bf16 on the tensor cores
// (989 TFLOP/s) 0.35 ms.  This design runs 7 products per visible pair (s
// and dp twice), as the TPU kernel's two passes do.
//
// Three launches on the caller's stream (four for D = 256), no atomics, so
// results repeat bit for bit:
//   1. delta = rowsum(dout * out), one warp per row.
//   2. dk/dv: one block of three warpgroups per (64-key tile, bkv row).  The
//      producer warpgroup loads K and V of the tile once by TMA, then walks
//      the G heads and, in each, the 32-query tiles that see the keys (from
//      the diagonal on under a causal mask, unless the prefix reaches the
//      keys): one thread loads the Q and dO tiles by TMA into a four-stage
//      ring, one warp copies the tile's lse and delta beside them.  The two
//      consumer warpgroups take the tiles in turn; each computes, with the
//      keys as wgmma's 64 rows, S^T = K Q^T and dP^T = V dO^T (operands
//      from shared memory), P^T = exp(S^T - lse) and dS^T = P^T (dP^T -
//      delta) in registers, then dV += P^T dO and dK += dS^T Q with P^T and
//      dS^T as register A operands and dO, Q MN-major.  dK and dV stay in
//      registers over the whole walk (the walk over heads is GQA's sum);
//      at the end the second consumer hands its sums to the first through
//      shared memory, in a fixed order.  For D = 256 the registers hold one
//      of dK and dV, so the kernel runs twice, once for each.
//   3. dq: one block per (query tile, bkv row), 128 query rows packed as in
//      the forward (128 / G positions of the G heads): Q and dO loaded once
//      by TMA, K and V tiles by TMA into a two-stage ring; each consumer
//      warpgroup (64 rows) computes S = Q K^T and dP = dO V^T, P and dS in
//      registers, then dQ += dS K with K MN-major; dq = acc / sqrt(D).
//      The longest query tiles run first.
#include "flash_tc.cuh"

namespace {

using namespace flash_tc;

constexpr int kThreads = 384;  // a producer and two consumer warpgroups

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dout * out), one warp per row of (BKV * G * S, D)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
          float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint32_t* o = reinterpret_cast<const uint32_t*>(out + row * D);
  const uint32_t* g = reinterpret_cast<const uint32_t*>(dout + row * D);
  float acc = 0.f;
  for (int c = lane; c < D / 2; c += 32) {
    const float2 a = unpack2<T>(o[c]), b = unpack2<T>(g[c]);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
#pragma unroll
  for (int s = 16; s; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

// Store a 64-row accumulator fragment (rows row0, row0 + 8 of the thread)
// times `mul` as T; rows at or past `limit` are dropped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, const float (&acc)[D / 2],
                                           int row0, int limit, int lane,
                                           float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= limit) continue;
    T* dst = base + static_cast<long long>(r) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * (lane & 3)) = pack2<T>(
          acc[4 * n + 2 * h] * mul, acc[4 * n + 2 * h + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// 2. dk/dv: one block per (64-key tile, bkv row)
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;
constexpr int kKvStages = 4;
enum { kBoth = 0, kDvOnly = 1, kDkOnly = 2 };

template <int D>
struct KvLayout {
  static constexpr int kChunks = D / 64;
  static constexpr int kBq = D == 64 ? 64 : 32;    // queries a tile
  static constexpr int kKChunk = kKeys * 128;
  static constexpr int kQChunk = kBq * 128;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kChunks * kKChunk;
  static constexpr int kStage = 2 * kChunks * kQChunk + 2 * kBq * 4;
  static constexpr int kRing = kV + kChunks * kKChunk;  // Q, dO, lse, delta
  static constexpr int kBars = kRing + kKvStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kKvStages);
};

template <typename T, int D, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap domap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int BKV, int G, int S, int Sk, Mask mask,
                  float scale, float scale_log2) {
  using L = KvLayout<D>;
  constexpr int kBq = L::kBq;
  constexpr bool kDv = kMode != kDkOnly, kDk = kMode != kDvOnly;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kKvStages;

  const int kt = static_cast<int>(blockIdx.x) / BKV;  // longest first
  const int bkv = static_cast<int>(blockIdx.x) % BKV;
  const int k0 = kt * kKeys;
  const int qt0 = (mask.causal && k0 >= mask.prefix) ? k0 / kBq : 0;
  const int nqt = max(0, (S + kBq - 1) / kBq - qt0);
  const int ntiles = G * nqt;  // (head, query tile) in head-major order

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&full[s], 2);   // the TMA thread and the lse/delta warp
      mbar_init(&empty[s], 4);  // the four warps of the tile's consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wg == 0) {
    // -- producer ---------------------------------------------------------
    regs_dec<40>();
    const int warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kChunks * L::kKChunk);
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load_3d(sm + L::kK + c * L::kKChunk, &kmap, kv_full, 64 * c, k0,
                    bkv);
        tma_load_3d(sm + L::kV + c * L::kKChunk, &vmap, kv_full, 64 * c, k0,
                    bkv);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kKvStages;
        const int g = t / nqt, qt = qt0 + t % nqt;
        mbar_wait(&empty[s], ((t / kKvStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::kChunks * L::kQChunk);
        uint8_t* st = sm + L::kRing + s * L::kStage;
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(st + c * L::kQChunk, &qmap, &full[s], 64 * c, qt * kBq,
                      g, bkv);
          tma_load_4d(st + (L::kChunks + c) * L::kQChunk, &domap, &full[s],
                      64 * c, qt * kBq, g, bkv);
        }
      }
    } else if (warp == 1) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kKvStages;
        const int g = t / nqt, qt = qt0 + t % nqt;
        mbar_wait(&empty[s], ((t / kKvStages) & 1) ^ 1);
        float* stat = reinterpret_cast<float*>(sm + L::kRing + s * L::kStage +
                                               2 * L::kChunks * L::kQChunk);
        const long long row = (static_cast<long long>(bkv) * G + g) * S;
        for (int j = lane; j < kBq; j += 32) {
          const int qp = qt * kBq + j;
          stat[j] = qp < S ? lse[row + qp] * kLog2e : 0.f;
          stat[kBq + j] = qp < S ? delta[row + qp] : 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
  } else {
    // -- consumers: the same 64 keys, alternate (head, query) tiles --------
    regs_inc<232>();
    const int cons = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int key0 = 16 * (tid >> 5) + (lane >> 2);  // + 8 for h = 1
    float acc_v[kDv ? D / 2 : 1], acc_k[kDk ? D / 2 : 1];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      if constexpr (kDv) acc_v[i] = 0.f;
      if constexpr (kDk) acc_k[i] = 0.f;
    }
    mbar_wait(kv_full, 0);
    const uint8_t* ktile = sm + L::kK;
    const uint8_t* vtile = sm + L::kV;
    for (int t = cons; t < ntiles; t += 2) {
      const int s = t % kKvStages;
      const int qt = qt0 + t % nqt;
      mbar_wait(&full[s], (t / kKvStages) & 1);
      const uint8_t* qtile = sm + L::kRing + s * L::kStage;
      const uint8_t* dotile = qtile + L::kChunks * L::kQChunk;
      const float* stat =
          reinterpret_cast<const float*>(dotile + L::kChunks * L::kQChunk);

      float st[kBq / 2], dpt[kBq / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBq, T>(st, kmajor_desc(ktile, L::kKChunk, 0, kk),
                         kmajor_desc(qtile, L::kQChunk, 0, kk), kk > 0);
      if constexpr (kDk) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kBq, T>(dpt, kmajor_desc(vtile, L::kKChunk, 0, kk),
                           kmajor_desc(dotile, L::kQChunk, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      if constexpr (kDk) fence_regs(dpt);

      // P^T and dS^T: rows are keys, columns queries
#pragma unroll
      for (int i = 0; i < kBq / 2; ++i) {
        const int kp = k0 + key0 + 8 * frag_half(i);
        const int j = frag_col(i, lane);
        const int qp = qt * kBq + j;
        const bool vis = qp < S && kp < Sk && mask.sees(qp, kp);
        const float p = vis ? exp2f(st[i] * scale_log2 - stat[j]) : 0.f;
        st[i] = p;
        if constexpr (kDk) dpt[i] = p * (dpt[i] - stat[kBq + j]);
      }
      uint32_t pa[kBq / 16][4], dsa[kBq / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBq / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (kDv)
            pa[kk][r] = pack2<T>(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          if constexpr (kDk)
            dsa[kk][r] = pack2<T>(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      if constexpr (kDv) fence_regs(acc_v);
      if constexpr (kDk) fence_regs(acc_k);
      wgmma_fence();
      if constexpr (kDv) {
#pragma unroll
        for (int kk = 0; kk < kBq / 16; ++kk)
          wgmma_rs<D, T>(acc_v, pa[kk], mnmajor_desc(dotile, L::kQChunk, kk),
                         1);
      }
      if constexpr (kDk) {
#pragma unroll
        for (int kk = 0; kk < kBq / 16; ++kk)
          wgmma_rs<D, T>(acc_k, dsa[kk], mnmajor_desc(qtile, L::kQChunk, kk),
                         1);
      }
      wgmma_commit();
      wgmma_wait_all();
      if constexpr (kDv) fence_regs(acc_v);
      if constexpr (kDk) fence_regs(acc_k);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // the second consumer's sums to the first, through the drained ring
    float* xfer = reinterpret_cast<float*>(sm + L::kRing);
    bar_sync(1, 256);  // every tile consumed: the ring is free
    if (cons == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        if constexpr (kDv) xfer[i * 128 + tid] = acc_v[i];
        if constexpr (kDk) xfer[(kDv ? D / 2 + i : i) * 128 + tid] = acc_k[i];
      }
    }
    bar_sync(1, 256);
    if (cons == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        if constexpr (kDv) acc_v[i] += xfer[i * 128 + tid];
        if constexpr (kDk) acc_k[i] += xfer[(kDv ? D / 2 + i : i) * 128 + tid];
      }
      const long long base = (static_cast<long long>(bkv) * Sk + k0) * D;
      if constexpr (kDv)
        store_rows<T, D>(dv + base, acc_v, key0, Sk - k0, lane, 1.f);
      if constexpr (kDk)
        store_rows<T, D>(dk + base, acc_k, key0, Sk - k0, lane, scale);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq: one block per (query tile, bkv row), rows packed as the forward's
// ---------------------------------------------------------------------------

constexpr int kRows = 128;
constexpr int kQStages = 2;

template <int D>
struct QLayout {
  static constexpr int kChunks = D / 64;
  static constexpr int kBk = D == 256 ? 32 : 64;  // keys a tile
  static constexpr int kQChunk = kRows * 128;
  static constexpr int kKChunk = kBk * 128;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kChunks * kQChunk;
  static constexpr int kK = kDo + kChunks * kQChunk;
  static constexpr int kV = kK + kQStages * kChunks * kKChunk;
  static constexpr int kBars = kV + kQStages * kChunks * kKChunk;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kQStages);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap domap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int BKV, int G, int S, int Sk, int bq,
                Mask mask, float scale, float scale_log2) {
  using L = QLayout<D>;
  constexpr int kBk = L::kBk;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kQStages;

  const int nq = (S + bq - 1) / bq;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BKV;  // longest first
  const int bkv = static_cast<int>(blockIdx.x) % BKV;
  const int q0 = qt * bq;
  const int rows = bq * G;
  int kend = Sk;
  if (mask.causal) kend = min(Sk, max(min(q0 + bq, S), mask.prefix));
  const int ntiles = (kend + kBk - 1) / kBk;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer ---------------------------------------------------------
    regs_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kChunks * 64 * rows * 2);
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load_4d(sm + L::kQ + c * L::kQChunk, &qmap, q_full, 64 * c, q0, 0,
                    bkv);
        tma_load_4d(sm + L::kDo + c * L::kQChunk, &domap, q_full, 64 * c, q0,
                    0, bkv);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kQStages;
        mbar_wait(&empty[s], ((t / kQStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::kChunks * L::kKChunk);
        for (int c = 0; c < L::kChunks; ++c) {
          const int off = (s * L::kChunks + c) * L::kKChunk;
          tma_load_3d(sm + L::kK + off, &kmap, &full[s], 64 * c, t * kBk, bkv);
          tma_load_3d(sm + L::kV + off, &vmap, &full[s], 64 * c, t * kBk, bkv);
        }
      }
    }
  } else {
    // -- consumers: 64 query rows each --------------------------------------
    regs_inc<232>();
    const int cons = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31;
    const int row0 = 64 * cons + 16 * (tid >> 5) + (lane >> 2);
    int pos[2];
    bool valid[2];
    float lse2[2], dlt[2];
    long long grow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      pos[h] = q0 + r % bq;
      valid[h] = r < rows && pos[h] < S;
      grow[h] = (static_cast<long long>(bkv) * G + r / bq) * S + pos[h];
      lse2[h] = valid[h] ? lse[grow[h]] * kLog2e : 0.f;
      dlt[h] = valid[h] ? delta[grow[h]] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    const uint8_t* qtile = sm + L::kQ;
    const uint8_t* dotile = sm + L::kDo;
    const int row_off = 64 * cons * 128;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kQStages;
      mbar_wait(&full[s], (t / kQStages) & 1);
      const uint8_t* ktile = sm + L::kK + s * L::kChunks * L::kKChunk;
      const uint8_t* vtile = sm + L::kV + s * L::kChunks * L::kKChunk;

      float sc[kBk / 2], dp[kBk / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBk, T>(sc, kmajor_desc(qtile, L::kQChunk, row_off, kk),
                         kmajor_desc(ktile, L::kKChunk, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBk, T>(dp, kmajor_desc(dotile, L::kQChunk, row_off, kk),
                         kmajor_desc(vtile, L::kKChunk, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      uint32_t dsa[kBk / 16][4];
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) {
        const int h = frag_half(i);
        const int kp = t * kBk + frag_col(i, lane);
        const bool vis = valid[h] && kp < Sk && mask.sees(pos[h], kp);
        const float p = vis ? exp2f(sc[i] * scale_log2 - lse2[h]) : 0.f;
        dp[i] = p * (dp[i] - dlt[h]);
      }
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dsa[kk][r] = pack2<T>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk)
        wgmma_rs<D, T>(acc, dsa[kk], mnmajor_desc(ktile, L::kKChunk, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
      T* dst = dq + grow[h] * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * (lane & 3)) = pack2<T>(
            acc[4 * n + 2 * h] * scale, acc[4 * n + 2 * h + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D, int kMode>
int launch_dkdv(const CUtensorMap& qm, const CUtensorMap& dom,
                const CUtensorMap& km, const CUtensorMap& vm, const float* lse,
                const float* delta, void* dk, void* dv, int BKV, int G, int S,
                int Sk, Mask mask, float scale, cudaStream_t st) {
  const int smem = KvLayout<D>::kBytes + 1024;
  int err = set_smem(flash_bwd_dkdv_tc<T, D, kMode>, smem);
  if (err) return err;
  const int nkt = (Sk + kKeys - 1) / kKeys;
  flash_bwd_dkdv_tc<T, D, kMode><<<nkt * BKV, kThreads, smem, st>>>(
      qm, dom, km, vm, lse, delta, (T*)dk, (T*)dv, BKV, G, S, Sk, mask, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const float* lse, const void* dout, float* delta, void* dq,
           void* dk, void* dv, int f16, int BKV, int G, int S, int Sk,
           Mask mask, float scale, cudaStream_t st) {
  const long long rows = (long long)BKV * G * S;
  bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const T*)out, (const T*)dout, delta, rows, D);
  int err = (int)cudaGetLastError();
  if (err) return err;

  // dk/dv: Q and dO in tiles of one head, K and V in 64-key tiles
  CUtensorMap qm, dom, km, vm;
  constexpr int bq_kv = KvLayout<D>::kBq;
  err = map_q(&qm, f16, q, BKV, G, S, D, bq_kv, 1);
  if (!err) err = map_q(&dom, f16, dout, BKV, G, S, D, bq_kv, 1);
  if (!err) err = map_kv(&km, f16, k, BKV, Sk, D, kKeys);
  if (!err) err = map_kv(&vm, f16, v, BKV, Sk, D, kKeys);
  if (err) return err;
  if constexpr (D == 256) {
    err = launch_dkdv<T, D, kDvOnly>(qm, dom, km, vm, lse, delta, dk, dv, BKV,
                                     G, S, Sk, mask, scale, st);
    if (!err)
      err = launch_dkdv<T, D, kDkOnly>(qm, dom, km, vm, lse, delta, dk, dv,
                                       BKV, G, S, Sk, mask, scale, st);
  } else {
    err = launch_dkdv<T, D, kBoth>(qm, dom, km, vm, lse, delta, dk, dv, BKV,
                                   G, S, Sk, mask, scale, st);
  }
  if (err) return err;

  // dq: Q and dO packed as the forward's rows, K and V in key tiles
  const int bq = kRows / G;
  constexpr int bk = QLayout<D>::kBk;
  err = map_q(&qm, f16, q, BKV, G, S, D, bq, G);
  if (!err) err = map_q(&dom, f16, dout, BKV, G, S, D, bq, G);
  if (!err) err = map_kv(&km, f16, k, BKV, Sk, D, bk);
  if (!err) err = map_kv(&vm, f16, v, BKV, Sk, D, bk);
  if (err) return err;
  const int smem = QLayout<D>::kBytes + 1024;
  err = set_smem(flash_bwd_dq_tc<T, D>, smem);
  if (err) return err;
  const int nq = (S + bq - 1) / bq;
  flash_bwd_dq_tc<T, D><<<nq * BKV, kThreads, smem, st>>>(
      qm, dom, km, vm, lse, delta, (T*)dq, BKV, G, S, Sk, bq, mask, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* out,
               const float* lse, const void* dout, float* delta, void* dq,
               void* dk, void* dv, int f16, int BKV, int G, int S, int Sk,
               int D, Mask mask, float scale, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, dout, delta, dq, dk, dv, f16,
                           BKV, G, S, Sk, mask, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, dout, delta, dq, dk, dv, f16,
                            BKV, G, S, Sk, mask, scale, st);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, dout, delta, dq, dk, dv, f16,
                            BKV, G, S, Sk, mask, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 1 bf16, 2 f16 (q, k, v, out, dout, dq, dk, dv alike).  All tensors
// contiguous and 16-byte aligned; S, Sk > 0; D in {64, 128, 256};
// 1 <= G <= 64 (checked by the Python wrapper).  has_window = 0 ignores
// window.  Returns the first failing cudaError_t, flash_tc::kErrNoDriver or
// kErrTensorMap, else 0.
extern "C" int repro_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int dtype, int BKV, int G, int S, int Sk, int D, int causal,
    int has_window, int window, int prefix, float scale, void* stream) {
  if (BKV == 0 || S == 0 || Sk == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const Mask mask{causal, has_window, window, prefix};
  switch (dtype) {
    case 1:
      return dispatch_d<__nv_bfloat16>(q, k, v, out, (const float*)lse, dout,
                                       (float*)delta, dq, dk, dv, 0, BKV, G, S,
                                       Sk, D, mask, scale, st);
    case 2:
      return dispatch_d<__half>(q, k, v, out, (const float*)lse, dout,
                                (float*)delta, dq, dk, dv, 1, BKV, G, S, Sk, D,
                                mask, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
