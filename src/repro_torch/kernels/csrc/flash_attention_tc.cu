// Flash-attention forward on the tensor cores (B7, Hopper variant), CUDA
// C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd_grouped (body _kernel) for bf16 and f16 inputs with
// head dim D in {64, 128, 256}; flash_attention.cu serves the rest (f32,
// other D).  GQA-grouped layout: q (BKV, G, S, D), k and v (BKV, Sk, D), one
// type; out (BKV, G, S, D) in that type, lse (BKV, G, S) f32.  Masks and
// guards as flash_attention.cu: masked scores are NEG_INF = -FLT_MAX, p = 0
// there, the correction is 0 while the row max is NEG_INF,
// out = acc / max(l, 1e-30) (0 on a fully masked row), lse = log sum exp.
// Any S and Sk: ragged tails are masked.
//
// Arithmetic: S = Q K^T and O += P V run on the tensor cores (wgmma, bf16 or
// f16 operands, f32 accumulators); the softmax is f32 in registers.  P is
// rounded to the input type as wgmma's A operand, as the reference's
// jnp.dot of f32 operands feeds bf16 to the TPU's matrix unit.  The softmax
// runs in base 2 with an integer running max M = ceil(max s log2 e), so the
// rescaling of earlier tiles, 2^(M_old - M_new), is exact and P is rounded
// exactly as bf16(2^(s log2 e - M_final)): the rounding does not depend on
// the tiling, and kernels.ref.flash_attention_fwd(p_dtype=...) repeats it.
//
// Bound on this card: operations.  At the prefill shape (8 x 8 heads,
// S = 4096, D = 128, causal) the work is 4 D BKV G S (S + 1) / 2 = 2.75e11
// FLOP over 33.6 MB; in bf16 on the tensor cores (989 TFLOP/s) 0.28 ms.
//
// Design: one block of three warpgroups per (query tile, bkv row), 128
// query rows: one producer warpgroup (registers given away by setmaxnreg)
// whose one thread loads by TMA the Q tile once and the K and V tiles of 64
// keys into a two-stage ring guarded by mbarriers (full: bytes arrived;
// empty: both consumers done), and two consumer warpgroups of 64 query
// rows each, which run S = Q K^T by wgmma (both operands from shared
// memory), the online softmax on the accumulator fragment (a row's max and
// sum reduced over the four threads that hold it), and P V by wgmma with P
// from registers and V MN-major (the transpose bit).  GQA packing:
// the 128 rows are 128 / G positions of all G heads that share the kv row
// (one 4-D TMA box), so a K/V tile is read once for all G heads rather
// than once a head, and the causal diagonal crosses only 128 / G positions
// of a block; whole tiles above it are skipped (unless the prefix reaches
// them).  The grid runs the longest query tiles (the last ones
// under a causal mask) first.  No atomics: results repeat bit for bit.
#include "flash_tc.cuh"

namespace {

using namespace flash_tc;

constexpr int kRows = 128;   // query rows a block: two consumers x 64
constexpr int kBN = 64;      // keys a tile
constexpr int kStages = 2;
constexpr int kThreads = 384;

template <int D>
struct Layout {
  static constexpr int kChunks = D / 64;
  static constexpr int kQChunk = kRows * 128;  // bytes of a Q chunk
  static constexpr int kKChunk = kBN * 128;    // bytes of a K or V chunk
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kChunks * kQChunk;
  static constexpr int kV = kK + kStages * kChunks * kKChunk;
  static constexpr int kBars = kV + kStages * kChunks * kKChunk;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, T* __restrict__ out,
             float* __restrict__ lse, int BKV, int G, int S, int Sk, int bq,
             Mask mask, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int nq = (S + bq - 1) / bq;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BKV;  // longest first
  const int bkv = static_cast<int>(blockIdx.x) % BKV;
  const int q0 = qt * bq;
  const int rows = bq * G;
  int kend = Sk;
  if (mask.causal) kend = min(Sk, max(min(q0 + bq, S), mask.prefix));
  const int ntiles = (kend + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
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
      mbar_expect_tx(q_full, L::kChunks * 64 * rows * 2);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load_4d(sm + L::kQ + c * L::kQChunk, &qmap, q_full, 64 * c, q0, 0,
                    bkv);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::kChunks * L::kKChunk);
        for (int c = 0; c < L::kChunks; ++c) {
          const int off = (s * L::kChunks + c) * L::kKChunk;
          tma_load_3d(sm + L::kK + off, &kmap, &full[s], 64 * c, t * kBN, bkv);
          tma_load_3d(sm + L::kV + off, &vmap, &full[s], 64 * c, t * kBN, bkv);
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
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      pos[h] = q0 + r % bq;
      valid[h] = r < rows && pos[h] < S;
    }
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    const uint8_t* qtile = sm + L::kQ;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      const uint8_t* ktile = sm + L::kK + s * L::kChunks * L::kKChunk;
      const uint8_t* vtile = sm + L::kV + s * L::kChunks * L::kKChunk;

      float sc[kBN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBN, T>(sc,
                         kmajor_desc(qtile, L::kQChunk, 64 * cons * 128, kk),
                         kmajor_desc(ktile, L::kKChunk, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scores in base-2 units, masked; the tile's row max
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int h = frag_half(i);
        const int kp = t * kBN + frag_col(i, lane);
        const bool vis = valid[h] && kp < Sk && mask.sees(pos[h], kp);
        sc[i] = vis ? sc[i] * scale_log2 : kNegInf;
        mx[h] = fmaxf(mx[h], sc[i]);
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        // integer running max: rescaling by 2^(m - m_new) is exact
        const float m_new =
            mx[h] > kNegInf * 0.5f ? fmaxf(m[h], ceilf(mx[h])) : m[h];
        corr[h] = m[h] <= kNegInf * 0.5f
                      ? 0.f
                      : ldexpf(1.f, static_cast<int>(m[h] - m_new));
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int h = frag_half(i);
        sc[i] = sc[i] <= kNegInf * 0.5f ? 0.f : exp2f(sc[i] - m[h]);
        rs[h] += sc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(rs[h]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[frag_half(i)];

      // O += P V, P rounded to T in the A fragment layout
      uint32_t pa[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D, T>(o, pa[kk], mnmajor_desc(vtile, L::kKChunk, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // out = acc / max(l, 1e-30); lse = m ln 2 + log(max(l, 1e-30))
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
      const int g = (row0 + 8 * h) / bq;
      const long long row = (static_cast<long long>(bkv) * G + g) * S + pos[h];
      const float den = fmaxf(l[h], 1e-30f);
      T* orow = out + row * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack2<T>(o[4 * n + 2 * h] / den, o[4 * n + 2 * h + 1] / den);
      }
      if ((lane & 3) == 0)
        lse[row] = (m[h] <= kNegInf * 0.5f ? kNegInf : m[h] * kLn2) +
                   logf(den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int f16, int BKV, int G, int S, int Sk, Mask mask, float scale,
           cudaStream_t st) {
  const int bq = kRows / G;
  CUtensorMap qmap, kmap, vmap;
  int err = map_q(&qmap, f16, q, BKV, G, S, D, bq, G);
  if (!err) err = map_kv(&kmap, f16, k, BKV, Sk, D, kBN);
  if (!err) err = map_kv(&vmap, f16, v, BKV, Sk, D, kBN);
  if (err) return err;
  const int smem = Layout<D>::kBytes + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nq = (S + bq - 1) / bq;
  flash_fwd_tc<T, D><<<nq * BKV, kThreads, smem, st>>>(
      qmap, kmap, vmap, (T*)out, (float*)lse, BKV, G, S, Sk, bq, mask,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               void* lse, int f16, int BKV, int G, int S, int Sk, int D,
               Mask mask, float scale, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, f16, BKV, G, S, Sk, mask, scale,
                           st);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, f16, BKV, G, S, Sk, mask,
                            scale, st);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, f16, BKV, G, S, Sk, mask,
                            scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 1 bf16, 2 f16 (q, k, v and out alike).  All tensors contiguous and
// 16-byte aligned; D in {64, 128, 256}; 1 <= G <= 64 (checked by the Python
// wrapper).  has_window = 0 ignores window.  Returns the first failing
// cudaError_t, flash_tc::kErrNoDriver or kErrTensorMap, else 0.
extern "C" int repro_flash_attention_fwd_tc(const void* q, const void* k,
                                            const void* v, void* out,
                                            void* lse, int dtype, int BKV,
                                            int G, int S, int Sk, int D,
                                            int causal, int has_window,
                                            int window, int prefix,
                                            float scale, void* stream) {
  if (BKV == 0 || S == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const Mask mask{causal, has_window, window, prefix};
  switch (dtype) {
    case 1:
      return dispatch_d<__nv_bfloat16>(q, k, v, out, lse, 0, BKV, G, S, Sk, D,
                                       mask, scale, st);
    case 2:
      return dispatch_d<__half>(q, k, v, out, lse, 1, BKV, G, S, Sk, D, mask,
                                scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
