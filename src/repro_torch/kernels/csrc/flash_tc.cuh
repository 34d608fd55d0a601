// Building blocks of the tensor-core flash-attention kernels (B7 forward in
// flash_attention_tc.cu, B8 backward in flash_attention_bwd_tc.cu), CUDA
// C++ for sm_90a: mbarriers, TMA tile loads, wgmma shared-memory matrix
// descriptors for the 128-byte swizzle, register rebalancing, the
// accumulator fragment's rows and columns, the attention masks, and the
// host side of the tensor maps.
//
// Tile layout in shared memory: a tile of R rows of a (.., D) bf16/f16
// tensor is stored as D / 64 chunks of R x 64 values; each chunk row is
// 128 bytes, swizzled by TMA (CU_TENSOR_MAP_SWIZZLE_128B), chunks 1024-byte
// aligned.  That is wgmma's canonical 128-byte-swizzle layout both ways:
//   K-major (the reduction runs along the row, as for A = Q and B = K in
//   S = Q K^T): 8-row groups 1024 bytes apart (SBO), a 16-deep slice 32
//   bytes further along the row;
//   MN-major (the reduction runs down the rows, as for B = V in O = P V):
//   16-row slices 2048 bytes apart, 8-row groups 1024 bytes apart (SBO),
//   64-column chunks one chunk apart (LBO).
#pragma once
#include <cuda.h>  // CUtensorMap and its enums only; the driver is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <float.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace flash_tc {

constexpr float kNegInf = -FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// types
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t u) {
  return __half22float2(*reinterpret_cast<__half2*>(&u));
}

// ---------------------------------------------------------------------------
// shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Barriers initialised by one thread, made visible to the whole block.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The first 1024-byte-aligned address of the dynamic shared memory (the
// 128-byte swizzle repeats every 1024 bytes; the launch asks for 1 KB more).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t off = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return raw + off;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Matrix descriptor of a tile in the 128-byte-swizzle layout (see the top).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A K-major operand: 16-deep slice kk of a tile whose chunks are
// `chunk_bytes` apart, starting `row_off` bytes into each chunk.
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile,
                                                int chunk_bytes, int row_off,
                                                int kk) {
  return sw128_desc(tile + (kk >> 2) * chunk_bytes + row_off + (kk & 3) * 32,
                    16, 1024);
}

// An MN-major B operand: rows 16 kk .. 16 kk + 15 of a tile whose 64-column
// chunks are `chunk_bytes` apart.
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile,
                                                 int chunk_bytes, int kk) {
  return sw128_desc(tile + kk * 2048, chunk_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma issue and wait.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Named barrier over `count` threads (id 0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The accumulator fragment of wgmma m64nN: thread t of the warpgroup holds
// d[i] at row 16 (t / 32) + (t % 32) / 4 + 8 frag_half(i) and column
// frag_col(i, t).
__device__ __forceinline__ constexpr int frag_half(int i) {
  return (i >> 1) & 1;
}
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// Row reductions over the four threads that hold a fragment row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Does query qp see key kp?  (qp < S and kp < Sk are the caller's.)
struct Mask {
  int causal, has_window, window, prefix;
  __device__ __forceinline__ bool sees(int qp, int kp) const {
    if (!causal) return true;
    bool c = kp <= qp;
    if (has_window) c = c && kp > qp - window;
    return c || kp < prefix;
  }
};

// ---------------------------------------------------------------------------
// host: tensor maps through the driver's cuTensorMapEncodeTiled, found in
// the libcuda that the CUDA runtime has loaded
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// Error codes of the C entry points beyond cudaError_t's.
constexpr int kErrNoDriver = 10001;   // cuTensorMapEncodeTiled not found
constexpr int kErrTensorMap = 10002;  // the driver refused a tensor map

// A map over a contiguous row-major tensor of 2-byte values, dims innermost
// first (dims[0] = D), with the box {64, box[1], ...} and the 128-byte
// swizzle; out-of-bounds elements read as zero.
inline int make_map(CUtensorMap* map, int f16, const void* ptr, int rank,
                    const uint64_t* dims, const uint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoDriver;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = stride;
    stride *= dims[i];
  }
  const CUresult r =
      fn(map,
         f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         rank, const_cast<void*>(ptr), gdim, gstride, bdim, estride,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// (BKV, G, S, D) with the box {64, rows, heads, 1}
inline int map_q(CUtensorMap* map, int f16, const void* ptr, int BKV, int G,
                 int S, int D, int rows, int heads) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)S, (uint64_t)G,
                            (uint64_t)BKV};
  const uint32_t box[4] = {64u, (uint32_t)rows, (uint32_t)heads, 1u};
  return make_map(map, f16, ptr, 4, dims, box);
}

// (BKV, Sk, D) with the box {64, rows, 1}
inline int map_kv(CUtensorMap* map, int f16, const void* ptr, int BKV, int Sk,
                  int D, int rows) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)Sk, (uint64_t)BKV};
  const uint32_t box[3] = {64u, (uint32_t)rows, 1u};
  return make_map(map, f16, ptr, 3, dims, box);
}

}  // namespace flash_tc
