#!/usr/bin/env python3
"""Write ``src/repro_torch/kernels/csrc/wgmma.cuh``: the inline-PTX
wrappers of the Hopper ``wgmma`` shapes that the tensor-core attention
kernels issue.  Each shape lists its accumulator registers one by one, so
the wrappers are generated rather than written out by hand.

    python3 tools/gen_wgmma.py
"""
import pathlib

OUT = (pathlib.Path(__file__).resolve().parents[1]
       / "src/repro_torch/kernels/csrc/wgmma.cuh")
TYPES = {"__nv_bfloat16": "bf16", "__half": "f16"}
SS_N = (32, 64)          # S = A B^T: both operands K-major in shared memory
RS_N = (64, 128, 256)    # O += P V: A in registers, B MN-major (transposed)


def regs(n: int) -> tuple:
    outs = ", ".join(f"%{i}" for i in range(n // 2))
    cons = ", ".join(f'"+f"(d[{i}])' for i in range(n // 2))
    return outs, cons


def ss(ctype: str, ptx: str, n: int) -> str:
    outs, cons = regs(n)
    k = n // 2
    return f"""template <>
__device__ __forceinline__ void wgmma_ss<{n}, {ctype}>(float (&d)[{k}],
                                                     uint64_t da,
                                                     uint64_t db,
                                                     int accumulate) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{k + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
      "{{{outs}}}, %{k}, %{k + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {cons}
      : "l"(da), "l"(db), "r"(accumulate));
}}
"""


def rs(ctype: str, ptx: str, n: int) -> str:
    outs, cons = regs(n)
    k = n // 2
    return f"""template <>
__device__ __forceinline__ void wgmma_rs<{n}, {ctype}>(float (&d)[{k}],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db,
                                                     int accumulate) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{k + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
      "{{{outs}}}, {{%{k}, %{k + 1}, %{k + 2}, %{k + 3}}}, %{k + 4}, p, 1, 1, "
      "1;\\n}}\\n"
      : {cons}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}}
"""


def main():
    parts = [f"""// Generated by tools/gen_wgmma.py: do not edit by hand.
//
// Hopper warpgroup matrix multiply-accumulate (wgmma, sm_90a) with f32
// accumulators, 64 rows (M) a warpgroup, depth 16 (K), for bf16 and f16
// operands.  The accumulator d holds N / 2 floats a thread in wgmma's
// fragment layout.  `accumulate` = 0 overwrites d.
//   wgmma_ss<N, T>: d (64 x N) (+)= A B^T with A (64 x 16) and B (N x 16)
//     both K-major in shared memory, given by their matrix descriptors
//     (N = {", ".join(map(str, SS_N))}).
//   wgmma_rs<N, T>: d (64 x N) (+)= A B with A (64 x 16) in registers
//     (four 32-bit registers of two values each, in the layout of the
//     accumulator fragment) and B (16 x N) MN-major in shared memory
//     (the transpose bit set) (N = {", ".join(map(str, RS_N))}).
// The caller brackets them with wgmma_fence / wgmma_commit / wgmma_wait.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate);
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate);
"""]
    for ctype, ptx in TYPES.items():
        parts += [ss(ctype, ptx, n) for n in SS_N]
        parts += [rs(ctype, ptx, n) for n in RS_N]
    OUT.write_text("\n".join(parts))


if __name__ == "__main__":
    main()
