#!/usr/bin/env python3
"""Planted-fault control for the full-width logit checks of chip_smoke.py.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    python3 tools/logit_fault_control.py

``chip_smoke.py`` holds qwen2.5-3b's logits to ``LOGIT_RTOL`` x the step's
largest |logit| against the plain path (its checks (b), (c) and (d)), and
the int8 cache to rtol ``QUANT_RTOL``, atol ``QUANT_ATOL`` of the bf16
cache.  This script measures whether those limits can see a faulty kernel.
It compiles copies of B7's two CUDA variants, ``csrc/flash_attention.cu``
(f32 CUDA cores) and ``csrc/flash_attention_tc.cu`` (tensor cores, the
one the bf16 path takes), and of ``csrc/decode_attention.cu`` (B9), each
with one planted fault made by a text substitution, into a temporary
directory under ``build/kernels/`` (the sources are not touched), swaps
each copy into its wrapper in turn and, at chip_smoke.py's shapes and
with its weights (seed 0, cast to bf16) and random tokens (seed 1):

- each B7 variant, sound and with each fault (the f32 CUDA-core variant
  put on the path in place of the tensor-core one): (b) the 4 x 4,096
  prefill's last-position logits against the plain B7; (c) four decode
  steps on each path's cache, fed the same tokens; (d) a prefill of 4,095
  tokens plus one decode step against the full prefill.
- B9 and each faulty copy: the int8 cache fed the 512 prompt tokens one a
  step against the bf16 cache fed the same tokens.

Each reading is max |difference| / max |logit| of the step (the ratio
``LOGIT_RTOL`` bounds); for B9 also the largest excess over rtol/atol and
whether the int8 argmax stayed in the bf16 top 5 on every step.  The last
line is one JSON object of all readings.  It exits non-zero when CUDA is
unavailable, a planted substitution no longer matches its source, or a
copy does not build.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (source, fault) -> (text of the source, its replacement)
FAULTS = {
    "flash_attention": {
        # causal: the key tile holding the diagonal, i.e. every query's
        # (up to) 32 nearest keys, and all keys of the first 32 queries
        "diagonal_tile_skipped": (
            "tiles = min(ntiles, last / kTile + 1);",
            "tiles = min(ntiles, last / kTile + 1) - 1;"),
        "self_masked": ("bool c = kp <= qpos[i];", "bool c = kp < qpos[i];"),
        "one_future_key": ("bool c = kp <= qpos[i];",
                           "bool c = kp <= qpos[i] + 1;"),
        # not a fault: the rounding a tensor-core kernel's p @ v would make
        "p_rounded_to_bf16": (
            "pw[i * kTile + lane] = p;",
            "pw[i * kTile + lane] = __bfloat162float(__float2bfloat16(p));"),
        "output_zeroed": ("from_f32<T>(acc[i][4 * cc + e] / den)",
                          "from_f32<T>(0.f * acc[i][4 * cc + e])"),
    },
    "flash_attention_tc": {
        # causal: the last key tile of each query tile, which holds the
        # diagonal (every query's up to 64 nearest keys)
        "diagonal_tile_skipped": (
            "const int ntiles = (kend + kBN - 1) / kBN;",
            "const int ntiles = (kend + kBN - 1) / kBN - 1;"),
        "self_masked": ("mask.sees(pos[h], kp)",
                        "(mask.sees(pos[h], kp) && kp != pos[h])"),
        "one_future_key": ("mask.sees(pos[h], kp)",
                           "(mask.sees(pos[h], kp) || kp == pos[h] + 1)"),
        "output_zeroed": (
            "pack2<T>(o[4 * n + 2 * h] / den, o[4 * n + 2 * h + 1] / den)",
            "pack2<T>(0.f * o[4 * n + 2 * h], 0.f * o[4 * n + 2 * h + 1])"),
    },
    "decode_attention": {
        "newest_position_dropped": (
            "const int length = min(max(*a.length, 0), a.Smax);",
            "const int length = min(max(*a.length - 1, 0), a.Smax);"),
        "output_zeroed": ("from_f32<TQ>(A / fmaxf(L, 1e-30f))",
                          "from_f32<TQ>(0.f * A)"),
    },
}
SYMBOLS = {"flash_attention": "repro_flash_attention_fwd",
           "flash_attention_tc": "repro_flash_attention_fwd_tc",
           "flash_attention_bwd": "repro_flash_attention_bwd",
           "flash_attention_bwd_tc": "repro_flash_attention_bwd_tc",
           "decode_attention": "repro_decode_attention"}
# the f32 CUDA-core variants, put on the bf16 path in place of the
# tensor-core ones while their faults are read
F32_VARIANT = {"flash_attention_fwd_gpu": "flash_attention_fwd_cuda",
               "flash_attention_bwd_gpu": "flash_attention_bwd_cuda"}
DECODE_STEPS_C = 4


def compile_variant(build, name: str, fault: str, tmp: pathlib.Path,
                    faults=FAULTS):
    old, new = faults[name][fault]
    src = (build.CSRC / f"{name}.cu").read_text()
    if src.count(old) != 1:
        raise SystemExit(f"{name}/{fault}: the planted text occurs "
                         f"{src.count(old)} times in the source, not once")
    path = tmp / f"{name}-{fault}.cu"
    path.write_text(src.replace(old, new))
    lib = path.with_suffix(".so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}/{fault}:\n{proc.stderr}")
    return lib


@contextlib.contextmanager
def swapped(module, name: str, lib):
    """Route ``module``'s launches of ``csrc/<name>.cu`` to the C entry
    point of ``lib`` (None: the sound kernel), with the sound entry
    point's signature."""
    if lib is None:
        yield
        return
    orig = module._lib
    sound = orig(name) if name in getattr(module, "_ENTRY", ()) else orig()
    fn = getattr(ctypes.CDLL(str(lib)), SYMBOLS[name])
    fn.argtypes, fn.restype = sound.argtypes, sound.restype
    module._lib = lambda *source: (
        fn if not source or source[0] == name else orig(*source))
    try:
        yield
    finally:
        module._lib = orig


@contextlib.contextmanager
def f32_variant(ops, on: bool):
    """With ``on``, ``ops`` dispatches B7 and B8 to their f32 CUDA-core
    variants whatever the dtype and head dim."""
    if not on:
        yield
        return
    saved = {n: getattr(ops, n) for n in F32_VARIANT}
    for n, f32 in F32_VARIANT.items():
        setattr(ops, n, getattr(ops, f32))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("logit_fault_control: no CUDA device available",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import build as build_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp_dir:
        tmp = pathlib.Path(tmp_dir)
        jobs = [(n, f) for n in FAULTS for f in FAULTS[n]]
        with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as pool:
            sound = pool.submit(build.build_all, tuple(FAULTS))
            futs = {j: pool.submit(compile_variant, build, *j, tmp)
                    for j in jobs}
            sound.result()
            libs = {j: f.result() for j, f in futs.items()}
        print(f"built the sound kernels and {len(libs)} faulty copies in "
              f"{time.perf_counter() - t0:.1f} s")
        result = run(torch, cs, get_arch("qwen2.5-3b"), build_model, ops,
                     fa, da, libs)
    result["card"] = smi
    result["limits"] = {"logit_rtol": cs.LOGIT_RTOL,
                        "quant_rtol": cs.QUANT_RTOL,
                        "quant_atol": cs.QUANT_ATOL}
    print(json.dumps(result))
    return 0


def ratio(got, want, cs) -> float:
    e = cs._errs(got, want)
    return e["max"] / e["ref_max"]


def run(torch, cs, cfg, build_model, ops, fa, da, libs,
        device="cuda") -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg)
    B, S, L = cs.LM_BATCH, cs.LM_PROMPT, cs.LM_MAX_LEN
    p32 = model.init(0, device=device)
    params = model.cast(p32)
    del p32
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=device)
    fed = torch.randint(0, cfg.vocab_size, (B, DECODE_STEPS_C),
                        generator=gen, device=device)

    def prefill(toks):
        return model.prefill(params, {"tokens": toks},
                             model.init_decode_state(B, L, device=device),
                             attn_impl="flash")

    def decode(st):
        out = []
        for t in range(DECODE_STEPS_C):
            lg, st = model.decode_step(params, st, fed[:, t:t + 1])
            out.append(lg)
        return out

    ops.use_kernels(False)
    plain, st = prefill(tokens)
    plain_steps = decode(st)
    ops.use_kernels(True)
    del st
    readings = {"b7": {}, "b7_tc": {}, "b9": {}}
    for name, key in (("flash_attention", "b7"),
                      ("flash_attention_tc", "b7_tc")):
        for fault in (None, *FAULTS[name]):
            lib = libs.get((name, fault))
            with swapped(fa, name, lib), \
                    f32_variant(ops, name == "flash_attention"):
                ops.reset_launch_counts()
                lg, st = prefill(tokens)
                steps = decode(st)
                del st
                _, st = prefill(tokens[:, :-1])
                ld, _ = model.decode_step(params, st, tokens[:, -1:])
                del st
                launched = ops.launch_counts()
            if not launched[{"b7": "flash_attention_fwd",
                             "b7_tc": "flash_attention_fwd_tc"}[key]]:
                raise SystemExit(f"{name}/{fault}: the path did not launch "
                                 f"this variant: {launched}")
            r = {"b": ratio(lg, plain, cs),
                 "c": max(ratio(a, b, cs)
                          for a, b in zip(steps, plain_steps)),
                 "d": ratio(ld, lg, cs),
                 "b_max_abs": cs._errs(lg, plain)["max"],
                 "argmax_equal_b": bool(torch.equal(lg.argmax(-1),
                                                    plain.argmax(-1)))}
            readings[key][fault or "sound"] = r
            print(f"{key} {fault or 'sound'}: {r}", flush=True)
            torch.cuda.empty_cache()

    # B9: the int8 cache against the bf16 cache fed the same prompt tokens
    n = cs.LM_QUANT_PROMPT
    mf = build_model(cfg)
    mq = build_model(cfg, cache_quant=True)
    sf = mf.init_decode_state(B, L, device=device)
    ref = []
    for t in range(n):
        lf, sf = mf.decode_step(params, sf, tokens[:, t:t + 1])
        ref.append(lf)
    del sf
    for fault in (None, *FAULTS["decode_attention"]):
        lib = libs.get(("decode_attention", fault))
        sq = mq.init_decode_state(B, L, device=device)
        worst, over, outside, in_top5 = 0.0, float("-inf"), 0, True
        with swapped(da, "decode_attention", lib):
            for t in range(n):
                lq, sq = mq.decode_step(params, sq, tokens[:, t:t + 1])
                lq, lf = lq.float(), ref[t].float()
                worst = max(worst, ratio(lq, lf, cs))
                excess = float(((lq - lf).abs() - (
                    cs.QUANT_ATOL + cs.QUANT_RTOL * lf.abs())).max())
                over = max(over, excess)
                outside += int(excess > 0)
                top5 = torch.topk(lf, 5, dim=-1).indices
                in_top5 &= bool((top5 == lq.argmax(-1, keepdim=True))
                                .any(-1).all())
        del sq
        r = {"ratio": worst, "excess": over, "steps_outside": outside,
             "argmax_in_top5": in_top5}
        readings["b9"][fault or "sound"] = r
        print(f"B9 {fault or 'sound'}: {r}", flush=True)
    return readings


if __name__ == "__main__":
    sys.exit(main())
