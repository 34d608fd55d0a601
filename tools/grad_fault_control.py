#!/usr/bin/env python3
"""Planted-fault control for the training gradient check of chip_smoke.py.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    python3 tools/grad_fault_control.py

``chip_smoke.py`` (phase 8c) holds the first training step of qwen2.5-3b
at full width through B7 + B8 against the plain attention path: each
parameter's gradient within ``GRAD_RTOL`` relative Frobenius distance
(||g - g_plain|| / ||g_plain||).  This script measures whether that limit
can see a faulty B8.  It compiles copies of B8's two CUDA variants,
``csrc/flash_attention_bwd.cu`` (f32 CUDA cores) and
``csrc/flash_attention_bwd_tc.cu`` (tensor cores, the one the bf16 path
takes), each with one planted fault made by a text substitution, into a
temporary directory under ``build/kernels/`` (the sources are not
touched):

- ``diagonal_tile_skipped``: the dk/dv kernel skips the query tile on the
  diagonal, so each key loses its own and its nearest queries;
- ``delta_dropped``: delta = rowsum(do . out) is 0;
- ``dq_unscaled``: dq misses its 1/sqrt(D);
- ``p_rounded_to_bf16`` (f32 variant only): p rounded to bf16 before use,
  the rounding the tensor-core variant makes; not a fault.

With chip_smoke.py's weights (seed 0, f32), batch (``SyntheticLM`` seed 0,
2 x 4,096 tokens) and bf16 compute, it computes the plain path's
gradients once, then the step's gradients through each variant of B7 and
B8, sound and with each faulty copy (the f32 CUDA-core variants put on
the path in place of the tensor-core ones for their readings), and reads
each through the distance: the largest over
the 435 parameter tensors (the limit's reading) and where, the median,
and the largest over the tensors outside attention.  The last line is one
JSON object of all readings.  It exits non-zero when CUDA is unavailable,
a planted substitution no longer matches its source, or a copy does not
build.
"""
from __future__ import annotations

import concurrent.futures
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

FAULTS = {"flash_attention_bwd": {
    "diagonal_tile_skipped": (
        "const int qlo = (causal && k0 >= prefix) ? k0 : 0;",
        "const int qlo = (causal && k0 >= prefix) ? k0 + kTile : 0;"),
    "delta_dropped": ("if (lane == 0) delta[row] = acc;",
                      "if (lane == 0) delta[row] = 0.f * acc;"),
    "dq_unscaled": ("from_f32<T>(acc[i][4 * cc + e] * scale)",
                    "from_f32<T>(acc[i][4 * cc + e])"),
    # not a fault: the rounding a tensor-core kernel's products would make
    "p_rounded_to_bf16": (
        "return s <= kNegInf * 0.5f ? 0.f : expf(s - lse);",
        "return s <= kNegInf * 0.5f ? 0.f "
        ": __bfloat162float(__float2bfloat16(expf(s - lse)));"),
}, "flash_attention_bwd_tc": {
    "diagonal_tile_skipped": (
        "const int qt0 = (mask.causal && k0 >= mask.prefix) ? k0 / kBq : 0;",
        "const int qt0 = (mask.causal && k0 >= mask.prefix) ? k0 / kBq + 1 "
        ": 0;"),
    "delta_dropped": ("if (lane == 0) delta[row] = acc;",
                      "if (lane == 0) delta[row] = 0.f * acc;"),
    "dq_unscaled": (
        "acc[4 * n + 2 * h] * scale, acc[4 * n + 2 * h + 1] * scale);",
        "acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);"),
}}
# the B7 variant each B8 variant runs beside
FWD = {"flash_attention_bwd": "flash_attention",
       "flash_attention_bwd_tc": "flash_attention_tc"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("grad_fault_control: no CUDA device available",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    import logit_fault_control as lfc
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_bwd as fb

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
            sound = pool.submit(build.build_all, (*FWD.values(), *FAULTS))
            futs = {j: pool.submit(lfc.compile_variant, build, *j, tmp,
                                   FAULTS)
                    for j in jobs}
            sound.result()
            libs = {j: fut.result() for j, fut in futs.items()}
        print(f"built the sound kernels and {len(libs)} faulty copies in "
              f"{time.perf_counter() - t0:.1f} s")
        result = run(torch, cs, lfc, fb, libs)
    result["card"] = smi
    result["limits"] = {"grad_rtol": cs.GRAD_RTOL,
                        "loss_rtol": cs.TRAIN_LOSS_RTOL}
    print(json.dumps(result))
    return 0


def run(torch, cs, lfc, fb, libs, device="cuda") -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import build as build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen2.5-3b")
    model = build_model(cfg)
    params = model.init(0, device=device, trainable=True)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=cs.TRAIN_SEQ,
                        global_batch=cs.TRAIN_BATCH, seed=0).device_batch(
        0, device=device)
    loss_plain, g_plain = cs.first_step_grads(model, params, batch, "xla")
    readings = {"loss_plain": loss_plain}
    for name, key in (("flash_attention_bwd", "b8"),
                      ("flash_attention_bwd_tc", "b8_tc")):
        readings[key] = {}
        for fault in (None, *FAULTS[name]):
            with lfc.swapped(fb, name, libs.get((name, fault))), \
                    lfc.f32_variant(ops, name == "flash_attention_bwd"):
                ops.reset_launch_counts()
                loss, g = cs.first_step_grads(model, params, batch, "flash")
                launched = ops.launch_counts()
            if not (launched[FWD[name].replace("attention", "attention_fwd")]
                    and launched[name]):
                raise SystemExit(f"{name}/{fault}: the step did not launch "
                                 f"this variant: {launched}")
            dist = cs.grad_distances(torch, g, g_plain)
            del g
            worst = max(dist, key=dist.get)
            outside = {n: d for n, d in dist.items() if ".attn." not in n}
            r = {"max": dist[worst], "argmax": worst,
                 "median": statistics.median(dist.values()),
                 "max_outside_attention": max(outside.values()),
                 "argmax_outside_attention": max(outside, key=outside.get),
                 "loss_rel": abs(loss - loss_plain) / abs(loss_plain)}
            readings[key][fault or "sound"] = r
            print(f"{key} {fault or 'sound'}: {r}", flush=True)
            torch.cuda.empty_cache()
    return readings


if __name__ == "__main__":
    sys.exit(main())
