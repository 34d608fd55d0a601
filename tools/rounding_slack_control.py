#!/usr/bin/env python3
"""Control for the rounding slack of the tensor-core B8 check in
chip_smoke.py.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    python3 tools/rounding_slack_control.py

``chip_smoke.py`` holds the tensor-core B8 (``flash_attention_bwd_tc``) to
the plain version with the same rounding (``ref.flash_attention_bwd(...,
p_dtype=bf16)``): each gradient within one bf16 rounding of the output
plus 2e-5 of its largest |value|, plus the rounding slack.  The slack lets
a p or ds that lies near a rounding boundary round the other way; ds's
band holds ``SUM_NOISE_ULPS`` units of roundoff of ``|do| . |v| + |do| .
|out|``, since dp and delta may nearly cancel.  This script measures what
that constant must be on real inputs: it runs qwen2.5-3b's first training
step at full width as chip_smoke.py's phase 8c does (weights seed 0,
``SyntheticLM`` seed 0, 2 x 4,096 tokens, bf16 compute), keeps B8's inputs
of all 36 layers, and for each layer and each ``SUM_NOISE_ULPS`` in
``ULPS`` counts the dq and dk elements outside the limit and reads the
slack's mean share of the limit.  It also reads how far dp and delta
cancel (|dp| / |dp - delta| where p > 1e-3).  The last line is one JSON
object of all readings.  It exits non-zero when CUDA is unavailable.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ULPS = (0.0, 1.0, 4.0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("rounding_slack_control: no CUDA device available",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.models.model import build as build_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    build.build_all(("flash_attention_tc", "flash_attention_bwd_tc"))
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen2.5-3b")
    model = build_model(cfg)
    params = model.init(0, device="cuda", trainable=True)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=cs.TRAIN_SEQ,
                        global_batch=cs.TRAIN_BATCH, seed=0).device_batch(
        0, device="cuda")
    inputs = []
    orig = cs._recording(ops, "flash_attention_bwd", inputs)
    cs.first_step_grads(model, params, batch, "flash")
    ops.flash_attention_bwd = orig
    del params
    torch.cuda.empty_cache()

    readings = {"card": smi, "layers": {}}
    outside = dict.fromkeys(ULPS, 0)
    share = dict.fromkeys(ULPS, 0.0)
    sound = ref.SUM_NOISE_ULPS
    for i, (a, kw) in enumerate(inputs):
        layer = cfg.n_layers - 1 - i
        qg, kg, vg, out, lse, do = (t.detach() for t in a)
        got = fb.flash_attention_bwd_tc_cuda(qg, kg, vg, out, lse, do, **kw)
        ins = (qg.float(), kg.float(), vg.float(), out.float(), lse,
               do.float())
        r = {}
        for ulps in ULPS:
            ref.SUM_NOISE_ULPS = ulps
            try:
                want, slack = ref.flash_attention_bwd(
                    *ins, p_dtype=qg.dtype, slack=True, **kw)
            finally:
                ref.SUM_NOISE_ULPS = sound
            for name, g, w, sl in list(zip("qkv", got, want, slack))[:2]:
                w = w.float()
                lim = (cs.OUT_ULP["bfloat16"] * w.abs()
                       + cs.F32_TOL * float(w.abs().max()))
                n = int(((g.float() - w).abs() > lim + sl).sum())
                s = float((sl / lim).mean())
                r[f"d{name}@{ulps:g}"] = {"outside": n, "slack_share": s}
                outside[ulps] += n
                share[ulps] = max(share[ulps], s)
            del want, slack
        s = ref._masked_scores(ins[0], ins[1], kw["causal"],
                               kw.get("window"), kw.get("prefix", 0))
        p = torch.exp(s - lse[..., None]).masked_fill_(
            s <= ref.NEG_INF / 2, 0.0)
        del s
        dp = torch.einsum("bgsd,btd->bgst", ins[5], ins[2])
        delta = (ins[5] * ins[3]).sum(-1)[..., None]
        ratio = (dp.abs() / (dp - delta).abs().clamp_min(1e-30))[p > 1e-3]
        r["cancel_median"] = float(ratio.median())
        r["cancel_max"] = float(ratio.max())
        del p, dp, delta, ratio, got, ins
        torch.cuda.empty_cache()
        readings["layers"][layer] = r
        print(f"layer {layer}: {r}", flush=True)
    readings["outside_by_ulps"] = {f"{u:g}": n for u, n in outside.items()}
    readings["worst_slack_share_by_ulps"] = {f"{u:g}": s
                                             for u, s in share.items()}
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
