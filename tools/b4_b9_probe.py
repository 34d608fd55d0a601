#!/usr/bin/env python3
"""Where the time of kernels B4 (block top-k) and B9 (decode attention) goes.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    python3 tools/b4_b9_probe.py

Every time is device time: the calls captured in one CUDA graph and
replayed (``chip_smoke.graph_ms``), so the wrappers' host cost is left out.

- B4 at a lineitem-sized input (8 x 7,500,000 uniform values) for k = 1 and
  k = 100 beside ``torch.topk`` on the (blocks, 4,096) view, and at the hand
  plans' size (8 x 12,500) for k = 1 and 10.
- B9 on an int8 cache (q (8, 8, 128) bf16, 32,768 positions) at lengths 0,
  1, 64, 576, 4,160 and 32,768, as built and as copies of
  ``csrc/decode_attention.cu`` with one part switched off by a text
  substitution (the source is not touched; the copies compute wrong
  results and are only timed): the cluster merge and its two barriers,
  the scores, p v, and both; then with four warps a block, with a
  shared-memory budget of 113 KB (two blocks an SM) and with both (the
  launch shape of the kernel's first Hopper version, at its cluster of
  8).

The last line is one JSON object of all readings.  It exits non-zero when
CUDA is unavailable, a substitution no longer matches the source, or a copy
does not build.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

# variant -> [(text of csrc/decode_attention.cu, its replacement), ...]
VARIANTS = {
    "no_merge": [
        ("    cluster.sync();\n\n    // the cluster's partials merged",
         "\n\n    // the cluster's partials merged"),
        ("e < rows * D;\n         e += kCluster * nthreads) {",
         "e < 0;\n         e += kCluster * nthreads) {"),
        ("    cluster.sync();  // every rank's shared memory outlives",
         "    // every rank's shared memory outlives")],
    "no_scores": [("            if (16 * kk < D) {", "            if (false) {")],
    "no_pv": [("for (int t4 = 0; t4 < n; t4 += 4) {",
               "for (int t4 = 0; t4 < 0; t4 += 4) {")],
    "four_warps": [("constexpr int kMaxWarps = 8;",
                    "constexpr int kMaxWarps = 4;")],
    "budget_113k": [("constexpr int kSmemBudget = 200 * 1024;",
                     "constexpr int kSmemBudget = 113 * 1024;")],
}
VARIANTS["no_scores_no_pv"] = VARIANTS["no_scores"] + VARIANTS["no_pv"]
VARIANTS["four_warps_113k"] = (VARIANTS["four_warps"]
                               + VARIANTS["budget_113k"])
LENGTHS = (0, 1, 64, 576, 4160, 32768)


def compile_variant(build, name: str, tmp: pathlib.Path) -> pathlib.Path:
    src = (build.CSRC / "decode_attention.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the text {old!r} occurs "
                             f"{src.count(old)} times in the source")
        src = src.replace(old, new)
    path = tmp / f"decode_attention-{name}.cu"
    path.write_text(src)
    lib = path.with_suffix(".so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(path)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr}")
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("b4_b9_probe: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import graph_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.topk_select import block_topk_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": smi, "b4": {}, "b9": {}}

    # -- B4 ------------------------------------------------------------------
    for rows, n, ks in ((8, 7_500_000, (1, 100)), (8, 12_500, (1, 10))):
        x = torch.rand((rows, n), generator=gen, device="cuda") * 1e5
        keys = torch.arange(rows * n, device="cuda",
                            dtype=torch.int32).view(rows, n)
        view = torch.nn.functional.pad(x, (0, (-n) % 4096),
                                       value=float("-inf")).reshape(-1, 4096)
        for k in ks:
            r = {"ms": graph_ms(lambda: block_topk_cuda(x, keys, k=k), 20),
                 "torch_topk_ms": graph_ms(
                     lambda: torch.topk(view, k, dim=1), 20)}
            result["b4"][f"{rows}x{n} k={k}"] = r
            print(f"B4 {rows} x {n}, k = {k}: {r}", flush=True)

    # -- B9 ------------------------------------------------------------------
    q = torch.randn((8, 8, 128), generator=gen, device="cuda").bfloat16()
    kc, vc = (torch.randint(-127, 128, (8, 32768, 128), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    sc = {n: torch.rand((8, 32768), generator=gen, device="cuda") * 0.04
          for n in ("k_scale", "v_scale")}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp_dir:
        with concurrent.futures.ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
            sound = pool.submit(build.compile_source, "decode_attention")
            futs = {v: pool.submit(compile_variant, build, v,
                                   pathlib.Path(tmp_dir)) for v in VARIANTS}
            sound.result()
            libs = {v: f.result() for v, f in futs.items()}
        orig = da._lib
        for name in ("as built", *VARIANTS):
            if name != "as built":
                fn = getattr(ctypes.CDLL(str(libs[name])),
                             "repro_decode_attention")
                fn.argtypes, fn.restype = orig().argtypes, orig().restype
                da._lib = lambda fn=fn: fn
            row = {}
            for length in LENGTHS:
                lt = torch.tensor(length, dtype=torch.int32, device="cuda")
                cfg = []
                da.decode_attention_cuda(q, kc, vc, lt, **sc, config=cfg)
                row[length] = graph_ms(lambda: da.decode_attention_cuda(
                    q, kc, vc, lt, **sc), 50) * 1e3
            da._lib = orig
            result["b9"][name] = {"us": row, "config": cfg}
            print(f"B9 {name} (config [cluster, warps, stages, shared "
                  f"bytes] {cfg}): "
                  + ", ".join(f"length {n} {t:.2f} us"
                              for n, t in row.items()), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
