"""The paper's §3.2.3 top-k selection serving an LM decode head across
ranks: qwen2.5-3b (SMOKE size) decoded over a ``(data, model)`` mesh, its
vocab-sharded logits merged by the log2(P)-round butterfly instead of an
O(V) all-gather (counterpart of ``examples/decode_distributed_topk.py``).

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 8 examples/decode_distributed_topk_torch.py
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 examples/decode_distributed_topk_torch.py \\
        --mesh 2x2 --device cpu

One process a rank: NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
cpu``.  The model's heads are padded to the mesh's ``model`` size, the
parameters are random (seed 0), the batch of 4 starts from token 0 on an
empty f32 cache; rank 0 prints the token streams and the cache length.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="2x4", help="DxM (default 2x4)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks on the CPU (default: cuda)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch.cells import build_cell
    from repro_torch.serve.engine import decode_loop

    device_type = "cpu" if args.device == "cpu" else "cuda"
    launch_mesh.init_from_env(device_type)
    mesh = launch_mesh.parse_mesh(args.mesh, device_type)
    B = 4
    cell = build_cell("qwen2.5-3b", "decode_32k", mesh, smoke=True, batch=B,
                      seq_len=32)
    rows = torch.arange(B)
    first = cell.local(torch.zeros(B, dtype=torch.long,
                                   device=cell.state.length.device))
    toks, state = decode_loop(cell.model, cell.params, cell.state, first,
                              args.steps, cell.mesh, rules=cell.rules, k=8)
    # every rank holds its batch rows: gather them in rank order
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (cell.local(rows).tolist(),
                                 toks.cpu().tolist()))
    if dist.get_rank() == 0:
        streams = {}
        for rank_rows, rank_toks in got:
            streams.update(zip(rank_rows, rank_toks))
        print("decoded token streams (distributed §3.2.3 top-k head):")
        for b in range(B):
            print(f"  seq {b}: {streams[b]}")
        print(f"cache length: {int(state.length)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
