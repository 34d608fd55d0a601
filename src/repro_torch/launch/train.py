"""Training launcher (counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --smoke --steps 200 --batch 8 --seq 128 [--device cuda]

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.train --arch qwen2.5-3b \
      --smoke --mesh 2x2 --device cpu

``--mesh 1`` (the default) trains on one device, ``cuda`` unless
``--device`` names another.  ``--mesh DxM`` (or ``PxDxM``) shards the
trainer over a ``(data, model)`` (``(pod, data, model)``) mesh of that
many ranks, one process a rank under ``python -m torch.distributed.run``
(torchrun): the group is NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu`` (``launch.mesh.init_from_env``), and the model's heads
are padded to the mesh's ``model`` size, as the reference pads them.
Rank 0 prints.  Production shapes are 16x16 and 2x16x16.
Checkpoint/restart: re-running with the same ``--ckpt`` dir resumes from
the latest atomic step, under any mesh.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--mesh", type=str, default="1")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="device to train on (default: cuda)")
    args = p.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch(args.arch, smoke=args.smoke)
    where, tp, rank0 = args.device, 1, True
    if args.mesh != "1":
        from repro_torch.launch import mesh as launch_mesh

        if not launch_mesh.under_torchrun():
            raise ValueError(
                f"--mesh {args.mesh} runs one process a rank: launch with "
                f"python -m torch.distributed.run (torchrun) "
                f"--nproc-per-node equal to the mesh's size")
        device_type = "cpu" if args.device == "cpu" else "cuda"
        launch_mesh.init_from_env(device_type)
        where = launch_mesh.parse_mesh(args.mesh, device_type)
        tp = dict(zip(where.mesh_dim_names, where.shape)).get("model", 1)
        rank0 = where.get_rank() == 0
    model = build(cfg, tp=tp)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)
    trainer = Trainer(
        model, data, where,
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps),
        TrainerConfig(steps=args.steps, checkpoint_dir=args.ckpt,
                      log_every=10 if rank0 else 10 ** 9,
                      checkpoint_every=args.ckpt_every,
                      microbatches=args.microbatches, seed=args.seed),
    )
    state, history = trainer.run()
    if rank0:
        print(f"final loss {history[-1]['loss']:.4f} after {len(history)} "
              f"steps (first {history[0]['loss']:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
