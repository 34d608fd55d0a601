"""Training launcher (counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --smoke --steps 200 --batch 8 --seq 128 [--device cuda]

Runs on one device, ``cuda`` unless ``--device`` names another; ``--mesh``
takes only ``1`` until the sharded trainer is ported (ROADMAP.md queue A,
item 9).  Checkpoint/restart: re-running with the same ``--ckpt`` dir
resumes from the latest atomic step.
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

    if args.mesh != "1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; the sharded "
            f"trainer waits for ROADMAP.md queue A, item 9")

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch(args.arch, smoke=args.smoke)
    model = build(cfg)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)
    trainer = Trainer(
        model, data, args.device,
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps),
        TrainerConfig(steps=args.steps, checkpoint_dir=args.ckpt,
                      checkpoint_every=args.ckpt_every,
                      microbatches=args.microbatches, seed=args.seed),
    )
    state, history = trainer.run()
    print(f"final loss {history[-1]['loss']:.4f} after {len(history)} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
