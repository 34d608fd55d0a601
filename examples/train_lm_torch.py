"""Train a language model end to end with the PyTorch port on the
synthetic sharded pipeline: a (data, model) mesh of torch.distributed
ranks (FSDP over ``data``, tensor parallelism over ``model``), AdamW,
checkpoints, restart.  The counterpart of ``examples/train_lm.py``.

Default is a fast demo (~10M params, 200 steps); pass --full for the
~100M-param variant of the same run.  Under torchrun each rank is one
process (gloo with ``--device cpu``, NCCL on one card a rank); without
torchrun and with ``--mesh 1`` it trains on one device:

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 examples/train_lm_torch.py --mesh 2x2 \\
        --device cpu [--full] [--steps 200]
    PYTHONPATH=src python examples/train_lm_torch.py --mesh 1 --device cpu

Checkpoints go to ``build/train_lm_torch`` in the checkout unless
``--ckpt`` names another directory; re-run to resume, under any mesh.
"""
import argparse
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="~100M params (slower on CPU)")
    ap.add_argument("--mesh", type=str, default="2x2",
                    help="DxM (or PxDxM) under torchrun, 1 for one device")
    ap.add_argument("--device", type=str, default=None,
                    help="cpu, or cuda (the default)")
    ap.add_argument("--ckpt", type=str,
                    default=str(ROOT / "build" / "train_lm_torch"))
    args = ap.parse_args()

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if args.full:
        cfg = ModelConfig(name="demo-100m", family="dense", n_layers=8,
                          d_model=512, n_heads=8, n_kv_heads=4, d_ff=2048,
                          vocab_size=32768, compute_dtype="float32")
    else:
        cfg = ModelConfig(name="demo-10m", family="dense", n_layers=4,
                          d_model=192, n_heads=4, n_kv_heads=2, d_ff=768,
                          vocab_size=4096, compute_dtype="float32",
                          remat=False)
    where, tp, rank0 = args.device, 1, True
    if args.mesh != "1":
        device_type = "cpu" if args.device == "cpu" else "cuda"
        launch_mesh.init_from_env(device_type)
        where = launch_mesh.parse_mesh(args.mesh, device_type)
        tp = dict(zip(where.mesh_dim_names, where.shape)).get("model", 1)
        rank0 = where.get_rank() == 0
    model = build(cfg, tp=tp)
    if rank0:
        print(f"{cfg.name}: {cfg.num_params() / 1e6:.1f}M params on "
              f"{'mesh ' + args.mesh if args.mesh != '1' else 'one device'}")
    data = SyntheticLM(vocab_size=cfg.vocab_size,
                       seq_len=256 if args.full else 128,
                       global_batch=16 if args.full else 8, seed=0)
    trainer = Trainer(
        model, data, where,
        AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
        TrainerConfig(steps=args.steps, log_every=20 if rank0 else 10 ** 9,
                      checkpoint_dir=args.ckpt, checkpoint_every=50),
    )
    state, history = trainer.run()
    if rank0 and history:
        k = min(10, len(history))
        first = sum(h["loss"] for h in history[:k]) / k
        last = sum(h["loss"] for h in history[-k:]) / k
        print(f"\nloss {first:.3f} -> {last:.3f} over {len(history)} steps "
              f"(checkpoints in {args.ckpt}; re-run to resume)")


if __name__ == "__main__":
    main()
