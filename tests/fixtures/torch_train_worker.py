"""One rank of the port's sharded trainer, for
``tests/test_torch_sharded_train.py``.

    python tests/fixtures/torch_train_worker.py SPAWN IN OUT

runs with torchrun's variables set by the caller (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), forms
the gloo group through ``launch.mesh.init_from_env`` and pickles what it
saw to ``OUT/rank{RANK}.pkl``.  ``IN`` holds the JAX SMOKE parameters
(numpy, the JAX layout), the batches and the AdamW settings.  The tasks:

- ``w4`` (4 ranks): ``launch/train.py --mesh 2x2 --device cpu`` as
  torchrun runs it (its standard output), then :func:`train` on the mesh
  (2, 2);
- ``w2`` (2 ranks): :func:`train` on (2, 1) with a checkpoint after step
  3 and two more steps, :func:`train` on (1, 2) through the flash path,
  the (2, 1) checkpoint restored on (1, 2) and its two more steps, and
  :func:`flash_dtensor`.

:func:`train` carries the JAX parameters across
(``convert.params_from_jax``), lays them out on the mesh through the
``Trainer`` and runs its steps over the batches; it reports each step's
loss and gradient norm, the local shape of every parameter and moment,
and (rank 0) the parameters after the steps in the JAX layout.
"""
from __future__ import annotations

import contextlib
import io
import pickle
import sys
import traceback

import torch


class Batches:
    """The data of the run: step t's global batch is ``batches[t]``."""

    def __init__(self, batches, seed=0):
        self.batches, self.seed = batches, seed
        self.global_batch = batches[0]["tokens"].shape[0]

    def device_batch(self, step, *, device):
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.batches[step].items()}


def _local_shapes(state) -> dict:
    """name -> this rank's block shape of every parameter and moment."""
    out = {}
    for label, tree in (("params", state.params), ("mu", state.opt.mu),
                        ("nu", state.opt.nu)):
        for n, p in tree.named_parameters():
            out[f"{label}.{n}"] = tuple(p.to_local().shape)
    return out


def _full_params(state):
    """The parameters' full values in the JAX layout (every rank gathers;
    numpy)."""
    from repro_torch.models import sharding as SH
    from repro_torch.models.convert import jax_layout

    tree = jax_layout(state.params.map(SH.full))
    return _numpy(tree)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().float().numpy().copy()


def _trainer(inp, mesh, steps, ckdir=None, every=50, impl="xla"):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    return Trainer(build(get_arch(inp["arch"], smoke=True), tp=tp),
                   Batches(inp["batches"]), mesh,
                   adamw.AdamWConfig(**inp["opt"]),
                   TrainerConfig(steps=steps, log_every=1000,
                                 checkpoint_dir=ckdir,
                                 checkpoint_every=every,
                                 fwd_kw={"attn_impl": impl}))


def _jax_state(trainer, inp):
    """The JAX parameters and zero moments, laid out on the mesh."""
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.train_step import TrainState

    params = trainer.shard_params(params_from_jax(inp["params"],
                                                  trainable=True))
    return TrainState(params, adamw_init(params))


def _history(h):
    return [(x["loss"], x["grad_norm"]) for x in h]


def train(inp, spec, impl="xla", steps=3, more=0, ckdir=None):
    """``steps`` steps on the mesh ``spec`` from the JAX parameters, the
    parameters after them, and ``more`` steps after a checkpoint."""
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.train import checkpoint as ckpt

    mesh = parse_mesh(spec, "cpu")
    t = _trainer(inp, mesh, steps, impl=impl)
    state, hist = t.run(_jax_state(t, inp), 0)
    out = {"history": _history(hist), "local": _local_shapes(state),
           "params": _full_params(state), "step": int(state.opt.step)}
    if more:
        ckpt.save(ckdir, state, steps, blocking=True)
        t = _trainer(inp, mesh, steps + more, impl=impl)
        _, hist = t.run(state, steps)
        out["more"] = _history(hist)
    return out


def restore(inp, spec, steps, ckdir):
    """The checkpoint of ``ckdir`` restored on the mesh ``spec`` through
    the trainer, and its steps to ``steps``."""
    from repro_torch.launch.mesh import parse_mesh

    t = _trainer(inp, parse_mesh(spec, "cpu"), steps, ckdir=ckdir)
    state, start = t.init_or_restore()
    _, hist = t.run(state, start)
    return {"start": start, "history": _history(hist),
            "local": _local_shapes(state)}


def flash_dtensor(spec) -> dict:
    """ops.flash_attention on DTensors laid out as the fused (B*KV) dim
    wants (batch on the batch axes, heads on the kv-head axes) against
    the same call on the whole tensors, and a layout it must refuse."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models import runtime, sharding as SH

    mesh = parse_mesh(spec, "cpu")
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 16, 4, 8, generator=g, requires_grad=True)
    k = torch.randn(2, 16, 2, 8, generator=g, requires_grad=True)
    v = torch.randn(2, 16, 2, 8, generator=g, requires_grad=True)
    want = ops.flash_attention(q, k, v, causal=True)
    want.sum().backward()
    wg = [t.grad.clone() for t in (q, k, v)]
    pl = SH.resolve(("batch", None, "kv_heads", None), mesh)
    dq, dk, dv = (DTensor.from_local(
        SH.local_block(t.detach(), SH.Sharding(mesh, pl)).clone(), mesh,
        pl, run_check=False).requires_grad_() for t in (q, k, v))
    ops.reset_launch_counts()
    with runtime.mesh_rules(mesh):
        got = ops.flash_attention(dq, dk, dv, causal=True)
        got.to_local().sum().backward()
        counts = ops.local_shard_counts()
        bad = [Replicate()] * mesh.ndim
        bad[-1] = Shard(1)
        try:
            ops.flash_attention(*(DTensor.from_local(
                t.detach(), mesh, bad, run_check=False) for t in (q, k, v)))
            refused = ""
        except ValueError as e:
            refused = str(e)
    block = SH.Sharding(mesh, pl)
    errs = [float((got.to_local() - SH.local_block(want, block)).abs().max())]
    errs += [float((a.grad.to_local() - SH.local_block(b, block)).abs().max())
             for a, b in zip((dq, dk, dv), wg)]
    return {"errs": errs, "counts": counts, "refused": refused,
            "placements": [(j, p.dim) for j, p in enumerate(got.placements)
                           if isinstance(p, Shard)]}


def refuse_moe(inp) -> str:
    """The trainer's refusal of the MoE family on a mesh of 2 ranks."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    try:
        Trainer(build(get_arch("qwen3-moe-30b-a3b", smoke=True)),
                Batches(inp["batches"]), parse_mesh("2x1", "cpu"),
                AdamWConfig(), TrainerConfig())
    except ValueError as e:
        return str(e)
    return ""


def main(spawn: str, inp_path: str, out: str) -> None:
    import os

    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    res = {"rank": rank}
    try:
        from repro_torch.launch import mesh as launch_mesh
        from repro_torch.launch import train as launch_train

        if spawn == "w4":
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res["launcher_rc"] = launch_train.main(
                    ["--arch", inp["arch"], "--smoke", "--mesh", "2x2",
                     "--device", "cpu", "--steps", "4", "--batch", "4",
                     "--seq", "16"])
            res["launcher_out"] = buf.getvalue()
            res["mesh_2x2"] = train(inp, "2x2")
        else:
            launch_mesh.init_from_env("cpu")
            ckdir = os.path.join(out, "ck")
            res["mesh_2x1"] = train(inp, "2x1", more=2, ckdir=ckdir)
            res["mesh_1x2"] = train(inp, "1x2", impl="flash")
            res["elastic"] = restore(inp, "1x2", 5, ckdir)
            res["flash_dtensor"] = flash_dtensor("1x2")
            res["refuse_moe"] = refuse_moe(inp)
        dist.barrier()
    except Exception:  # noqa: BLE001 - reported to the test
        res["error"] = traceback.format_exc()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
