"""One rank of the port's serving under a mesh, for
``tests/test_torch_sharded_serve.py``.

    python tests/fixtures/torch_serve_worker.py SPAWN IN OUT

runs with torchrun's variables set by the caller (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), forms
the gloo group through ``launch.mesh.init_from_env`` and pickles what it
saw to ``OUT/rank{RANK}.pkl``.  ``IN`` holds the JAX SMOKE parameters
(numpy, the JAX layout), the prompt and the head's logits.  The tasks:

- ``w4`` (4 ranks): :func:`serve` on the float cache at (2, 2) (B7 on
  local blocks), on the int8 cache at (2, 2), on both caches in the
  decode-opt layout (1, 2, 2) of ``decode_opt_layout(chips=4, data=1)``;
  :func:`head` over a model dim of 4 ranks (1, 4); the example's
  ``main`` at ``--mesh 2x2`` (its standard output);
- ``w2`` (2 ranks): :func:`serve` on the float cache at (1, 2) (B7) and
  (2, 1) (xla), a sampled decode at (1, 2), and the refusal of the MoE
  family on (2, 1).

:func:`serve` carries the JAX parameters across
(``convert.params_from_jax``), lays them and the state out on the mesh
and runs a prefill (float cache) or the prompt one token a step (int8),
then greedy steps through ``decode_loop``; it reports this rank's tokens
and logits with the global rows and vocab ids they hold, the local
shapes of every parameter and state tensor, the local-block counts and
the rows each B9 call saw.
"""
from __future__ import annotations

import contextlib
import io
import pickle
import sys
import traceback

import torch

STEPS = 8
MAX_LEN = 32


def _np(t):
    return t.detach().cpu().numpy().copy()


def serve(inp, mesh, rules, tp, *, tp_kv=None, quant=False, impl="flash",
          greedy=True):
    """The prompt and ``STEPS`` steps on ``mesh`` -> this rank's record."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import runtime
    from repro_torch.models import sharding as SH
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import build
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import decode_loop, make_head

    cfg = get_arch(inp["arch"], smoke=True)
    model = build(cfg, tp=tp, tp_kv=tp_kv, cache_quant=quant)
    prompt = torch.from_numpy(inp["prompt"])
    B, S = prompt.shape
    rules = SH.rules_for(mesh, B, rules)
    params = Transformer(SH.shard_tree(
        params_from_jax(inp["params"]).tree(),
        SH.sharding_tree(model.param_axes(), mesh, rules)))
    state = SH.place_state(
        model.init_decode_state(B, MAX_LEN, torch.float32, device="meta"),
        SH.sharding_tree(model.decode_state_axes(), mesh, rules), "cpu")

    def block(x, axes):
        return SH.local_block(x, SH.Sharding(mesh,
                                             SH.resolve(axes, mesh, rules)))

    rows = block(torch.arange(B), ("batch",))
    vocab = block(torch.arange(cfg.padded_vocab()), ("vocab",))
    local = block(prompt, ("batch", None))
    seen = []
    plain_b9 = ref.decode_attention
    ref.decode_attention = lambda q, *a: (seen.append(q.shape[0]),
                                          plain_b9(q, *a))[1]
    gen = None if greedy else torch.Generator().manual_seed(0)
    logits = []
    ops.reset_launch_counts()
    try:
        if quant:
            fed, state = decode_loop(model, params, state, local[:, 0], S,
                                     mesh, rules=rules, forced=local[:, 1:],
                                     logits_out=logits)
            first = fed[:, -1]
        else:
            with runtime.mesh_rules(mesh, rules):
                lg, state = model.prefill(params, {"tokens": local}, state,
                                          attn_impl=impl)
            logits.append(lg)
            first = make_head(model, mesh=mesh, rules=rules)(lg)
        toks, state = decode_loop(model, params, state, first, STEPS, mesh,
                                  rules=rules, greedy=greedy, generator=gen,
                                  logits_out=logits)
    finally:
        ref.decode_attention = plain_b9
    return {"tokens": _np(toks), "rows": _np(rows), "vocab": _np(vocab),
            "logits": [_np(x) for x in logits],
            "length": int(state.length), "b9_rows": sorted(set(seen)),
            "counts": ops.local_shard_counts(),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "params_local": {n: tuple(p.to_local().shape)
                             for n, p in params.named_parameters()},
            "state_local": {f: tuple(getattr(state, f).shape)
                            for f in state._fields
                            if isinstance(getattr(state, f), torch.Tensor)}}


def head(inp) -> dict:
    """``topk_logits`` and ``naive_allgather_argmax`` across a model dim of
    4 ranks on this rank's vocab block of ``inp["head_logits"]``, and the
    collectives each recorded."""
    from repro_torch.core import exchange
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.serve import sampling

    mesh = parse_mesh("1x4", "cpu")
    full = torch.from_numpy(inp["head_logits"])
    P = mesh.size(1)
    c = full.shape[1] // P
    local = full[:, mesh.get_coordinate()[1] * c:][:, :c]
    exchange.reset_collective_record()
    vals, ids = sampling.topk_logits(local, inp["k"], mesh=mesh,
                                     axes=("model",))
    rec = [(r.name, r.kind, r.bytes) for r in exchange.collective_record()]
    exchange.reset_collective_record()
    naive = sampling.naive_allgather_argmax(local, mesh=mesh,
                                            axes=("model",))
    naive_rec = [(r.name, r.kind, r.bytes)
                 for r in exchange.collective_record()]
    return {"values": _np(vals), "ids": _np(ids), "record": rec,
            "naive": _np(naive), "naive_record": naive_rec}


def example() -> dict:
    """The example's ``main`` at ``--mesh 2x2`` on the CPU."""
    sys.path.insert(0, str(__import__("pathlib").Path(__file__)
                           .resolve().parents[2] / "examples"))
    import decode_distributed_topk_torch as ex

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ex.main(["--mesh", "2x2", "--device", "cpu"])
    return {"rc": rc, "out": buf.getvalue()}


def refuse_moe() -> str:
    """The serve step's refusal of the MoE family on a mesh of 2 ranks."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models.model import build
    from repro_torch.serve.engine import make_serve_step

    try:
        make_serve_step(build(get_arch("qwen3-moe-30b-a3b", smoke=True)),
                        parse_mesh("2x1", "cpu"))
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
        from repro_torch.configs import SHAPES, get_arch
        from repro_torch.launch import mesh as launch_mesh
        from repro_torch.launch.cells import decode_opt_layout

        launch_mesh.init_from_env("cpu")
        parse = launch_mesh.parse_mesh
        if spawn == "w4":
            res["2x2"] = serve(inp, parse("2x2", "cpu"), None, 2)
            res["2x2_int8"] = serve(inp, parse("2x2", "cpu"), None, 2,
                                    quant=True)
            mesh, rules, tp, tp_kv = decode_opt_layout(
                get_arch(inp["arch"], smoke=True), SHAPES["decode_32k"],
                chips=4, data=1, device_type="cpu")
            res["opt_layout"] = (tp, tp_kv)
            for quant in (False, True):
                res["opt_int8" if quant else "opt"] = serve(
                    inp, mesh, rules, tp, tp_kv=tp_kv, quant=quant)
            res["head"] = head(inp)
            res["example"] = example()
        else:
            res["1x2"] = serve(inp, parse("1x2", "cpu"), None, 2)
            res["2x1"] = serve(inp, parse("2x1", "cpu"), None, 1, impl="xla")
            res["sampled"] = serve(inp, parse("1x2", "cpu"), None, 2,
                                   greedy=False)
            res["refuse_moe"] = refuse_moe()
        dist.barrier()
    except Exception:  # noqa: BLE001 - reported to the test
        res["error"] = traceback.format_exc()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
