"""The port's serving under a mesh against the JAX package, on the CPU at
the qwen2.5-3b SMOKE size (2 layers, d_model 64, 4 / 2 heads, f32).

Two spawns of ``tests/fixtures/torch_serve_worker.py`` run at once (4
ranks, then 2: six processes, one torch thread each), each rank a process
with torchrun's variables, over gloo:

- ``w4``: the float cache at (2, 2) (B7's plain version on local
  blocks), the int8 cache at (2, 2), both caches in the decode-opt layout
  (1, 2, 2) of ``decode_opt_layout(chips=4, data=1)`` (``tp`` 4,
  ``tp_kv`` 2), the §3.2.3 head across a model dim of 4 ranks, and the
  example at ``--mesh 2x2``;
- ``w2``: the float cache at (1, 2) (B7) and (2, 1) (xla), a sampled
  decode at (1, 2), and the MoE family refused on (2, 1).

Each mesh starts from the JAX SMOKE parameters (biases made non-zero)
carried across; a prefill of 16 tokens (the int8 cache: the prompt one
token a step) and 8 greedy steps.  The float meshes are held against the
JAX package's unsharded jitted ``prefill`` / ``decode_step`` plus argmax
(its own flash prefill for the port's B7 meshes, its xla one for (2, 1)):
the same tokens, the logits gathered from the ranks' blocks within
``F32_TOL`` of ``tests/test_torch_lm.py``.  JAX built with ``tp`` 2, or 4
with ``tp_kv`` 2, pads no head at this size, so one reference serves
every mesh (checked).  The JAX package's own sharded serve step fails on
JAX 0.9 (``ROADMAP.md`` §C); its ``topk_logits`` under ``shard_map``
runs and holds the head.  The int8 meshes are held against the port's
one-device int8 path, which ``test_decode_steps_match_jax[..int8]`` holds
against JAX.  The layout math (``choose_decode_layout``, the decode-opt
rules, ``pick_microbatches``) is held against JAX's on abstract meshes.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Shard

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.launch import cells as jax_cells
from repro.models import runtime as jax_runtime
from repro.models.model import build as jax_build
from repro.models.params import values
from repro.serve.sampling import topk_logits as jax_topk_logits
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.kernels import ops
from repro_torch.launch import cells
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import runtime
from repro_torch.models import sharding as SH
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build
from repro_torch.serve.engine import decode_loop
from test_torch_lm import F32_TOL
from test_torch_sharded_train import _collect, _free_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "fixtures" / "torch_serve_worker.py"
ARCH = "qwen2.5-3b"
B, S, STEPS, K = 4, 16, 8, 8
# mesh -> (spawn, the record's key, JAX's attention for the prefill, tp,
# tp_kv)
FLOAT = {"2x2": ("w4", "2x2", "flash", 2, None),
         "1x2": ("w2", "1x2", "flash", 2, None),
         "2x1": ("w2", "2x1", "xla", 1, None),
         "opt": ("w4", "opt", "flash", 4, 2)}
INT8 = {"2x2": ("w4", "2x2_int8", 2, None), "opt": ("w4", "opt_int8", 4, 2)}


def _jax_params(tp: int, tp_kv=None) -> dict:
    """The JAX SMOKE parameters built with ``tp`` and ``tp_kv``, numpy;
    the QKV biases made non-zero (as in test_torch_lm)."""
    tree = jax.tree.map(np.asarray, values(jax_build(
        jax_get_arch(ARCH, smoke=True), tp=tp, tp_kv=tp_kv).init(
            jax.random.key(0))))
    rng = np.random.default_rng(0)
    for b in ("bq", "bk", "bv"):
        a = tree["layers"]["attn"][b]
        tree["layers"]["attn"][b] = (0.1 * rng.normal(size=a.shape)
                                     ).astype(np.float32)
    return tree


def _head_logits() -> np.ndarray:
    """(B, 512) seeded logits with ties planted: at the top across shards
    (ids 7 and 300), at the top inside a shard, and straddling the k-th
    value."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, 512)).astype(np.float32)
    top = x.max() + 1.0
    x[0, [7, 300]] = top
    x[1, [130, 131, 500]] = top
    x[2, [3, 129, 257, 385]] = np.sort(x[2])[-K]
    return x


def _jax_serve(params, prompt, impl):
    """JAX's unsharded jitted prefill + greedy decode_step: (tokens
    (B, STEPS + 1), the logits of the prefill and of each step)."""
    jm = jax_build(jax_get_arch(ARCH, smoke=True))
    jp = jax.tree.map(jnp.asarray, params)
    prefill = jax.jit(lambda p, t, s: jm.prefill(p, {"tokens": t}, s,
                                                 attn_impl=impl))
    step = jax.jit(jm.decode_step)
    logits, st = prefill(jp, jnp.asarray(prompt),
                         jm.init_decode_state(B, 32, dtype=jnp.float32))
    out = [np.asarray(logits)]
    toks = [np.asarray(jnp.argmax(logits, -1))]
    for _ in range(STEPS):
        logits, st = step(jp, st, jnp.asarray(toks[-1])[:, None])
        out.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    return np.stack(toks, axis=1), out


def _port_int8(params, prompt):
    """The port's one-device int8 path: the prompt one token a step, then
    greedy steps -> (tokens, logits)."""
    model = build(get_arch(ARCH, smoke=True), cache_quant=True)
    p = params_from_jax(params)
    st = model.init_decode_state(B, 32, device="cpu")
    logits = []
    t = torch.from_numpy(prompt)
    fed, st = decode_loop(model, p, st, t[:, 0], S, forced=t[:, 1:],
                          logits_out=logits)
    toks, st = decode_loop(model, p, st, fed[:, -1], STEPS,
                           logits_out=logits)
    return toks.numpy(), [x.numpy() for x in logits]


def _spawn(spawn: str, world: int, inp, out: pathlib.Path) -> list:
    src = str(ROOT / "src")
    base = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                PYTHONPATH=os.pathsep.join(
                    [src] + [p for p in os.environ.get("PYTHONPATH", "")
                             .split(os.pathsep) if p]))
    procs = []
    for rank in range(world):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, str(WORKER), spawn, str(inp), str(out)],
            env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank)),
            stdout=log, stderr=subprocess.STDOUT)))
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns' per-rank results (the spawns run at once) and the
    references, computed meanwhile."""
    params = _jax_params(1)
    for tp, tp_kv in ((2, None), (4, 2)):
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(params), jax.tree.leaves(_jax_params(tp, tp_kv))))
    prompt = np.random.default_rng(10).integers(
        0, get_arch(ARCH, smoke=True).vocab_size, (B, S)).astype(np.int64)
    inp = tmp_path_factory.mktemp("inputs") / "inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"arch": ARCH, "params": params, "prompt": prompt,
                     "head_logits": _head_logits(), "k": K}, f)
    outs = {s: tmp_path_factory.mktemp(s) for s in ("w4", "w2")}
    procs = {s: _spawn(s, w, inp, outs[s]) for s, w in (("w4", 4),
                                                       ("w2", 2))}
    try:
        ref = {"jax": {impl: _jax_serve(params, prompt, impl)
                       for impl in ("flash", "xla")},
               "int8": _port_int8(params, prompt), "params": params}
    except BaseException:
        for log, p in [x for v in procs.values() for x in v]:
            p.kill()
            p.wait()
            log.close()
        raise
    return {**ref, **{s: _collect(procs[s], outs[s], s) for s in procs}}


def _assemble(ranks: list, key: str):
    """(tokens (B, n), [logits (B, V) a step]) from the ranks' blocks of
    run ``key``: every element held by some rank, replicas equal."""
    first = ranks[0][key]
    V = get_arch(ARCH, smoke=True).padded_vocab()
    toks = np.full((B, first["tokens"].shape[1]), -1, np.int64)
    logits = [np.full((B, V), np.nan, np.float32) for _ in first["logits"]]
    for r in ranks:
        rec = r[key]
        rows, vocab = rec["rows"], rec["vocab"]
        held = toks[rows]
        assert np.all((held == -1) | (held == rec["tokens"])), r["rank"]
        toks[rows] = rec["tokens"]
        for dst, src in zip(logits, rec["logits"], strict=True):
            held = dst[np.ix_(rows, vocab)]
            assert np.all(np.isnan(held) | (held == src)), f"rank {r['rank']}"
            dst[np.ix_(rows, vocab)] = src
    assert (toks >= 0).all() and not any(np.isnan(x).any() for x in logits)
    return toks, logits


# ---------------------------------------------------------------------------
# the mesh path against JAX and the one-device path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(FLOAT))
def test_mesh_path_matches_jax(runs, mesh):
    """Prefill + 8 greedy steps on the float cache: JAX's tokens, logits
    within F32_TOL; B7 on local blocks once a layer on the flash
    meshes."""
    spawn, key, impl, _, _ = FLOAT[mesh]
    want_toks, want_logits = runs["jax"][impl]
    toks, logits = _assemble(runs[spawn], key)
    np.testing.assert_array_equal(toks, want_toks)
    for t, (g, w) in enumerate(zip(logits, want_logits, strict=True)):
        np.testing.assert_allclose(g, w, **F32_TOL, err_msg=f"step {t}")
    n_layers = get_arch(ARCH, smoke=True).n_layers
    for r in runs[spawn]:
        rec = r[key]
        assert rec["length"] == S + STEPS
        assert rec["counts"] == {
            "flash_attention_fwd": n_layers if impl == "flash" else 0,
            "flash_attention_bwd": 0, "decode_attention": 0}


@pytest.mark.parametrize("mesh", sorted(INT8))
def test_int8_cache_matches_one_device(runs, mesh):
    """The prompt one token a step and 8 greedy steps on the int8 cache:
    the one-device path's tokens and logits (F32_TOL); every B9 call on
    the rank's (B*KV) / shards rows, counted on local blocks."""
    spawn, key, tp, tp_kv = INT8[mesh]
    want_toks, want_logits = runs["int8"]
    toks, logits = _assemble(runs[spawn], key)
    np.testing.assert_array_equal(toks, want_toks)
    for t, (g, w) in enumerate(zip(logits, want_logits, strict=True)):
        np.testing.assert_allclose(g, w, **F32_TOL, err_msg=f"step {t}")
    cfg = get_arch(ARCH, smoke=True)
    KV = cfg.padded_heads(tp, tp_kv)[1]
    for r in runs[spawn]:
        rec = r[key]
        sizes = rec["mesh"]
        shards = 1
        for ax in ("data", "model_b", "model_kv") if mesh == "opt" else (
                "data", "model"):
            shards *= sizes[ax]
        assert rec["b9_rows"] == [B * KV // shards]
        assert rec["counts"] == {"flash_attention_fwd": 0,
                                 "flash_attention_bwd": 0,
                                 "decode_attention": cfg.n_layers
                                 * (S + STEPS)}


def test_decode_opt_layout_on_four_ranks(runs):
    """decode_opt_layout(chips=4, data=1) splits the model ranks into
    (model_kv 2, model_b 2) for qwen2.5-3b's 2 kv heads: tp 4, tp_kv 2."""
    for r in runs["w4"]:
        assert r["opt_layout"] == (4, 2)
        assert r["opt"]["mesh"] == {"data": 1, "model_kv": 2, "model_b": 2}


def _want_local(shape: tuple, axes, mesh: dict, rules) -> tuple:
    mshape = SH.MeshShape(tuple(mesh), tuple(mesh.values()))
    local = list(shape)
    for ax, pl in zip(mesh, SH.resolve(axes, mshape, rules)):
        if isinstance(pl, Shard):
            local[pl.dim] //= mesh[ax]
    return tuple(local)


@pytest.mark.parametrize("key", ["2x2", "2x2_int8", "opt", "opt_int8"])
def test_each_rank_holds_its_blocks(runs, key):
    """Every cache tensor's and parameter's block on every rank is its
    whole divided by the mesh dims ``resolve`` assigns it, so no tensor
    the rules split is replicated; each mesh dim of more than one rank
    splits some cache tensor, and each but ``model_b`` some parameter."""
    quant = key.endswith("int8")
    opt = key.startswith("opt")
    tp, tp_kv = (4, 2) if opt else (2, None)
    rules = cells.decode_opt_rules() if opt else SH.DEFAULT_RULES
    model = build(get_arch(ARCH, smoke=True), tp=tp, tp_kv=tp_kv,
                  cache_quant=quant)
    full = model.init_decode_state(B, 32, torch.float32, device="meta")
    axes = model.decode_state_axes()
    meta = model._init(None)
    for r in runs["w4"]:
        rec = r[key]
        mesh = rec["mesh"]
        want = {f: _want_local(tuple(getattr(full, f).shape),
                               getattr(axes, f), mesh, rules)
                for f in rec["state_local"]}
        assert rec["state_local"] == want, f"rank {r['rank']}"
        want = {n: _want_local(tuple(p.shape), p.axes, mesh, rules)
                for n, p in meta.named_parameters()}
        assert rec["params_local"] == want, f"rank {r['rank']}"
    mshape = SH.MeshShape(tuple(mesh), tuple(mesh.values()))
    # the weights stay whole over model_b, by the decode-opt rules
    for tree, unsplit in (([getattr(axes, f) for f in rec["state_local"]],
                           set()),
                          ([p.axes for p in meta.parameters()],
                           {"model_b"})):
        split = {ax for t in tree
                 for ax, pl in zip(mesh, SH.resolve(t, mshape, rules))
                 if isinstance(pl, Shard) and mesh[ax] > 1}
        assert split == {ax for ax, n in mesh.items() if n > 1} - unsplit


# ---------------------------------------------------------------------------
# the §3.2.3 head across ranks
# ---------------------------------------------------------------------------


def test_head_matches_jax_shard_map(runs):
    """topk_logits across a model dim of 4 ranks: JAX's values and ids
    under shard_map on a (1, 4) CPU mesh, ties included, on every rank."""
    logits = _head_logits()
    mesh = jax.make_mesh((1, 4), ("data", "model"),
                         devices=jax.devices()[:4])
    vals, ids = jax.jit(jax.shard_map(
        lambda local: jax_topk_logits(local, K, axis="model"), mesh=mesh,
        in_specs=JP(None, "model"), out_specs=JP(), check_vma=False,
    ))(jnp.asarray(logits))
    for r in runs["w4"]:
        np.testing.assert_array_equal(r["head"]["ids"], np.asarray(ids))
        np.testing.assert_array_equal(r["head"]["values"], np.asarray(vals))
    assert list(np.asarray(ids)[0, :2]) == [7, 300]


def test_head_wire_bytes(runs):
    """The head's record: log2 P = 2 rounds, each a permute of B*k values
    and one of B*k ids, below the naive all-gather's bytes; the naive
    head's argmax equals the full row's."""
    for r in runs["w4"]:
        rec = r["head"]["record"]
        assert [(n, kind) for n, kind, _ in rec] == [
            (f"topk_butterfly{i}", "collective-permute")
            for i in (0, 0, 1, 1)]
        assert all(b == B * K * 4 for _, _, b in rec)
        naive = r["head"]["naive_record"]
        assert naive == [("naive_allgather", "all-gather", B * 128 * 4)]
        assert sum(b for *_, b in rec) < sum(b for *_, b in naive)
        np.testing.assert_array_equal(r["head"]["naive"],
                                      _head_logits().argmax(-1))


def test_sampled_decode_draws_alike(runs):
    """A sampled decode at (1, 2), each rank's generator seeded alike:
    every rank draws the same token on every step, each among its step's
    global top k."""
    ranks = runs["w2"]
    toks, logits = _assemble(ranks, "sampled")
    for r in ranks:
        np.testing.assert_array_equal(r["sampled"]["tokens"], toks)
    for t, lg in enumerate(logits[1:]):
        top = np.argsort(-lg, axis=-1, kind="stable")[:, :K]
        assert all(toks[b, t + 1] in top[b] for b in range(B))


def test_example_tokens_equal_the_mesh_path(runs):
    """examples/decode_distributed_topk_torch.py at --mesh 2x2: rank 0
    alone prints 4 streams of 17 tokens and the cache length 16, the
    tokens of the one-device path on the same parameters."""
    cfg = get_arch(ARCH, smoke=True)
    model = build(cfg, tp=2)
    st = model.init_decode_state(B, 32, torch.float32, device="cpu")
    want, _ = decode_loop(model, model.init(0, device="cpu"), st,
                          torch.zeros(B, dtype=torch.long), 16)
    for r in runs["w4"]:
        ex = r["example"]
        assert ex["rc"] == 0
        if r["rank"] != 0:
            assert ex["out"] == ""
            continue
        streams = [[int(x) for x in m.split(",")] for m in
                   re.findall(r"seq \d+: \[([^\]]*)\]", ex["out"])]
        np.testing.assert_array_equal(np.array(streams), want.numpy())
        assert "cache length: 16" in ex["out"]


def test_other_family_refused_on_two_ranks(runs):
    for r in runs["w2"]:
        assert "item 11.4" in r["refuse_moe"]
        assert "'moe'" in r["refuse_moe"]


# ---------------------------------------------------------------------------
# in one process: the layout math against JAX's, a mesh of one rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_choose_decode_layout_matches_jax(arch):
    """Every decode shape x chips {4, 16, 256} x data {1, 16 where it
    divides}: the same layout, or both raise."""
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for shape in ("decode_32k", "long_500k"):
        for chips in (4, 16, 256):
            for data in (1, 16):
                if chips % data:
                    continue
                try:
                    want = jax_cells.choose_decode_layout(
                        jcfg, JAX_SHAPES[shape], chips=chips, data=data)
                except AssertionError:
                    with pytest.raises(ValueError, match="no valid"):
                        cells.choose_decode_layout(
                            cfg, SHAPES[shape], chips=chips, data=data)
                    continue
                assert cells.choose_decode_layout(
                    cfg, SHAPES[shape], chips=chips, data=data) == want


@pytest.mark.parametrize("dims,names", [
    ((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model"))])
def test_pick_microbatches_matches_jax(dims, names):
    cfg, jcfg = get_arch(ARCH), jax_get_arch(ARCH)
    for shape in ("train_4k", "decode_32k"):
        assert cells.pick_microbatches(
            cfg, SHAPES[shape], SH.MeshShape(names, dims)) == \
            jax_cells.pick_microbatches(jcfg, JAX_SHAPES[shape],
                                        AbstractMesh(dims, names))


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo group of this process alone, destroyed after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'st'}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        launch_mesh.destroy()


def test_decode_opt_rules_match_jax(one_rank_group):
    """decode_opt_layout's rules dict is JAX's; on one rank its mesh is
    (1, 1, 1) over (data, model_kv, model_b)."""
    cfg, jcfg = get_arch(ARCH), jax_get_arch(ARCH)
    _, jrules, jtp, jtp_kv = jax_cells.decode_opt_layout(
        jcfg, JAX_SHAPES["decode_32k"], chips=4, data=1)
    mesh, rules, tp, tp_kv = cells.decode_opt_layout(
        cfg, SHAPES["decode_32k"], chips=1, data=1, device_type="cpu")
    assert rules == jrules and (jtp, jtp_kv) == (4, 2)
    assert mesh.mesh_dim_names == ("data", "model_kv", "model_b")
    assert tuple(mesh.shape) == (1, 1, 1) and (tp, tp_kv) == (1, 1)
    # B9's fused (B*KV) dim: the batch axes outer, the kv-head axes inner
    with runtime.mesh_rules(mesh, rules), jax_runtime.mesh_rules(
            AbstractMesh((1, 2, 2), cells.DECODE_OPT_AXES), jrules):
        assert runtime.fused_bkv_spec() == jax_runtime.fused_bkv_spec() \
            == ("data", "model_b", "model_kv")


def test_one_rank_cells_equal_the_device_path(one_rank_group):
    """On a mesh (1, 1) build_cell's prefill step and the serve step give
    the device path's logits and tokens exactly (no collective on a dim
    of one rank); the cuts are listed; a train cell, run_cell and an
    unrunnable cell raise; a DTensor never reaches B9."""
    cfg = get_arch(ARCH, smoke=True)
    mesh = launch_mesh.parse_mesh("1x1", "cpu")
    model = build(cfg)
    p = model.init(0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8)))
    lg, st = model.prefill(p, {"tokens": prompt}, model.init_decode_state(
        2, 16, torch.float32, device="cpu"), attn_impl="flash")
    want, _ = decode_loop(model, p, st, lg.argmax(-1), 4)
    cell = cells.build_cell(ARCH, "prefill_32k", mesh, smoke=True, batch=2,
                            seq_len=16, params=p)
    assert cell.reduced == ("global_batch 32 -> 2", "seq_len 32768 -> 16")
    glg, gst = cell.step(cell.params, {"tokens": cell.local(prompt)},
                         attn_impl="flash")
    assert torch.equal(glg, lg)
    dec = cells.build_cell(ARCH, "decode_32k", mesh, smoke=True, batch=2,
                           seq_len=16, params=cell.params)
    assert dec.params is cell.params
    got, _ = decode_loop(dec.model, dec.params, gst, glg.argmax(-1), 4, mesh,
                         rules=dec.rules)
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="item 11.6"):
        cells.build_cell(ARCH, "train_4k", mesh, smoke=True)
    with pytest.raises(NotImplementedError, match="item 11.6"):
        cells.run_cell(ARCH, "decode_32k", mesh, "1x1")
    with pytest.raises(ValueError, match="cell skipped"):
        cells.build_cell(ARCH, "long_500k", mesh, smoke=True)
    from torch.distributed.tensor import DTensor, Replicate

    q = DTensor.from_local(torch.zeros(2, 2, 16), mesh,
                           [Replicate(), Replicate()])
    with runtime.mesh_rules(mesh), pytest.raises(ValueError, match="plain"):
        ops.decode_attention(q, q, q, torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-2.7b"])
def test_one_rank_mesh_serves_other_families(one_rank_group, arch):
    """Another family serves on a mesh of one rank as on the device."""
    cfg = get_arch(arch, smoke=True)
    mesh = launch_mesh.parse_mesh("1x1", "cpu")
    model = build(cfg)
    p = model.init(0, device="cpu")
    first = torch.tensor([1, 2])
    want, _ = decode_loop(model, p, model.init_decode_state(
        2, 8, torch.float32, device="cpu"), first, 4)
    cell = cells.build_cell(arch, "decode_32k", mesh, smoke=True, batch=2,
                            seq_len=8, params=p)
    got, _ = decode_loop(cell.model, cell.params, cell.state, first, 4, mesh,
                         rules=cell.rules)
    assert torch.equal(got, want)
