"""The port's MoE family against the JAX package, on the CPU at the SMOKE
sizes of qwen3-moe-30b-a3b (8 experts, top 2) and phi3.5-moe-42b-a6.6b
(4 experts, top 2): ``capacity``, ``apply_moe`` and ``load_balance_stats``,
``exchange_vectors_by_owner`` and ``moe_block_sharded`` against the JAX
functions under ``shard_map``, and the whole model (``Model.hidden``,
``prefill``, ``decode_step`` on both caches, ``decode_loop``, ``loss``).
The JAX parameters are carried across by ``params_from_jax``; inputs come
from numpy seeds.  The port is held against the unsharded JAX ``Model``
functions: the JAX sharded serve step fails on JAX 0.9 (``ROADMAP.md``
§C).

Tolerances: f32 1e-4 relative and absolute, as ``tests/test_torch_lm.py``;
the sharded dispatch 2e-3 (``tests/test_moe_dispatch.py``'s bound).  Which
pairs an expert keeps is exact: the loads and the dropped share equal
JAX's.  bf16 needs bounds of its own here:

- A bf16 block output reaches about 40 (qwen3-moe) and 150 (phi3.5-moe)
  with the SMOKE weights, where one bf16 rounding is 0.125 and 0.5, and the
  two packages round its three products and the weighting at different
  places.  The block is held within 2^-6 of JAX's largest |output|, and no
  further than twice JAX's own distance from the block computed in f32 on
  the same bf16 inputs.
- Through the model, the hidden states two packages feed the router differ
  by bf16 roundings, and a token whose k-th and (k+1)-th expert lie within
  such a rounding of a tie takes another expert in one package than in the
  other, which moves its hidden state by O(1); JAX's own bf16 model
  differs from its f32 model in the same way.  No bound on values tells
  that from a fault.  So the bf16 model cases route every token to all
  experts (top k = number of experts), where the block is continuous in
  its input, and hold hidden states, logits and cache contents within
  0.05 of the largest |value| (the bound ``chip_smoke.py`` puts on
  full-width bf16 paths that differ in where f32 results are rounded; the
  dense model's 5e-2 absolute is too tight here, as the MoE residual
  stream carries the larger block outputs of the JAX init).  The top-2
  routing in bf16 is held by the block case above and by the greedy
  tokens of the whole slice, which equal JAX's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jax_get_arch
from repro.core import exchange as jex
from repro.models import moe as jmoe
from repro.models.model import build as jax_build
from repro.models.moe_dispatch import moe_block_sharded as jax_sharded
from repro.models.params import values
from repro_torch.configs import get_arch
from repro_torch.core import exchange
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.convert import jax_layout, params_from_jax
from repro_torch.models.model import build
from repro_torch.models.moe_dispatch import moe_block_sharded
from repro_torch.serve.engine import decode_loop, make_serve_step

QWEN, PHI = "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
DISPATCH_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_SHARE = 0.05           # of the largest |value|, bf16 model cases
DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def _cfgs(arch: str, dtype: str = "f32", cf: float | None = None,
          all_experts: bool = False):
    """(JAX config, port config) of ``arch``'s SMOKE size in ``dtype``,
    at capacity factor ``cf``, with every expert routed where
    ``all_experts``."""
    out = []
    for cfg in (jax_get_arch(arch, smoke=True), get_arch(arch, smoke=True)):
        cfg = dataclasses.replace(cfg, compute_dtype=DTYPES[dtype])
        m = cfg.moe
        if cf is not None:
            m = dataclasses.replace(m, capacity_factor=cf)
        if all_experts:
            m = dataclasses.replace(m, top_k=m.num_experts)
        out.append(dataclasses.replace(cfg, moe=m))
    return out[0], out[1]


def _model_cfgs(arch: str, dtype: str):
    """The model cases' configs: bf16 routes every token to all experts
    (the module docstring says why)."""
    return _cfgs(arch, dtype, all_experts=dtype == "bf16")


_TREES: dict = {}


def _tree(arch: str) -> dict:
    """The JAX SMOKE parameters of ``arch`` (seed 0), as numpy."""
    if arch not in _TREES:
        cfg = jax_get_arch(arch, smoke=True)
        _TREES[arch] = jax.tree.map(
            np.asarray, values(jax_build(cfg).init(jax.random.key(0))))
    return _TREES[arch]


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _layer0(arch: str) -> dict:
    return {k: v[0] for k, v in _tree(arch)["layers"]["moe"].items()}


def _tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got: torch.Tensor, want, dtype: str = "f32"):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_SHARE * np.abs(want).max()


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0, 4.0])
def test_capacity_matches_jax(cf):
    for n in (1, 4, 7, 64, 100, 16384):
        for e, k in ((4, 2), (8, 2), (16, 2), (128, 8)):
            assert moe.capacity(n, e, k, cf) == jmoe.capacity(n, e, k, cf)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", [QWEN, PHI])
def test_apply_moe_matches_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    p = _layer0(arch)
    x = _x((2, 24, jcfg.d_model), 1)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = jmoe.apply_moe(_j(p), jx, jcfg)
    got = moe.apply_moe(_t(p), tx, tcfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "f32":
        _close(got, want)
        return
    # the block in f32 on the bf16-rounded inputs and weights (the router
    # is used in f32 by both)
    pb = {k: v if k == "router" else v.to(torch.bfloat16).float()
          for k, v in _t(p).items()}
    exact = moe.apply_moe(pb, tx.float(), dataclasses.replace(
        tcfg, compute_dtype="float32")).numpy()
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2 ** -6 * np.abs(want).max()
    assert (np.abs(got - exact).max()
            <= 2 * np.abs(want - exact).max() + 1e-6)


@pytest.mark.parametrize("arch", [QWEN, PHI])
def test_forced_drop_matches_jax(arch):
    """cf 0.5 over 64 tokens: experts drop pairs.  The same pairs are
    kept (the loads and the dropped share equal JAX's exactly), and the
    outputs agree within f32 tolerance."""
    jcfg, tcfg = _cfgs(arch, "f32", cf=0.5)
    p = _layer0(arch)
    x = _x((1, 64, jcfg.d_model), 2)
    ws = jmoe.load_balance_stats(_j(p), jnp.asarray(x), jcfg)
    gs = moe.load_balance_stats(_t(p), torch.from_numpy(x), tcfg)
    assert float(gs["drop_frac"]) > 0
    assert gs["expert_load"].dtype == torch.float32
    np.testing.assert_array_equal(gs["expert_load"].numpy(),
                                  np.asarray(ws["expert_load"]))
    np.testing.assert_array_equal(gs["drop_frac"].numpy(),
                                  np.asarray(ws["drop_frac"]))
    want = jmoe.apply_moe(_j(p), jnp.asarray(x), jcfg)
    got = moe.apply_moe(_t(p), torch.from_numpy(x), tcfg)
    _close(got, want)


def test_dropped_pairs_add_nothing():
    """At cf 0.5 the block equals the sum over the kept pairs only, each
    expert's FFN computed alone on its token (f32)."""
    _, tcfg = _cfgs(QWEN, "f32", cf=0.5)
    p = _t(_layer0(QWEN))
    x = torch.from_numpy(_x((64, tcfg.d_model), 3))
    m = tcfg.moe
    C = moe.capacity(64, m.num_experts, m.top_k, 0.5)
    top_p, top_e = moe.route(p["router"], x, m.top_k)
    want = torch.zeros_like(x)
    seen = [0] * m.num_experts
    for t in range(64):                 # the (token, k) order of the sort
        for k in range(m.top_k):
            e = int(top_e[t, k])
            if seen[e] < C:
                h = x[t] @ p["w_gate"][e]
                h = torch.nn.functional.silu(h) * (x[t] @ p["w_up"][e])
                want[t] += top_p[t, k] * (h @ p["w_down"][e])
            seen[e] += 1
    assert sum(max(s - C, 0) for s in seen) > 0
    got = moe.apply_moe(p, x[None], tcfg)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


# ---------------------------------------------------------------------------
# the exchange and the sharded dispatch
# ---------------------------------------------------------------------------


def _exchange_inputs(P, n, d, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1000, (P, n)).astype(np.int32)
    owner = rng.integers(0, P, (P, n)).astype(np.int32)
    mask = rng.random((P, n)) < 0.8
    vecs = rng.normal(size=(P, n, d)).astype(np.float32)
    vecs[..., 0] = np.arange(P * n).reshape(P, n)   # each row names its pair
    return keys, vecs, mask, owner


@pytest.mark.parametrize("cap", [16, 2], ids=["ample", "overflow"])
@pytest.mark.parametrize("backend", ["xla", "one_factor"])
def test_exchange_vectors_by_owner_matches_jax(backend, cap):
    """Against the JAX function under shard_map on 8 devices: the keys,
    the mask, each pair's (dest, slot) and the overflow flag equal, and
    the rows equal where no bucket overflowed.  Past a full bucket the
    JAX function writes the dropped rows into the bucket's last slot
    (``ROADMAP.md`` §C); the port's every delivered slot holds its own
    pair's row."""
    P, n, d = 8, 24, 5
    keys, vecs, mask, owner = _exchange_inputs(P, n, d, 7)
    mesh = jax.make_mesh((P,), ("nodes",), devices=jax.devices()[:P])

    def fn(k, v, m, o):
        rk, rv, rm, (dst, slt), ovf = jex.exchange_vectors_by_owner(
            k, v, m, o, capacity=cap, axis="nodes", backend=backend)
        return rk, rv, rm, dst, slt, ovf[None]

    spec = JP("nodes")
    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 4,
                                out_specs=(spec,) * 6, check_vma=False))(
        *(jnp.asarray(a.reshape(P * n, *a.shape[2:]))
          for a in (keys, vecs, mask, owner)))
    wk, wv, wm, wd, ws, wo = (np.asarray(a) for a in out)
    gk, gv, gm, (gd, gs), go = exchange.exchange_vectors_by_owner(
        torch.from_numpy(keys), torch.from_numpy(vecs),
        torch.from_numpy(mask), torch.from_numpy(owner), capacity=cap,
        backend=backend)
    assert gv.shape == (P, P, cap, d)
    np.testing.assert_array_equal(gk.numpy(), wk.reshape(P, P, cap))
    np.testing.assert_array_equal(gm.numpy(), wm.reshape(P, P, cap))
    np.testing.assert_array_equal(gd.numpy(), wd.reshape(P, n))
    np.testing.assert_array_equal(gs.numpy(), ws.reshape(P, n))
    assert bool(go) == bool(wo.any()) == (cap == 2)
    if cap == 16:
        np.testing.assert_array_equal(gv.numpy(), wv.reshape(P, P, cap, d))
    # every delivered slot holds the row of the pair whose key it holds
    for dst in range(P):
        for src in range(P):
            for c in range(cap):
                if gm[dst, src, c]:
                    j = int(gv[dst, src, c, 0]) - src * n
                    assert 0 <= j < n and keys[src, j] == int(gk[dst, src, c])
                    np.testing.assert_array_equal(gv[dst, src, c].numpy(),
                                                  vecs[src, j])
                else:
                    assert not gv[dst, src, c].any()


def _sharded_inputs(P, N):
    jcfg, tcfg = _cfgs(QWEN)
    lp = _layer0(QWEN)
    x = np.array(jax.random.normal(jax.random.key(1), (P * N,
                                                       jcfg.d_model)))
    E_local = jcfg.moe.num_experts // P
    tp = _t(lp)
    tp.update({k: tp[k].reshape(P, E_local, *tp[k].shape[1:])
               for k in ("w_gate", "w_up", "w_down")})
    return jcfg, tcfg, lp, x, tp


@pytest.mark.parametrize("backend", ["xla", "one_factor"])
def test_moe_block_sharded_matches_jax(backend):
    """Against the JAX block under shard_map over 4 devices (the JAX
    test's set-up: 64 tokens, cf 4.0), and against the port's apply_moe
    over all the tokens at cf 4.0."""
    P, N = 4, 16
    jcfg, tcfg, lp, x, tp = _sharded_inputs(P, N)
    mesh = jax.make_mesh((P,), ("model",), devices=jax.devices()[:P])

    def fn(x_local, router, wg, wu, wd):
        p = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
        y, ovf = jax_sharded(p, x_local, jcfg, axis="model", backend=backend,
                             capacity_factor=4.0)
        return y, ovf[None]

    want, wovf = jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(JP("model"), JP(), JP("model"), JP("model"), JP("model")),
        out_specs=(JP("model"), JP("model")), check_vma=False,
    ))(jnp.asarray(x), *(jnp.asarray(lp[k]) for k in
                         ("router", "w_gate", "w_up", "w_down")))
    got, ovf = moe_block_sharded(tp, torch.from_numpy(x).reshape(P, N, -1),
                                 tcfg, backend=backend, capacity_factor=4.0)
    assert not bool(ovf) and not np.asarray(wovf).any()
    np.testing.assert_allclose(got.reshape(P * N, -1).numpy(),
                               np.asarray(want), **DISPATCH_TOL)
    _, rcfg = _cfgs(QWEN, cf=4.0)
    dense = moe.apply_moe(_t(lp), torch.from_numpy(x)[None], rcfg)[0]
    np.testing.assert_allclose(got.reshape(P * N, -1).numpy(),
                               dense.numpy(), **DISPATCH_TOL)


@pytest.mark.parametrize("backend", ["xla", "one_factor"])
def test_moe_block_sharded_overflow_drops_pairs(backend):
    """A capacity too small for the routing: ``overflow`` is set and a
    pair past its owner's capacity adds nothing; the rest equals the sum
    over the delivered pairs, each expert's FFN on its token alone."""
    P, N = 4, 16
    _, tcfg, lp, x, tp = _sharded_inputs(P, N)
    xt = torch.from_numpy(x).reshape(P, N, -1)
    got, ovf = moe_block_sharded(tp, xt, tcfg, backend=backend,
                                 capacity_factor=0.01)
    m = tcfg.moe
    cap = int(N * m.top_k * 0.01 // P) + 8
    E_local = m.num_experts // P
    p = _t(lp)
    assert bool(ovf)
    want = torch.zeros_like(xt)
    dropped = 0
    for node in range(P):
        top_p, top_e = moe.route(p["router"], xt[node], m.top_k)
        sent = [0] * P
        for t in range(N):
            for k in range(m.top_k):
                e = int(top_e[t, k])
                o = e // E_local
                sent[o] += 1
                if sent[o] > cap:
                    dropped += 1
                    continue
                h = xt[node, t] @ p["w_gate"][e]
                h = torch.nn.functional.silu(h) * (xt[node, t] @ p["w_up"][e])
                want[node, t] += top_p[t, k] * (h @ p["w_down"][e])
    assert dropped > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_registry_serves_both_moe_architectures():
    for arch, E, K in ((QWEN, 128, 8), (PHI, 16, 2)):
        cfg = get_arch(arch)
        jcfg = jax_get_arch(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(get_arch(arch, smoke=True)) == \
            dataclasses.asdict(jax_get_arch(arch, smoke=True))
        assert (cfg.family, cfg.moe.num_experts, cfg.moe.top_k) == (
            "moe", E, K)
        model = build(cfg)
        assert model.cfg is cfg
        assert cfg.num_params() == jcfg.num_params()


@pytest.mark.parametrize("arch", [QWEN, PHI])
def test_init_and_params_from_jax_keep_the_moe_subtree(arch):
    """``Model.init`` builds the JAX tree's blocks and shapes (``moe`` in
    place of ``mlp``); ``params_from_jax`` keeps the subtree's values and
    dtypes (bf16 included) and ``jax_layout`` gives the tree back."""
    _, tcfg = _cfgs(arch)
    tree = _tree(arch)
    mine = build(tcfg).init(0, device="cpu")
    layout = jax_layout(mine)
    assert set(layout["layers"]) == set(tree["layers"]) == {
        "ln1", "attn", "ln2", "moe"}
    for blk, sub in tree["layers"].items():
        for k, v in sub.items():
            assert tuple(layout["layers"][blk][k].shape) == v.shape
    moe_tree = {k: v.astype(jnp.bfloat16) if k == "w_up" else v
                for k, v in tree["layers"]["moe"].items()}
    p = params_from_jax({**tree, "layers": {**tree["layers"],
                                            "moe": moe_tree}})
    assert p.layers[1].moe["w_up"].dtype == torch.bfloat16
    for i in range(2):
        for k, v in moe_tree.items():
            got = p.layers[i].moe[k]
            assert got.dtype == (torch.bfloat16 if k == "w_up"
                                 else torch.float32)
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(v[i], np.float32))
    back = jax_layout(p)["layers"]["moe"]
    np.testing.assert_array_equal(back["w_down"].numpy(),
                                  tree["layers"]["moe"]["w_down"])


def test_init_draws_experts_at_their_fan_in():
    """The port draws each expert weight over the square root of its
    product's fan-in (d, or f for ``w_down``), where the JAX init takes
    the expert count: the JAX weights' spread is sqrt(d / E) and
    sqrt(f / E) times the port's."""
    cfg = get_arch(QWEN)
    p = moe.init_moe(torch.Generator().manual_seed(0), dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_experts=8)))
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    for k, fan_in in (("router", d), ("w_gate", d), ("w_up", d),
                      ("w_down", f)):
        np.testing.assert_allclose(float(p[k].std()), fan_in ** -0.5,
                                   rtol=1e-2)
    tree = _tree(QWEN)["layers"]["moe"]
    E = jax_get_arch(QWEN, smoke=True).moe.num_experts
    np.testing.assert_allclose(float(tree["w_gate"].std()), E ** -0.5,
                               rtol=0.05)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", [QWEN, PHI])
def test_hidden_and_prefill_match_jax(arch, dtype):
    jcfg, tcfg = _model_cfgs(arch, dtype)
    toks = _tokens((2, 32), 5, jcfg.vocab_size)
    jm, tm = jax_build(jcfg), build(tcfg)
    jp, tp = _j(_tree(arch)), params_from_jax(_tree(arch))
    kw = dict(chunk_q=16, chunk_k=16, attn_impl="flash")
    want_h = jm.hidden(jp, {"tokens": jnp.asarray(toks)}, **kw)
    got_h = tm.hidden(tp, {"tokens": torch.from_numpy(toks)}, **kw)
    _close(got_h, want_h, dtype)
    want_l, want_c = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                                jm.init_decode_state(2, 40,
                                                     dtype=jnp.float32), **kw)
    got_l, got_c = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              tm.init_decode_state(2, 40, torch.float32,
                                                   device="cpu"), **kw)
    assert int(got_c.length) == got_c.host_length.n == 32
    _close(got_l, want_l, dtype)
    _close(got_c.k, want_c.k, dtype)
    _close(got_c.v, want_c.v, dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_steps_match_jax(dtype, quant):
    """Six qwen3-moe decode steps from an empty cache, logits each step."""
    jcfg, tcfg = _model_cfgs(QWEN, dtype)
    jm = jax_build(jcfg, cache_quant=quant)
    tm = build(tcfg, cache_quant=quant)
    jp, tp = _j(_tree(QWEN)), params_from_jax(_tree(QWEN))
    js = jm.init_decode_state(2, 16, dtype=getattr(jnp, jcfg.compute_dtype))
    ts = tm.init_decode_state(2, 16, getattr(torch, tcfg.compute_dtype),
                              device="cpu")
    toks = _tokens((2, 6), 6, jcfg.vocab_size)
    for t in range(6):
        want, js = jm.decode_step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        got, ts = tm.decode_step(tp, ts, torch.from_numpy(toks[:, t:t + 1]))
        _close(got, want, dtype)
    assert int(ts.length) == int(js.length) == ts.host_length.n == 6


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slice_greedy_tokens_match_jax(dtype):
    """qwen3-moe prefill (flash) + greedy ``decode_loop`` through the
    sharded head against JAX prefill + decode_step + argmax."""
    jcfg, tcfg = _cfgs(QWEN, dtype)
    jm, tm = jax_build(jcfg), build(tcfg)
    jp, tp = _j(_tree(QWEN)), params_from_jax(_tree(QWEN))
    prompt = _tokens((2, 16), 10, jcfg.vocab_size)
    steps = 8
    logits, js = jm.prefill(jp, {"tokens": jnp.asarray(prompt)},
                            jm.init_decode_state(
                                2, 32, dtype=getattr(jnp, jcfg.compute_dtype)),
                            attn_impl="flash")
    want = [np.asarray(jnp.argmax(logits, -1))]
    for _ in range(steps):
        logits, js = jm.decode_step(jp, js, jnp.asarray(want[-1])[:, None])
        want.append(np.asarray(jnp.argmax(logits, -1)))
    want = np.stack(want, axis=1)
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                        tm.init_decode_state(
                            2, 32, getattr(torch, tcfg.compute_dtype),
                            device="cpu"), attn_impl="flash")
    got, ts = decode_loop(tm, tp, ts, tl.argmax(-1), steps, shards=8)
    assert int(ts.length) == ts.host_length.n == 16 + steps
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", [QWEN, PHI])
def test_loss_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    toks = _tokens((2, 16), 11, jcfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jm, tm = jax_build(jcfg), build(tcfg)
    want = jm.loss(_j(_tree(arch)), {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)})
    got = tm.loss(params_from_jax(_tree(arch)),
                  {"tokens": torch.from_numpy(toks),
                   "labels": torch.from_numpy(labels)})
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), **F32_TOL)


_HOST_READS = ("item", "__int__", "__index__", "__bool__", "tolist")


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_decode_step_reads_nothing_from_the_device(monkeypatch, quant):
    """A qwen3-moe serve step with every way of reading a tensor on the
    host patched to raise: the MoE block's capacity and buffers follow
    from static shapes, so the step can be captured in a CUDA graph."""
    _, tcfg = _cfgs(QWEN)
    tm, tp = build(tcfg, cache_quant=quant), params_from_jax(_tree(QWEN))
    st = tm.init_decode_state(2, 8, torch.float32, device="cpu")
    step = make_serve_step(tm, shards=8, k=4)
    tok = torch.tensor([3, 5])

    def refuse(*a, **kw):
        raise AssertionError("a tensor was read on the host")

    with monkeypatch.context() as m:
        for name in _HOST_READS:
            m.setattr(torch.Tensor, name, refuse)
        nxt, st = step(tp, st, tok)
        nxt, st = step(tp, st, nxt)
    assert int(st.length) == st.host_length.n == 2
    assert nxt.shape == (2,)


def test_decode_step_is_deterministic():
    """Two runs of the same bf16 decode steps from copies of one state
    give bit-equal logits (what the replayed-vs-eager check on the card
    rests on: the combine adds nothing with atomics)."""
    _, tcfg = _cfgs(QWEN, "bf16")
    tm = build(tcfg)
    tp = tm.cast(params_from_jax(_tree(QWEN)))
    st = tm.init_decode_state(2, 8, device="cpu")
    toks = torch.from_numpy(_tokens((2, 4), 12, tcfg.vocab_size))
    a, b = T.copy_cache(st), T.copy_cache(st)
    for t in range(4):
        la, a = tm.decode_step(tp, a, toks[:, t:t + 1])
        lb, b = tm.decode_step(tp, b, toks[:, t:t + 1])
        assert torch.equal(la, lb)
