"""The port's serving path of the dense transformer against the JAX
package, on the CPU at the qwen2.5-3b SMOKE size (2 layers, d_model 64):
the building blocks, ``Model.hidden`` / ``prefill`` / ``decode_step`` for
both cache flavours, the stacked-shard top-k head, and prefill + greedy
``decode_loop`` as a whole.  The JAX parameters are carried across by
``params_from_jax``; inputs come from numpy seeds.

The JAX sharded serve step is not used: on JAX 0.9 its
``with_sharding_constraint`` refuses the Explicit mesh axes that
``jax.make_mesh`` makes (``ROADMAP.md`` §C).  The port is held against the
unsharded ``Model`` functions and against ``topk_logits`` under
``shard_map``.

Tolerances: f32 (``SMOKE``): 1e-4 relative and absolute on logits and
hidden states (the same f32 arithmetic in another order; the JAX package
holds its own flash and XLA paths to 2e-4).  bf16 compute: 5e-2 absolute
on logits of magnitude up to about 3 (several bf16 roundings of 2^-8 in
each of the two layers, placed differently by XLA and PyTorch).  The int8
codes are bit-identical and the scales equal on one input, and within the
bounds stated at the check after bf16 decode steps.
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import build as jax_build
from repro.models.params import values
from repro.serve.sampling import topk_logits as jax_topk_logits
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build
from repro_torch.serve import sampling
from repro_torch.serve.engine import decode_loop, make_serve_step

ARCH = "qwen2.5-3b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.0, atol=5e-2)
DTYPES = {"f32": ("float32", F32_TOL), "bf16": ("bfloat16", BF16_TOL)}


def _cfgs(dtype: str):
    name, tol = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_get_arch(ARCH, smoke=True),
                               compute_dtype=name)
    tcfg = dataclasses.replace(get_arch(ARCH, smoke=True), compute_dtype=name)
    return jcfg, tcfg, tol


@pytest.fixture(scope="module")
def jax_params():
    """The JAX SMOKE parameters, as numpy; biases made non-zero so that
    the QKV bias path is exercised."""
    cfg = jax_get_arch(ARCH, smoke=True)
    tree = jax.tree.map(np.asarray,
                        values(jax_build(cfg).init(jax.random.key(0))))
    rng = np.random.default_rng(0)
    for b in ("bq", "bk", "bv"):
        a = tree["layers"]["attn"][b]
        tree["layers"]["attn"][b] = (0.1 * rng.normal(size=a.shape)
                                     ).astype(np.float32)
    return tree


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    want = JL.apply_norm(_j(p), jnp.asarray(x), kind)
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), kind)
    _close(got, want, dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("fraction,theta", [(1.0, 1e6), (0.5, 1e4)])
def test_apply_rope_matches_jax(fraction, theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = np.arange(100, 109, dtype=np.int32)[None, :]
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction=fraction,
                         theta=theta)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                       fraction=fraction, theta=theta)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))
    rot = int(16 * fraction)
    assert torch.equal(got[..., rot:], torch.from_numpy(x)[..., rot:])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_codes_bit_identical(dtype):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 1, 2, 128)) * 4).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]    # halves: round to even
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    wq, ws = JT._quantize_kv(jx)
    gq, gs = T._quantize_kv(tx)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_params_from_jax_keeps_values_and_dtypes(jax_params):
    tree = dict(jax_params)
    tree["embedding"] = {"table": jax_params["embedding"]["table"].astype(
        jnp.bfloat16)}
    p = params_from_jax(tree)
    assert p.embedding["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        p.embedding["table"].float().numpy(),
        np.asarray(tree["embedding"]["table"], np.float32))
    assert len(p.layers) == 2
    for i in range(2):
        np.testing.assert_array_equal(p.layers[i].attn["wq"].numpy(),
                                      jax_params["layers"]["attn"]["wq"][i])
        np.testing.assert_array_equal(p.layers[i].mlp["w_down"].numpy(),
                                      jax_params["layers"]["mlp"]["w_down"][i])
    np.testing.assert_array_equal(p.head["w"].numpy(),
                                  jax_params["head"]["w"])


def test_cast_once_equals_cast_at_use(jax_params):
    """Serving casts the weights once (``Model.cast``); the logits equal
    those of casting at every use, as the JAX code does."""
    _, tcfg, _ = _cfgs("bf16")
    model = build(tcfg)
    p32 = params_from_jax(jax_params)
    pbf = model.cast(p32)
    assert all(t.dtype == torch.bfloat16 for t in pbf.parameters())
    toks = {"tokens": torch.from_numpy(_tokens((2, 16), 4, tcfg.vocab_size))}
    a = model.hidden(p32, toks, chunk_q=8, chunk_k=8)
    b = model.hidden(pbf, toks, chunk_q=8, chunk_k=8)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hidden_and_prefill_match_jax(jax_params, dtype, attn_impl):
    jcfg, tcfg, tol = _cfgs(dtype)
    toks = _tokens((2, 32), 5, jcfg.vocab_size)
    jm, tm = jax_build(jcfg), build(tcfg)
    jp, tp = _j(jax_params), params_from_jax(jax_params)
    kw = dict(chunk_q=16, chunk_k=16, attn_impl=attn_impl)
    want_h = jm.hidden(jp, {"tokens": jnp.asarray(toks)}, **kw)
    got_h = tm.hidden(tp, {"tokens": torch.from_numpy(toks)}, **kw)
    _close(got_h, want_h, tol)

    want_l, want_c = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                                jm.init_decode_state(2, 40,
                                                     dtype=jnp.float32), **kw)
    got_l, got_c = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              tm.init_decode_state(2, 40, torch.float32,
                                                   device="cpu"), **kw)
    assert got_l.shape == (2, tcfg.padded_vocab())
    assert int(got_c.length) == got_c.host_length.n == 32
    _close(got_l, want_l, tol)
    _close(got_c.k, want_c.k, tol)
    _close(got_c.v, want_c.v, tol)
    assert ops.launch_counts()["flash_attention_fwd"] == 0


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_steps_match_jax(jax_params, dtype, quant):
    """Six decode steps from an empty cache, logits each step; the int8
    cache's codes and scales at the end."""
    jcfg, tcfg, tol = _cfgs(dtype)
    jm = jax_build(jcfg, cache_quant=quant)
    tm = build(tcfg, cache_quant=quant)
    jp, tp = _j(jax_params), params_from_jax(jax_params)
    # the float cache in the compute dtype, as JAX's cache update requires
    js = jm.init_decode_state(2, 16, dtype=getattr(jnp, jcfg.compute_dtype))
    ts = tm.init_decode_state(2, 16, getattr(torch, tcfg.compute_dtype),
                              device="cpu")
    toks = _tokens((2, 6), 6, jcfg.vocab_size)
    for t in range(6):
        want, js = jm.decode_step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        got, ts = tm.decode_step(tp, ts, torch.from_numpy(toks[:, t:t + 1]))
        _close(got, want, tol)
    assert ts.length.dtype == torch.int32 and ts.length.dim() == 0
    assert int(ts.length) == int(js.length) == ts.host_length.n == 6
    if quant:
        # f32: the same codes.  bf16: k is rounded to bf16 twice (the
        # projection, then the rope), at places XLA and PyTorch choose
        # differently, so it may differ by two bf16 ulps (2^-7 relative
        # each): amax and the scale by 2^-6, x / amax * 127 by two codes,
        # the rounding by one more.  test_quantize_kv_codes_bit_identical
        # holds the codes bit-identical on one input.
        diff = np.abs(ts.k.numpy().astype(np.int32)
                      - np.asarray(js.k).astype(np.int32))
        assert diff.max() <= (0 if dtype == "f32" else 3)
        _close(ts.k_scale, js.k_scale, dict(rtol=1e-4, atol=1e-6)
               if dtype == "f32" else dict(rtol=2 ** -6, atol=1e-6))


_HOST_READS = ("item", "__int__", "__index__", "__bool__", "tolist")


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_decode_step_reads_nothing_from_the_device(jax_params, monkeypatch,
                                                   quant):
    """A serve step (decode step and the sharded head) with every way of
    reading a tensor on the host patched to raise: the precondition for
    capturing the step in a CUDA graph, shown without a card.  The length
    advances in place."""
    _, tcfg, _ = _cfgs("f32")
    tm, tp = build(tcfg, cache_quant=quant), params_from_jax(jax_params)
    st = tm.init_decode_state(2, 8, torch.float32, device="cpu")
    length = st.length
    step = make_serve_step(tm, shards=8, k=4)
    tok = torch.tensor([3, 5])

    def refuse(*a, **kw):
        raise AssertionError("a tensor was read on the host")

    with monkeypatch.context() as m:
        for name in _HOST_READS:
            m.setattr(torch.Tensor, name, refuse)
        nxt, st = step(tp, st, tok)
        nxt, st = step(tp, st, nxt)
    assert st.length is length and int(length) == st.host_length.n == 2
    assert nxt.shape == (2,)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_capacity_check_raises_at_smax(jax_params, quant):
    """decode_step raises once the cache is full, from the host count; the
    decode loop refuses steps that would overrun it before taking any."""
    _, tcfg, _ = _cfgs("f32")
    tm, tp = build(tcfg, cache_quant=quant), params_from_jax(jax_params)
    st = tm.init_decode_state(2, 3, torch.float32, device="cpu")
    tok = torch.tensor([[1], [2]])
    for _ in range(3):
        _, st = tm.decode_step(tp, st, tok)
    with pytest.raises(ValueError, match="all it has room for"):
        tm.decode_step(tp, st, tok)
    assert int(st.length) == st.host_length.n == 3
    st = tm.init_decode_state(2, 3, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="overrun"):
        decode_loop(tm, tp, st, tok[:, 0], 4, shards=1)
    assert int(st.length) == st.host_length.n == 0


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_stale_state_keeps_one_count(jax_params, quant):
    """Steps on a tuple of the cache that a later step has made stale
    advance the same counts as steps on the newest: the host count never
    disagrees with the device length, and both checks still refuse to
    overrun Smax."""
    _, tcfg, _ = _cfgs("f32")
    tm, tp = build(tcfg, cache_quant=quant), params_from_jax(jax_params)
    stale = tm.init_decode_state(2, 3, torch.float32, device="cpu")
    tok = torch.tensor([[1], [2]])
    for n in range(1, 4):
        _, fresh = tm.decode_step(tp, stale, tok)
        assert (int(stale.length) == stale.host_length.n == n
                == int(fresh.length) == fresh.host_length.n)
    with pytest.raises(ValueError, match="all it has room for"):
        tm.decode_step(tp, stale, tok)
    with pytest.raises(ValueError, match="overrun"):
        decode_loop(tm, tp, stale, tok[:, 0], 1, shards=1)
    copy = T.copy_cache(stale)
    T.set_length(copy, 1)
    assert int(stale.length) == stale.host_length.n == 3
    assert int(copy.length) == copy.host_length.n == 1


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_decode_loop_forced_matches_decode_steps(jax_params, quant):
    """decode_loop with ``forced`` tokens and ``logits_out`` against the
    same decode steps one by one on a copy of the state: the same logits
    each step and the same tokens."""
    _, tcfg, _ = _cfgs("f32")
    tm, tp = build(tcfg, cache_quant=quant), params_from_jax(jax_params)
    st = tm.init_decode_state(2, 12, torch.float32, device="cpu")
    fed = torch.from_numpy(_tokens((2, 6), 4, tcfg.vocab_size)).long()
    want_st = T.copy_cache(st)
    logits = []
    got, st = decode_loop(tm, tp, st, fed[:, 0], 6, shards=4,
                          forced=fed[:, 1:], logits_out=logits)
    assert len(logits) == 6 and int(st.length) == st.host_length.n == 6
    for t in range(6):
        want, want_st = tm.decode_step(tp, want_st, fed[:, t:t + 1])
        assert torch.equal(logits[t], want)
        assert torch.equal(got[:, t + 1], want.argmax(-1))
    assert torch.equal(got[:, 0], fed[:, 0])
    with pytest.raises(ValueError, match="forced"):
        decode_loop(tm, tp, st, fed[:, 0], 3, shards=4, forced=fed)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_padded_heads_match_jax(quant):
    """``Model(tp=3)`` pads the SMOKE config's 4 / 2 heads to 6 / 3, as
    the JAX model does: the same parameter and cache shapes, and the same
    prefill and decode logits (f32)."""
    jcfg, tcfg, tol = _cfgs("f32")
    jm = jax_build(jcfg, tp=3, cache_quant=quant)
    tm = build(tcfg, tp=3, cache_quant=quant)
    tree = jax.tree.map(np.asarray, values(jm.init(jax.random.key(1))))
    jp, tp = _j(tree), params_from_jax(tree)
    assert tp.layers[0].attn["wq"].shape == (64, 6, 16)
    assert tp.layers[0].attn["wk"].shape == (64, 3, 16)
    assert (tuple(tm.init(0, device="cpu").layers[0].attn["wo"].shape)
            == tree["layers"]["attn"]["wo"].shape[1:])
    js = jm.init_decode_state(2, 16, dtype=jnp.float32)
    ts = tm.init_decode_state(2, 16, torch.float32, device="cpu")
    assert all(tuple(np.shape(t)) == np.shape(j) for t, j in zip(ts, js))
    toks = _tokens((2, 12), 9, jcfg.vocab_size)
    if not quant:
        want, js = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, js,
                              chunk_q=8, chunk_k=8)
        got, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :8])},
                             ts, chunk_q=8, chunk_k=8, attn_impl="flash")
        _close(got, want, tol)
    for t in range(int(js.length), 12):
        want, js = jm.decode_step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        got, ts = tm.decode_step(tp, ts, torch.from_numpy(toks[:, t:t + 1]))
        _close(got, want, tol)


def test_quant_decode_close_to_bf16_cache(jax_params):
    """The int8 cache against the exact float cache, the JAX test's bounds
    (tests/test_serve_sampling.py): rtol 0.1, atol 0.15, and the int8
    argmax among the float path's top 5."""
    _, tcfg, _ = _cfgs("f32")
    tp = params_from_jax(jax_params)
    mf, mq = build(tcfg), build(tcfg, cache_quant=True)
    sf = mf.init_decode_state(2, 16, torch.float32, device="cpu")
    sq = mq.init_decode_state(2, 16, device="cpu")
    toks = torch.from_numpy(_tokens((2, 6), 0, tcfg.vocab_size))
    for t in range(6):
        lf, sf = mf.decode_step(tp, sf, toks[:, t:t + 1])
        lq, sq = mq.decode_step(tp, sq, toks[:, t:t + 1])
        np.testing.assert_allclose(lq.numpy(), lf.numpy(), rtol=0.1,
                                   atol=0.15)
    top5 = torch.topk(lf, 5).indices
    assert all(int(lq[b].argmax()) in top5[b].tolist() for b in range(2))


def test_prefill_then_decode_equals_longer_prefill(jax_params):
    """Prefill of S - 1 tokens plus one decode step gives the logits of a
    prefill of all S tokens (f32)."""
    _, tcfg, _ = _cfgs("f32")
    tm, tp = build(tcfg), params_from_jax(jax_params)
    toks = torch.from_numpy(_tokens((2, 24), 8, tcfg.vocab_size))
    full, _ = tm.prefill(tp, {"tokens": toks},
                         tm.init_decode_state(2, 32, torch.float32,
                                              device="cpu"),
                         attn_impl="flash")
    _, st = tm.prefill(tp, {"tokens": toks[:, :-1]},
                       tm.init_decode_state(2, 32, torch.float32,
                                            device="cpu"), attn_impl="flash")
    step, _ = tm.decode_step(tp, st, toks[:, -1:])
    np.testing.assert_allclose(step.numpy(), full.numpy(), **F32_TOL)


# ---------------------------------------------------------------------------
# the head and the whole slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 2, 8])
def test_topk_logits_stacked_matches_shard_map(P):
    """Logits (B, V) cut into P stacked shards against the JAX head under
    shard_map over a P-device ``model`` axis; ties included."""
    rng = np.random.default_rng(P)
    B, V, k = 4, 512, 8
    logits = rng.normal(size=(B, V)).astype(np.float32)
    logits[:, 7] = logits[:, 300] = logits.max() + 1.0   # a tie at the top
    mesh = jax.make_mesh((P,), ("model",), devices=jax.devices()[:P])
    vals, ids = jax.jit(jax.shard_map(
        lambda local: jax_topk_logits(local, k, axis="model"), mesh=mesh,
        in_specs=JP(None, "model"), out_specs=JP(), check_vma=False,
    ))(jnp.asarray(logits))
    local = torch.from_numpy(logits).reshape(B, P, V // P).transpose(0, 1)
    tv, ti = sampling.topk_logits(local, k)
    assert tv.shape == (P, B, k)
    for p in range(P):          # every shard holds the global top-k
        np.testing.assert_array_equal(ti[p].numpy(), np.asarray(ids))
        np.testing.assert_array_equal(tv[p].numpy(), np.asarray(vals))
    assert ti[0, 0, 0] == 7 and ti[0, 0, 1] == 300
    assert torch.equal(sampling.naive_allgather_argmax(local),
                       torch.from_numpy(logits).argmax(-1))


def test_sampled_head_draws_from_the_topk():
    logits = torch.from_numpy(np.random.default_rng(9).normal(
        size=(3, 256)).astype(np.float32))
    local = logits.reshape(3, 4, 64).transpose(0, 1)
    gen = torch.Generator().manual_seed(0)
    top = torch.topk(logits, 4).indices
    for _ in range(5):
        tok = sampling.distributed_topk_sample(local, 4, gen)
        assert all(int(tok[b]) in top[b].tolist() for b in range(3))


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slice_greedy_tokens_match_jax(jax_params, dtype, shards):
    """The whole slice: prefill (flash) + greedy decode_loop through the
    serve step against JAX prefill + decode_step + argmax."""
    jcfg, tcfg, _ = _cfgs(dtype)
    jm, tm = jax_build(jcfg), build(tcfg)
    jp, tp = _j(jax_params), params_from_jax(jax_params)
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
                            device="cpu"),
                        attn_impl="flash")
    got, ts = decode_loop(tm, tp, ts, tl.argmax(-1), steps, shards=shards)
    assert int(ts.length) == ts.host_length.n == 16 + steps
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_serve_step_draws_from_the_topk(jax_params):
    """``make_serve_step(greedy=False)``: each drawn token is among the
    top k of the step's full logits."""
    _, tcfg, _ = _cfgs("f32")
    tm, tp = build(tcfg), params_from_jax(jax_params)
    step = make_serve_step(tm, shards=4, k=3, greedy=False,
                           generator=torch.Generator().manual_seed(0))
    st = tm.init_decode_state(2, 8, torch.float32, device="cpu")
    tok = torch.tensor([1, 2])
    for _ in range(4):
        # the step's logits: decode_step on a copy of the state (a step
        # advances the state's length in place)
        logits, _ = tm.decode_step(tp, T.copy_cache(st), tok[:, None])
        nxt, st = step(tp, st, tok)
        top = torch.topk(logits, 3).indices
        assert all(int(nxt[b]) in top[b].tolist() for b in range(2))
        tok = nxt


def test_serve_step_rejects_bad_shards():
    _, tcfg, _ = _cfgs("f32")
    with pytest.raises(ValueError, match="power of two"):
        make_serve_step(build(tcfg), shards=3)


@pytest.mark.parametrize("arch", ["yi-34b", "chatglm3-6b",
                                  "mistral-nemo-12b"])
def test_unported_architectures_raise(arch):
    """The registry names only what the port serves; a configuration of
    the JAX package it does not serve yet is refused, naming the ROADMAP
    item, and the Model refuses a family it does not know."""
    with pytest.raises(KeyError, match="ROADMAP"):
        get_arch(arch)
    cfg = dataclasses.replace(get_arch(ARCH, smoke=True), family="unknown")
    with pytest.raises(ValueError, match="unknown family"):
        build(cfg)
