"""The port's encoder-decoder and VLM families against the JAX package, on
the CPU at the SMOKE sizes: whisper-medium (2 + 2 layers, d_model 64, 4
heads of 16, 32 encoder positions, 128 learned decoder positions) and
paligemma-3b (2 layers, d_model 64, 4/1 heads of 16, an image prefix of 8
patches of width 24).  The JAX parameters are carried across by
``params_from_jax``; inputs come from numpy seeds; the JAX functions are
jitted once in a module-scoped fixture.

What is compared: whisper's ``encode``; ``Model.hidden`` and ``loss`` of
both families through the chunked attention (``xla``, at chunks that
split the sequences) and the plain B7 (``flash``), each against JAX's
``xla``; ``prefill`` (logits and every cache tensor) and then 3
``decode_step``s of both families, the port's prefill through ``xla``
and ``flash``, JAX's through its chunked attention (its encdec prefill
encodes through the chunked attention whatever ``attn_impl`` says;
the port's encodes through ``attn_impl``, so its flash prefill runs the
encoder through B7); whisper's ``fill_cross_cache`` and decode steps
from an empty self cache (the route of ``tests/test_arch_smoke.py``);
``decode_loop`` against stepwise ``decode_step``; one bf16 run of each
family; the parameter layout both ways.

Tolerances: f32 1e-4 relative and absolute (``F32_TOL``, as in
``tests/test_torch_lm.py``: the same arithmetic in another order); bf16
compute 5e-2 absolute (``BF16_TOL``: bf16 roundings placed differently by
XLA and PyTorch).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import encdec as JE
from repro.models.model import build as jax_build
from repro.models.params import values
from repro_torch.configs import get_arch
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.convert import jax_layout, params_from_jax
from repro_torch.models.model import build
from repro_torch.serve.engine import decode_loop

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.0, atol=5e-2)
ARCHS = {"encdec": "whisper-medium", "vlm": "paligemma-3b"}
BATCH = 2
PROMPT = 12
MAX_LEN = 32
STEPS = 3


def _close(got: torch.Tensor, want, tol=F32_TOL, what: str = ""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def _tokens(shape, seed: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


class _Family:
    """One family's SMOKE model on both sides: the JAX model, its numpy
    parameters (zero-initialised biases made non-zero, so that each is
    held), the port's model and parameters, the frontend's input of each
    sequence, and the JAX functions jitted once."""

    def __init__(self, family: str, dtype: str = "float32"):
        self.family = family
        self.jcfg = dataclasses.replace(
            jax_get_arch(ARCHS[family], smoke=True), compute_dtype=dtype)
        self.cfg = dataclasses.replace(get_arch(ARCHS[family], smoke=True),
                                       compute_dtype=dtype)
        self.jm = jax_build(self.jcfg)
        tree = jax.tree.map(np.asarray,
                            values(self.jm.init(jax.random.key(0))))
        rng = np.random.default_rng(0)

        def perturb(t):
            for k, v in t.items():
                if isinstance(v, dict):
                    perturb(v)
                elif k in ("bias", "b_up", "b_down", "b"):
                    t[k] = (0.1 * rng.normal(size=v.shape)).astype(v.dtype)

        perturb(tree)
        self.tree = tree
        self.jp = jax.tree.map(jnp.asarray, tree)
        self.model = build(self.cfg)
        self.params = params_from_jax(tree)
        if dtype != "float32":   # as served: cast once
            self.params = self.model.cast(self.params)
        self.cd = getattr(torch, dtype)
        self.jdtype = jnp.dtype(dtype)
        if family == "encdec":
            self.extra_key = "frames"
            shape = (BATCH, self.cfg.encdec.enc_seq, self.cfg.d_model)
        else:
            self.extra_key = "patches"
            shape = (BATCH, self.cfg.vlm.num_patches, self.cfg.vlm.patch_dim)
        self.extra = np.random.default_rng(2).normal(size=shape).astype(
            np.float32)
        self.prefill = jax.jit(self.jm.prefill, static_argnames=("attn_impl",))
        self.decode = jax.jit(self.jm.decode_step)
        self.hidden = jax.jit(self.jm.hidden, static_argnames=("attn_impl",))
        self.loss = jax.jit(self.jm.loss, static_argnames=("attn_impl",))
        self.vocab = self.cfg.vocab_size

    def batches(self, tokens: np.ndarray, labels=None):
        """(JAX batch, port batch) of ``tokens`` with the frontend input."""
        jb = {"tokens": jnp.asarray(tokens),
              self.extra_key: jnp.asarray(self.extra)}
        tb = {"tokens": torch.from_numpy(tokens),
              self.extra_key: torch.from_numpy(self.extra)}
        if labels is not None:
            jb["labels"] = jnp.asarray(labels)
            tb["labels"] = torch.from_numpy(labels)
        return jb, tb

    def states(self):
        """(JAX state, port state), both empty, in the compute dtype."""
        return (self.jm.init_decode_state(BATCH, MAX_LEN, dtype=self.jdtype),
                self.model.init_decode_state(BATCH, MAX_LEN, dtype=self.cd,
                                             device="cpu"))

    def hold_state(self, got, want, tol, what: str):
        """Every tensor of the cache and both lengths."""
        names = got._fields[:-2]
        assert names == want._fields[:-1]
        for n in names:
            _close(getattr(got, n), getattr(want, n), tol, f"{what} {n}")
        assert int(got.length) == got.host_length.n == int(want.length)


@pytest.fixture(scope="module")
def fams():
    return {f: _Family(f) for f in ARCHS}


def _decode_steps(fam: _Family, js, ts, tol, what: str):
    """STEPS decode steps of the same random tokens on both sides, logits
    and the cache held after each."""
    fed = _tokens((BATCH, STEPS), 1, fam.vocab)
    for t in range(STEPS):
        jl, js = fam.decode(fam.jp, js, jnp.asarray(fed[:, t:t + 1]))
        tl, ts = fam.model.decode_step(fam.params, ts,
                                       torch.from_numpy(fed[:, t:t + 1]))
        _close(tl, jl, tol, f"{what} decode step {t} logits")
        fam.hold_state(ts, js, tol, f"{what} decode step {t}")
    return js, ts


def _prefill_then_decode(fam: _Family, tol, attn_impl: str = "xla"):
    tokens = _tokens((BATCH, PROMPT), 0, fam.vocab)
    jb, tb = fam.batches(tokens)
    js, ts = fam.states()
    jl, js = fam.prefill(fam.jp, jb, js, attn_impl="xla")
    tl, ts = fam.model.prefill(fam.params, tb, ts, attn_impl=attn_impl)
    _close(tl, jl, tol, "prefill logits")
    fam.hold_state(ts, js, tol, "prefill")
    _, ts = _decode_steps(fam, js, ts, tol, attn_impl)
    n = PROMPT + STEPS + (fam.cfg.vlm.num_patches if fam.family == "vlm"
                          else 0)
    assert int(ts.length) == ts.host_length.n == n


def test_whisper_encode_matches_jax(fams):
    """The encoder through the chunked attention (chunks of 8) and the
    plain B7, both unmasked, against JAX's ``encode``."""
    fam = fams["encdec"]
    want = jax.jit(JE.encode, static_argnums=2)(
        fam.jp, jnp.asarray(fam.extra), fam.jcfg)
    frames = torch.from_numpy(fam.extra)
    _close(E.encode(fam.params, frames, fam.cfg, chunk=8), want, what="xla")
    _close(E.encode(fam.params, frames, fam.cfg, attn_impl="flash"), want,
           what="flash")


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("family", list(ARCHS))
def test_hidden_and_loss_match_jax(fams, family, attn_impl):
    """``hidden`` (the VLM's over image and text positions) and ``loss``
    (the VLM's over the text only); the chunked attention at chunks of 8
    (shrunk to divide each sequence), the plain B7 without chunks."""
    fam = fams[family]
    tokens = _tokens((BATCH, PROMPT), 0, fam.vocab)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    jb, tb = fam.batches(tokens, labels)
    kw = dict(attn_impl=attn_impl)
    if attn_impl == "xla":
        kw.update(chunk_q=8, chunk_k=8)
    _close(fam.model.hidden(fam.params, tb, **kw),
           fam.hidden(fam.jp, jb, attn_impl="xla"), what="hidden")
    with torch.no_grad():
        got = fam.model.loss(fam.params, tb, **kw)
    _close(got, fam.loss(fam.jp, jb, attn_impl="xla"), what="loss")


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("family", list(ARCHS))
def test_prefill_and_decode_match_jax(fams, family, attn_impl):
    """A 12-token prompt (the VLM's behind its 8 image positions) into an
    empty cache of 32 positions, then 3 steps: logits, the self and cross
    (encdec) or the one (VLM) cache tensors and the lengths."""
    _prefill_then_decode(fams[family], F32_TOL, attn_impl)


def test_whisper_fill_cross_cache_then_decode_matches_jax(fams):
    """The encoder's states into the cross cache by ``fill_cross_cache``,
    then decode steps from an empty self cache, against the JAX route of
    ``tests/test_arch_smoke.py``; a full cache refuses a step, and no
    cache outruns the learned positions."""
    fam = fams["encdec"]
    js, ts = fam.states()
    jenc = jax.jit(JE.encode, static_argnums=2)(
        fam.jp, jnp.asarray(fam.extra), fam.jcfg)
    js = JE.fill_cross_cache(fam.jp, jenc, fam.jcfg, js)
    tenc = E.encode(fam.params, torch.from_numpy(fam.extra), fam.cfg)
    ts = E.fill_cross_cache(fam.params, tenc, fam.cfg, ts)
    fam.hold_state(ts, js, F32_TOL, "fill_cross_cache")
    _decode_steps(fam, js, ts, F32_TOL, "fill_cross_cache")
    T.set_length(ts, MAX_LEN)
    with pytest.raises(ValueError, match="room"):
        fam.model.decode_step(fam.params, ts, torch.zeros((BATCH, 1),
                                                          dtype=torch.int32))
    with pytest.raises(ValueError, match="learned positions"):
        fam.model.init_decode_state(BATCH, fam.cfg.max_seq + 1,
                                    device="cpu")


@pytest.mark.parametrize("family", list(ARCHS))
def test_decode_loop_matches_decode_steps(fams, family):
    """``decode_loop`` (greedy, the sharded head) on the CPU against
    stepwise ``decode_step`` on a copy of the prefilled cache: the same
    tokens, logits and cache; the loop stops at the cache's capacity."""
    fam = fams[family]
    _, tb = fam.batches(_tokens((BATCH, PROMPT), 0, fam.vocab))
    _, st = fam.states()
    lg, st = fam.model.prefill(fam.params, tb, st, attn_impl="flash")
    room = T.capacity(st) - st.host_length.n
    assert room == MAX_LEN - PROMPT
    eager = T.copy_cache(st)
    first = lg.argmax(-1)
    logits = []
    toks, st = decode_loop(fam.model, fam.params, st, first, room, shards=4,
                           k=4, logits_out=logits)
    tok = first
    for t in range(room):
        want, eager = fam.model.decode_step(fam.params, eager, tok[:, None])
        assert torch.equal(logits[t], want), f"step {t}"
        tok = want.argmax(-1)
        assert torch.equal(toks[:, t + 1], tok), f"step {t}"
    for f in st._fields[:-1]:
        assert torch.equal(getattr(st, f), getattr(eager, f)), f
    with pytest.raises(ValueError, match="overrun"):
        decode_loop(fam.model, fam.params, st, tok, 1, shards=4, k=4)


@pytest.mark.parametrize("family", list(ARCHS))
def test_bf16_smoke_matches_jax(family):
    """bf16 compute, the parameters cast once by ``Model.cast`` (the
    serving path) and a bf16 cache: prefill through the plain B7 and 3
    steps within ``BF16_TOL`` on the logits and the cache."""
    _prefill_then_decode(_Family(family, "bfloat16"), BF16_TOL, "flash")


@pytest.mark.parametrize("family", list(ARCHS))
def test_parameter_layout_matches_jax(fams, family):
    """``jax_layout(params_from_jax(tree))`` is the JAX tree, value for
    value; ``Model.init`` draws a tree of the same names, shapes and
    dtypes."""
    fam = fams[family]

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{pre}{k}."))
            else:
                out[pre + k] = np.asarray(v)
        return out

    want = flat(fam.tree)
    got = flat(jax_layout(fam.params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    drawn = flat(jax_layout(fam.model.init(0, device="cpu")))
    assert {k: (v.shape, v.dtype) for k, v in drawn.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}
