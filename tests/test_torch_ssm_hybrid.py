"""The port's SSM and hybrid families against the JAX package, on the CPU
at the SMOKE sizes: mamba2-2.7b (2 layers, d_model 64, 8 heads of 16,
state 16, chunk 16) and recurrentgemma-2b (3 layers, the third attention,
d_model 64, 4/1 heads of 16, window 16).  The JAX parameters are carried
across by ``params_from_jax``; inputs come from numpy seed 0; the JAX
functions are jitted once in module-scoped fixtures.

What is compared: ``ssd_chunked`` with a start state and ``_lru_scan``
with a start hidden (outputs and final states); ``Model.hidden`` and
``loss``; ``prefill`` (logits and every live state slot) and then 4
``decode_step``s (logits and live slots after each); the hybrid with its
ring buffer unwrapped (a 12-token prompt) and wrapped (40 tokens, window
16), its forward through the plain B7 (``attn_impl="flash"``) and the
chunked attention (``"xla"``); ``decode_loop`` against stepwise
``decode_step``; one bf16 case of each family.

The JAX hybrid stores and runs both blocks in every layer and writes
every state slot; the port holds and runs each layer's live block only
and leaves the inert slots (an attention layer's LRU hidden and conv
tail, a recurrent layer's ring buffer) at zero, which nothing reads.  So
the live slots are compared, with the logits and hidden states.

Tolerances: f32 1e-4 relative and absolute (``tests/test_torch_lm.py``'s
``F32_TOL``: the same arithmetic in another order; the LRU's doubling
steps and the SSD's chunk loop round in another order than JAX's
associative scan and ``lax.scan``); the hybrid's conv tails and ring
buffers, which the prefill rounds to bf16 on both sides whatever the
state's dtype, one bf16 rounding (2^-8 relative) more; bf16 compute 5e-2
absolute (``BF16_TOL``: bf16 roundings placed differently by XLA and
PyTorch).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import hybrid as JH
from repro.models import ssm as JS
from repro.models.model import build as jax_build
from repro.models.params import values
from repro_torch.configs import get_arch
from repro_torch.models import hybrid as H
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build
from repro_torch.serve.engine import decode_loop

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.0, atol=5e-2)
BF16_ULP = 2.0 ** -8
ARCHS = {"ssm": "mamba2-2.7b", "hybrid": "recurrentgemma-2b"}
BATCH = 2
STEPS = 4


def _close(got: torch.Tensor, want, tol=F32_TOL, what: str = ""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def _tokens(shape, seed: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


class _Family:
    """One family's SMOKE model on both sides: the JAX model, its numpy
    parameters (the zero-initialised decays and biases made non-zero), the
    port's model and parameters, and the JAX functions jitted once."""

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
        layers = tree["layers"]
        blocks = ([layers] if family == "ssm" else [layers["rec_block"]])
        for blk in blocks:
            for k in ("dt_bias", "A_log", "b_a", "b_i"):
                if k in blk:
                    blk[k] = (0.5 * rng.normal(size=blk[k].shape)
                              ).astype(np.float32)
        self.tree = tree
        self.jp = jax.tree.map(jnp.asarray, tree)
        self.model = build(self.cfg)
        self.params = params_from_jax(tree, cfg=self.cfg)
        if dtype != "float32":   # as served: cast once, the f32 reads kept
            self.params = self.model.cast(self.params)
        self.cd = getattr(torch, dtype)
        self.jstate_dtype = jnp.dtype(dtype)
        self.prefill = jax.jit(self.jm.prefill, static_argnames=("attn_impl",))
        self.decode = jax.jit(self.jm.decode_step)
        self.hidden = jax.jit(self.jm.hidden,
                              static_argnames=("attn_impl", "ssm_bf16"))
        self.loss = jax.jit(self.jm.loss, static_argnames=("attn_impl",))
        self.vocab = self.cfg.vocab_size

    def states(self, prompt: np.ndarray):
        """(JAX state, port state) for a batch of ``prompt``, both empty,
        in the compute dtype."""
        B = prompt.shape[0]
        return (self.jm.init_decode_state(B, 64, dtype=self.jstate_dtype),
                self.model.init_decode_state(B, 64, dtype=self.cd,
                                             device="cpu"))

    def live(self, state) -> dict:
        """The live slots of a decode state, JAX's or the port's, as numpy
        (the SSM state and conv tails; the hybrid's recurrent layers' LRU
        hiddens and conv tails, its attention layers' ring buffers)."""
        def a(x):
            return (x.float().numpy() if isinstance(x, torch.Tensor)
                    else np.asarray(x, np.float32))

        if self.family == "ssm":
            return {"state": a(state.state), "conv": a(state.conv)}
        out = {}
        for i in range(self.cfg.n_layers):
            names = (("k", "v") if H.is_attn_layer(self.cfg, i)
                     else ("lru", "conv"))
            for n in names:
                out[f"{n}[{i}]"] = a(getattr(state, n)[i])
        return out

    def hold_live(self, got, want, tol, what: str):
        """The live slots within ``tol``; the hybrid's conv tails and ring
        buffers, which both prefills round to bf16, within one more bf16
        rounding (``BF16_ULP`` relative: an f32 difference at a rounding
        boundary moves the value by one bf16 step)."""
        g, w = self.live(got), self.live(want)
        assert sorted(g) == sorted(w)
        for k in w:
            t = tol
            if self.family == "hybrid" and not k.startswith("lru"):
                t = dict(tol, rtol=tol["rtol"] + BF16_ULP)
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{what} {k}",
                                       **t)


@pytest.fixture(scope="module")
def fams():
    return {f: _Family(f) for f in ARCHS}


def _prefill_then_decode(fam: _Family, prompt: np.ndarray, tol,
                         attn_impl: str = "xla"):
    """The prompt through both prefills (the port's attention through
    ``attn_impl``, JAX's through its chunked one), then STEPS decode steps
    of the same random tokens; logits and live slots held after each."""
    js, ts = fam.states(prompt)
    jl, js = fam.prefill(fam.jp, {"tokens": jnp.asarray(prompt)}, js,
                         attn_impl="xla")
    tl, ts = fam.model.prefill(fam.params,
                               {"tokens": torch.from_numpy(prompt)}, ts,
                               attn_impl=attn_impl)
    _close(tl, jl, tol, "prefill logits")
    fam.hold_live(ts, js, tol, "prefill")
    assert int(ts.length) == ts.host_length.n == prompt.shape[1]
    fed = _tokens((prompt.shape[0], STEPS), 1, fam.vocab)
    for t in range(STEPS):
        jl, js = fam.decode(fam.jp, js, jnp.asarray(fed[:, t:t + 1]))
        tl, ts = fam.model.decode_step(fam.params, ts,
                                       torch.from_numpy(fed[:, t:t + 1]))
        _close(tl, jl, tol, f"decode step {t} logits")
        fam.hold_live(ts, js, tol, f"decode step {t}")
    assert int(ts.length) == ts.host_length.n == prompt.shape[1] + STEPS


def test_ssd_chunked_matches_jax():
    rng = np.random.default_rng(0)
    b, Sq, Hh, P, N, chunk = 2, 48, 4, 8, 16, 16
    x = rng.normal(size=(b, Sq, Hh, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, Sq, Hh)))).astype(np.float32)
    A = -np.exp(0.5 * rng.normal(size=Hh)).astype(np.float32)
    Bm = rng.normal(size=(b, Sq, N)).astype(np.float32)
    Cm = rng.normal(size=(b, Sq, N)).astype(np.float32)
    s0 = rng.normal(size=(b, Hh, P, N)).astype(np.float32)
    jy, js = jax.jit(JS.ssd_chunked, static_argnums=5)(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk, jnp.asarray(s0))
    ty, ts = S.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                           chunk, torch.from_numpy(s0))
    _close(ty, jy, what="y")
    _close(ts, js, what="final state")


def test_lru_scan_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 1.0, size=(2, 37, 24)).astype(np.float32)
    bx = rng.normal(size=(2, 37, 24)).astype(np.float32)
    h0 = rng.normal(size=(2, 24)).astype(np.float32)
    want = jax.jit(JH._lru_scan)(jnp.asarray(a), jnp.asarray(bx),
                                 jnp.asarray(h0))
    got = H._lru_scan(torch.from_numpy(a), torch.from_numpy(bx),
                      torch.from_numpy(h0))
    _close(got, want)


def test_mamba_hidden_and_loss_match_jax(fams):
    fam = fams["ssm"]
    tokens = _tokens((BATCH, 40), 0, fam.vocab)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    _close(fam.model.hidden(fam.params, tb), fam.hidden(fam.jp, jb))
    with torch.no_grad():
        got = fam.model.loss(fam.params, tb)
    _close(got, fam.loss(fam.jp, jb))
    # the SSD's io in bf16 (``ssm_bf16``): its roundings, each within one
    # bf16 step of JAX's, held at the bf16 tolerance
    _close(fam.model.hidden(fam.params, tb, ssm_bf16=True),
           fam.hidden(fam.jp, jb, ssm_bf16=True), BF16_TOL)


def test_mamba_prefill_and_decode_match_jax(fams):
    """A 40-token prompt (chunks of 16 shrink to 10, which divide it),
    the SSD state and conv tails, then 4 steps."""
    fam = fams["ssm"]
    _prefill_then_decode(fam, _tokens((BATCH, 40), 0, fam.vocab), F32_TOL)


@pytest.mark.parametrize("prompt_len", [12, 40])
def test_hybrid_prefill_and_decode_match_jax(fams, prompt_len):
    """A prompt shorter than the window (12 of 16 slots) and one whose
    ring buffer has wrapped (40 tokens, the port's prefill through the
    plain B7 as on the card), then 4 steps, the ring slot and the valid
    count read from the device length."""
    fam = fams["hybrid"]
    _prefill_then_decode(fam, _tokens((BATCH, prompt_len), 0, fam.vocab),
                         F32_TOL, "xla" if prompt_len < 16 else "flash")


def test_hybrid_hidden_flash_and_xla_and_loss_match_jax(fams):
    """The forward through the plain B7 (``flash``, the window in the
    kernel's mask) and through the chunked attention (``xla``), both
    against the JAX forward; the loss too."""
    fam = fams["hybrid"]
    tokens = _tokens((BATCH, 40), 0, fam.vocab)
    labels = np.roll(tokens, -1, axis=1)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    want = fam.hidden(fam.jp, jb, attn_impl="xla")
    for impl in ("flash", "xla"):
        _close(fam.model.hidden(fam.params, tb, attn_impl=impl), want,
               what=impl)
    with torch.no_grad():
        got = fam.model.loss(fam.params, tb, attn_impl="flash")
    _close(got, fam.loss(fam.jp, jb, attn_impl="xla"))


@pytest.mark.parametrize("family", list(ARCHS))
def test_decode_loop_matches_decode_steps(fams, family):
    """``decode_loop`` (greedy, the sharded head) on the CPU against
    stepwise ``decode_step`` on a copy of the prefilled state: the same
    tokens, logits and state; the loop has no position limit to check."""
    fam = fams[family]
    prompt = torch.from_numpy(_tokens((BATCH, 20), 0, fam.vocab))
    _, st = fam.states(prompt.numpy())
    lg, st = fam.model.prefill(fam.params, {"tokens": prompt}, st)
    assert T.capacity(st) == float("inf")
    eager = T.copy_cache(st)
    first = lg.argmax(-1)
    logits = []
    toks, st = decode_loop(fam.model, fam.params, st, first, 24, shards=4,
                           k=4, logits_out=logits)
    tok = first
    for t in range(24):
        want, eager = fam.model.decode_step(fam.params, eager, tok[:, None])
        assert torch.equal(logits[t], want), f"step {t}"
        tok = want.argmax(-1)
        assert torch.equal(toks[:, t + 1], tok), f"step {t}"
    for f in st._fields[:-1]:
        assert torch.equal(getattr(st, f), getattr(eager, f)), f
    assert st.host_length.n == eager.host_length.n == 44


@pytest.mark.parametrize("family", list(ARCHS))
def test_bf16_smoke_matches_jax(family):
    """bf16 compute, the parameters cast once by ``Model.cast`` (the
    serving path) and a bf16 state: prefill of 40 tokens and 4 steps
    within ``BF16_TOL`` on the logits and the live slots."""
    fam = _Family(family, "bfloat16")
    _prefill_then_decode(fam, _tokens((BATCH, 40), 0, fam.vocab), BF16_TOL)
