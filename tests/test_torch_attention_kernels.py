"""The port's attention kernels on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels run in interpret mode: the
flash-attention forward (B7, out and lse) and the decode attention (B9,
float and int8 caches).

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against the same plain versions there.  Tolerances: f32 inputs
2e-5, the JAX tests' own (``tests/test_flash_attention.py``,
``tests/test_serve_sampling.py``): the same f32 arithmetic summed in
another order.  bf16 inputs: one bf16 rounding of the output (relative
2^-8) plus 1e-3 absolute, since both round an f32 result to bf16 and may
fall on either side of a rounding boundary.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import (
    flash_attention_fwd_grouped as jax_flash,
)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import group, ungroup

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2.0 ** -8, atol=1e-3)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _grouped(BKV, G, S, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BKV, G, S, D)).astype(np.float32)
    k = rng.normal(size=(BKV, Sk, D)).astype(np.float32)
    v = rng.normal(size=(BKV, Sk, D)).astype(np.float32)
    return q, k, v


MASKS = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=4),
    "prefix": dict(causal=True, prefix=8),
    "window+prefix": dict(causal=True, window=4, prefix=8),
    "noncausal": dict(causal=False),
}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (8, 1)])
def test_flash_plain_matches_pallas(H, KV, mask):
    B, S, D = 2, 64, 16
    q, k, v = _grouped(B * KV, H // KV, S, S, D, seed=H + KV)
    kw = MASKS[mask]
    want_o, want_l = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               bq=16, bk=16, interpret=True, **kw)
    got_o, got_l = ops.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    np.testing.assert_allclose(_np(got_o), np.asarray(want_o), **F32_TOL)
    np.testing.assert_allclose(_np(got_l), np.asarray(want_l), **F32_TOL)
    assert ops.launch_counts()["flash_attention_fwd"] == 0


@pytest.mark.parametrize("S,Sk,causal", [(48, 48, True), (32, 80, False),
                                         (80, 32, True)])
def test_flash_plain_uneven_lengths(S, Sk, causal):
    """S != Sk and lengths that are no power of two (the Pallas kernel
    needs blocks that divide them; the port's kernel takes any)."""
    q, k, v = _grouped(2, 4, S, Sk, 16, seed=S + Sk)
    want_o, want_l = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, bq=16, bk=16, interpret=True)
    got_o, got_l = ops.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    np.testing.assert_allclose(_np(got_o), np.asarray(want_o), **F32_TOL)
    np.testing.assert_allclose(_np(got_l), np.asarray(want_l), **F32_TOL)


def test_flash_plain_fully_masked_rows():
    """window = 0 masks every key of every row: out is 0 and lse is
    NEG_INF + log(1e-30), as the TPU kernel's guards give, never NaN."""
    q, k, v = _grouped(2, 2, 32, 32, 8, seed=5)
    want_o, want_l = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=0, bq=8, bk=8,
                               interpret=True)
    got_o, got_l = ops.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=0)
    assert not torch.isnan(got_o).any() and not got_o.any()
    np.testing.assert_array_equal(_np(got_o), np.asarray(want_o))
    np.testing.assert_array_equal(_np(got_l), np.asarray(want_l))


def test_flash_plain_bf16():
    q, k, v = _grouped(4, 8, 64, 64, 16, seed=3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want_o, want_l = jax_flash(jq, jk, jv, bq=16, bk=16, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got_o, got_l = ops.flash_attention_fwd(tq, tk, tv)
    assert got_o.dtype == torch.bfloat16 and got_l.dtype == torch.float32
    np.testing.assert_allclose(_np(got_o), np.asarray(want_o, np.float32),
                               **BF16_TOL)
    np.testing.assert_allclose(_np(got_l), np.asarray(want_l), **F32_TOL)


def test_group_ungroup_round_trip():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 5, 8, 4)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 7, 2, 4)).astype(np.float32))
    qg, kg, vg = group(q, k, k)
    assert qg.shape == (4, 4, 5, 4) and kg.shape == (4, 7, 4)
    assert torch.equal(ungroup(qg, 2, 2), q)
    # query head h of batch b reads kv head h // G
    assert torch.equal(qg[1 * 2 + 1, 3], q[1, :, 1 * 4 + 3])
    assert torch.equal(kg[1 * 2 + 1], k[1, :, 1])


@pytest.mark.parametrize("length", [1, 37, 48, 64])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_decode_plain_matches_pallas(cache, length):
    """Lengths: one position, a ragged one, a block boundary of the Pallas
    kernel (bs = 16) and the whole cache."""
    rng = np.random.default_rng(length)
    BKV, G, D, Smax = 4, 4, 16, 64
    q = rng.normal(size=(BKV, G, D)).astype(np.float32)
    if cache == "int8":
        k = rng.integers(-127, 128, (BKV, Smax, D)).astype(np.int8)
        v = rng.integers(-127, 128, (BKV, Smax, D)).astype(np.int8)
        ks = (rng.random((BKV, Smax)) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.random((BKV, Smax)) * 0.02 + 1e-3).astype(np.float32)
        scales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tscales = dict(k_scale=torch.from_numpy(ks),
                       v_scale=torch.from_numpy(vs))
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
        jq, tq, tol = jnp.asarray(q), torch.from_numpy(q), F32_TOL
    else:
        k = rng.normal(size=(BKV, Smax, D)).astype(np.float32)
        v = rng.normal(size=(BKV, Smax, D)).astype(np.float32)
        scales, tscales = {}, {}
        jdt, tdt = ((jnp.float32, torch.float32) if cache == "f32"
                    else (jnp.bfloat16, torch.bfloat16))
        jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
        tol = F32_TOL if cache == "f32" else BF16_TOL
    want = jax_decode(jq, jk, jv, jnp.int32(length), bs=16, interpret=True,
                      **scales)
    got = ops.decode_attention(tq, tk, tv, length, **tscales)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    assert ops.launch_counts()["decode_attention"] == 0


def test_decode_plain_ignores_positions_past_length():
    """Whatever the cache holds at or past ``length`` changes nothing."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 40, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 40, 8)).astype(np.float32))
    a = ref.decode_attention(q, k, v, 23)
    k[:, 23:] = 1e4
    v[:, 23:] = -1e4
    assert torch.equal(ref.decode_attention(q, k, v, 23), a)
