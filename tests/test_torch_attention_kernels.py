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


def _attention_f64(q, k, v, causal=True, window=None, prefix=0):
    """float64 numpy attention of grouped q (BKV, G, S, D) against k, v
    (BKV, Sk, D), masked as the kernels mask: (out, lse)."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    S, D, Sk = q.shape[2], q.shape[3], k.shape[1]
    s = np.einsum("bgsd,btd->bgst", q / np.sqrt(D), k)
    if causal:
        qp, kp = np.arange(S)[:, None], np.arange(Sk)[None, :]
        vis = kp <= qp
        if window is not None:
            vis &= kp > qp - window
        if prefix:
            vis |= kp < prefix
        s = np.where(vis, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    p = np.exp(s - m)
    lse = m[..., 0] + np.log(p.sum(axis=-1))
    return np.einsum("bgst,btd->bgsd", p / p.sum(-1, keepdims=True), v), lse


def _distances(got, want, exact) -> str:
    """Each side's largest distance from the float64 answer."""
    return (f"largest distance from the float64 answer: port "
            f"{np.abs(got - exact).max():.3e}, Pallas "
            f"{np.abs(want - exact).max():.3e}")


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
    exact_o, exact_l = _attention_f64(q, k, v, **kw)
    for got, want, exact in ((_np(got_o), np.asarray(want_o), exact_o),
                             (_np(got_l), np.asarray(want_l), exact_l)):
        np.testing.assert_allclose(got, want, **F32_TOL,
                                   err_msg=_distances(got, want, exact))
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


@pytest.mark.parametrize("length", [0, 1, 37, 48, 64])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_decode_plain_matches_pallas(cache, length):
    """Lengths: none (zeros), one position, a ragged one, a block boundary
    of the Pallas kernel (bs = 16) and the whole cache; the length a 0-d
    int32 tensor, as the cache holds it."""
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
    got = ops.decode_attention(tq, tk, tv,
                               torch.tensor(length, dtype=torch.int32),
                               **tscales)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    assert ops.launch_counts()["decode_attention"] == 0


def test_decode_plain_ignores_positions_past_length():
    """Whatever the cache holds at or past ``length`` changes nothing."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 40, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 40, 8)).astype(np.float32))
    length = torch.tensor(23, dtype=torch.int32)
    a = ref.decode_attention(q, k, v, length)
    k[:, 23:] = 1e4
    v[:, 23:] = -1e4
    assert torch.equal(ref.decode_attention(q, k, v, length), a)


def test_decode_length_must_be_a_device_int32_scalar():
    """The kernel reads ``length`` on the device: the CUDA wrapper takes
    only a 0-d int32 tensor there (a host int, another dtype or shape is
    refused), and refuses CPU tensors outright."""
    from repro_torch.kernels import decode_attention as da

    da.check_length(torch.tensor(5, dtype=torch.int32), torch.device("cpu"))
    for bad in (5, torch.tensor(5), torch.tensor([5], dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int32"):
            da.check_length(bad, torch.device("cpu"))
    q = torch.zeros((2, 4, 8))
    k = torch.zeros((2, 16, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        da.decode_attention_cuda(q, k, k, torch.tensor(3, dtype=torch.int32))
    assert da.decode_attention_cuda.launches == 0


# -- the tensor-core variant's rounding (p_dtype) and the dispatch ----------

U = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}  # unit roundoff


def _online_rounded(q, k, v, p_dtype, block, causal=True, window=None,
                    prefix=0):
    """What the tensor-core B7 computes, written as its loop over key
    tiles: scores summed in float64 (another order than the plain
    version's f32), the base-2 softmax against the integer running max,
    earlier tiles rescaled by 2^(m_old - m_new), p rounded to ``p_dtype``
    before ``p v``."""
    s = ref._masked_scores(q.double(), k.double(), causal, window,
                           prefix).float()
    masked = s <= ref.NEG_INF / 2
    x = (s * ref.LOG2E).masked_fill(masked, -np.inf)
    shape = x.shape[:-1]
    m = torch.full(shape, -np.inf)
    l = torch.zeros(shape)
    acc = torch.zeros(*shape, q.shape[-1])
    for t in range(0, k.shape[1], block):
        xt = x[..., t:t + block]
        m_new = torch.maximum(m, torch.ceil(xt.amax(-1)))
        corr = torch.where(m == -np.inf, 0.0, torch.exp2(m - m_new))
        m_new0 = torch.where(m_new == -np.inf, 0.0, m_new)
        p = torch.exp2(xt - m_new0[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgst,btd->bgsd", p.to(p_dtype).float(), v[:, t:t + block].float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_plain_rounded_p_within_its_bound_of_pallas(mask, p_dtype):
    """p_dtype rounds p before p.v: each p moves by at most the unit
    roundoff u of its type, so out moves by at most u (p . |v|) / l from
    the Pallas kernel's f32 (plus the f32 tolerance); lse is unchanged."""
    q, k, v = _grouped(4, 2, 64, 64, 16, seed=11)
    kw = MASKS[mask]
    want_o, want_l = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               bq=16, bk=16, interpret=True, **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got_o, got_l = ref.flash_attention_fwd(tq, tk, tv, p_dtype=p_dtype, **kw)
    mask_args = (kw["causal"], kw.get("window"), kw.get("prefix", 0))
    p, l, _ = ref._masked_softmax_parts(ref._masked_scores(tq, tk,
                                                           *mask_args))
    bound = U[p_dtype] * torch.einsum("bgst,btd->bgsd", p, tv.abs())
    bound = bound / torch.clamp(l, min=1e-30)[..., None]
    err = np.abs(_np(got_o) - np.asarray(want_o))
    assert (err <= bound.numpy() + 2e-5 * (1 + np.abs(want_o))).all()
    assert err.max() > 0
    np.testing.assert_allclose(_np(got_l), np.asarray(want_l), **F32_TOL)


def test_flash_plain_p_dtype_none_is_the_f32_arithmetic():
    q, k, v = (torch.from_numpy(a) for a in _grouped(2, 4, 40, 40, 16, 4))
    for kw in MASKS.values():
        a = ref.flash_attention_fwd(q, k, v, **kw)
        b = ref.flash_attention_fwd(q, k, v, p_dtype=None, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="slack needs a p_dtype"):
        ref.flash_attention_fwd(q, k, v, slack=True)


@pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("S,Sk,block,kw", [
    (96, 96, 16, dict(causal=True)),
    (80, 130, 64, dict(causal=False)),
    (129, 77, 64, dict(causal=True, prefix=40)),
    (37, 37, 16, dict(causal=True, window=9)),
])
def test_flash_rounded_p_does_not_depend_on_the_tiling(S, Sk, block, kw,
                                                       p_dtype):
    """The tensor-core kernel's loop over key tiles, its scores summed in
    another order, lies within the kernel checks' bf16 tolerance (2^-8
    |want| + 1e-5) of the plain version with the same p_dtype, once p's
    that lie within ROUNDING_EPS of a rounding boundary may round either
    way (the slack): the integer running max makes the rounding the same
    whatever the tiling."""
    q, k, v = (torch.from_numpy(a).to(p_dtype).float()
               for a in _grouped(4, 4, S, Sk, 64, seed=S + block))
    got = _online_rounded(q, k, v, p_dtype, block, **kw).to(p_dtype).float()
    want, _, slack = ref.flash_attention_fwd(q, k, v, p_dtype=p_dtype,
                                             slack=True, **kw)
    lim = 2.0 ** -8 * want.abs() + 1e-5 + slack
    assert ((got - want).abs() <= lim).all()
    assert float(slack.max()) < 0.1 * float(want.abs().max())


def test_dispatch_takes_the_tensor_cores_exactly_for_bf16_f16_and_d64_128_256():
    from repro_torch.kernels import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in (8, 16, 32, 64, 96, 128, 192, 256):
            want = dtype != torch.float32 and d in (64, 128, 256)
            assert fa.uses_tensor_cores(dtype, d) is want, (dtype, d)


@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 128, "tc"), (torch.float16, 64, "tc"),
    (torch.bfloat16, 256, "tc"), (torch.float32, 128, "f32"),
    (torch.bfloat16, 16, "f32"), (torch.float16, 96, "f32")])
def test_fwd_gpu_dispatch_calls_one_variant(monkeypatch, dtype, d, variant):
    """``flash_attention_fwd_gpu`` hands the inputs to the variant that
    ``uses_tensor_cores`` names, and to no other."""
    from repro_torch.kernels import flash_attention as fa

    calls = []
    monkeypatch.setattr(fa, "flash_attention_fwd_tc_cuda",
                        lambda *a, **kw: calls.append("tc"))
    monkeypatch.setattr(fa, "flash_attention_fwd_cuda",
                        lambda *a, **kw: calls.append("f32"))
    q = torch.zeros((2, 2, 8, d), dtype=dtype)
    k = torch.zeros((2, 8, d), dtype=dtype)
    fa.flash_attention_fwd_gpu(q, k, k, causal=True)
    assert calls == [variant]


def test_cuda_wrappers_refuse_cpu_tensors_and_other_inputs():
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros((2, 2, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 8, 64), dtype=torch.bfloat16)
    for fn in (fa.flash_attention_fwd_cuda, fa.flash_attention_fwd_tc_cuda):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            fn(q, k, k)
    assert fa.flash_attention_fwd_tc_cuda.launches == 0
    assert fa.flash_attention_fwd_cuda.launches == 0
