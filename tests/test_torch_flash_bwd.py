"""The port's flash-attention backward on the CPU: the plain version of
kernel B8 (``kernels.ref.flash_attention_bwd``) against the JAX package's
Pallas backward (``jax.vjp`` of ``repro.kernels.ops.flash_attention``, in
interpret mode on the CPU) and against autograd through the plain forward,
and the ``torch.autograd.Function`` of ``kernels.ops`` against both.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it against
the same plain version there.  Tolerance: f32 gradients within 2e-5 of the
largest |gradient| of each (the same f32 arithmetic summed in another
order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import group

F32_REL = 2e-5

MASKS = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=4),
    "prefix": dict(causal=True, prefix=8),
    "window+prefix": dict(causal=True, window=4, prefix=8),
    "noncausal": dict(causal=False),
}


def _inputs(B, S, Sk, H, KV, D, seed):
    """q, k, v in the (B, S, H, D) layout and the cotangent of the
    output, as numpy f32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, D)).astype(np.float32),
            rng.normal(size=(B, S, H, D)).astype(np.float32))


def _assert_grads_close(got, want, rel=F32_REL):
    for name, g, w in zip("qkv", got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        tol = rel * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"d{name}")


def _jax_grads(q, k, v, do, **mask):
    """dq, dk, dv of the JAX package's flash attention (Pallas forward
    and backward, interpret mode on the CPU), jitted."""
    def grads(a, b, c, g):
        _, vjp = jax.vjp(lambda x, y, z: jax_ops.flash_attention(
            x, y, z, bq=16, bk=16, **mask), a, b, c)
        return vjp(g)

    return jax.jit(grads)(q, k, v, do)


def _plain_grads(q, k, v, do, **mask):
    """The plain backward through the grouped layout: grads in the
    (B, S, H, D) layout."""
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    qg, kg, vg = (t.contiguous() for t in group(tq, tk, tv))
    dog = group(tdo, tk, tv)[0].contiguous()
    out, lse = ref.flash_attention_fwd(qg, kg, vg, **mask)
    dq, dk, dv = ref.flash_attention_bwd(qg, kg, vg, out, lse, dog, **mask)
    B, KV = q.shape[0], k.shape[2]
    G = q.shape[2] // KV
    S, Sk, D = q.shape[1], k.shape[1], q.shape[3]
    dq = dq.reshape(B, KV * G, S, D).transpose(1, 2)
    dk = dk.reshape(B, KV, Sk, D).transpose(1, 2)
    dv = dv.reshape(B, KV, Sk, D).transpose(1, 2)
    return dq, dk, dv


@pytest.mark.parametrize("D", [8, 32])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (8, 1)])
def test_bwd_plain_matches_pallas(H, KV, mask, D):
    q, k, v, do = _inputs(2, 32, 32, H, KV, D, seed=H * 10 + KV + D)
    kw = MASKS[mask]
    want = _jax_grads(*(jnp.asarray(a) for a in (q, k, v, do)), **kw)
    _assert_grads_close(_plain_grads(q, k, v, do, **kw), want)


@pytest.mark.parametrize("S,Sk,mask", [
    (48, 48, "causal"), (37, 37, "window+prefix"), (32, 80, "noncausal"),
    (80, 32, "causal"), (29, 53, "prefix")])
def test_bwd_plain_matches_autograd(S, Sk, mask):
    """Ragged lengths the Pallas blocks cannot take: the written-out
    backward against autograd through the plain forward."""
    rng = np.random.default_rng(S * Sk)
    qg, kg, vg = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((4, 3, S, 16), (4, Sk, 16), (4, Sk, 16)))
    do = torch.from_numpy(rng.normal(size=(4, 3, S, 16)).astype(np.float32))
    kw = MASKS[mask]
    leaves = [t.clone().requires_grad_() for t in (qg, kg, vg)]
    out, lse = ref.flash_attention_fwd(*leaves, **kw)
    want = torch.autograd.grad(out, leaves, do)
    got = ref.flash_attention_bwd(qg, kg, vg, out.detach(), lse.detach(), do,
                                  **kw)
    _assert_grads_close(got, [w.numpy() for w in want])


def test_bwd_plain_fully_masked_rows_give_zero():
    """window = 0 masks every key of every row: every gradient is 0, as
    the TPU kernel's guards give, never NaN; autograd through the plain
    forward agrees."""
    rng = np.random.default_rng(3)
    qg, kg, vg = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((2, 2, 24, 8), (2, 24, 8), (2, 24, 8)))
    do = torch.from_numpy(rng.normal(size=(2, 2, 24, 8)).astype(np.float32))
    kw = dict(causal=True, window=0)
    out, lse = ref.flash_attention_fwd(qg, kg, vg, **kw)
    for g in ref.flash_attention_bwd(qg, kg, vg, out, lse, do, **kw):
        assert not torch.isnan(g).any() and not g.any()
    leaves = [t.clone().requires_grad_() for t in (qg, kg, vg)]
    out, _ = ref.flash_attention_fwd(*leaves, **kw)
    for g in torch.autograd.grad(out, leaves, do):
        assert not g.any()


def test_bwd_plain_bf16_matches_pallas():
    """bf16 inputs, gradients in bf16: within one bf16 rounding (2^-8)
    of the largest |gradient|, since the two round f32 sums to bf16."""
    q, k, v, do = _inputs(2, 32, 32, 8, 2, 16, seed=11)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    want = [np.asarray(w, np.float32) for w in _jax_grads(jq, jk, jv, jdo)]
    bf = [np.asarray(a, np.float32) for a in (jq, jk, jv, jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in bf)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, tdo)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_grads_close(got, want, rel=2.0 ** -8)


@pytest.mark.parametrize("mask", ["causal", "window+prefix", "noncausal"])
def test_function_matches_plain_and_pallas(mask):
    """``ops.flash_attention`` under autograd on the CPU: its gradients
    equal the plain backward's (the Function runs it), and the JAX
    package's within 2e-5; no kernel is launched, with or without
    ``use_kernels``."""
    q, k, v, do = _inputs(2, 32, 32, 8, 2, 16, seed=5)
    kw = MASKS[mask]
    ops.reset_launch_counts()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, _plain_grads(q, k, v, do, **kw)):
        assert torch.equal(g, w)
    _assert_grads_close(got, _jax_grads(
        *(jnp.asarray(a) for a in (q, k, v, do)), **kw))
    ops.use_kernels(False)
    try:
        out = ops.flash_attention(*leaves, **kw)
        again = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    finally:
        ops.use_kernels(True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 0
    assert counts["flash_attention_fwd_tc"] == 0
    assert counts["flash_attention_bwd_tc"] == 0


# -- the tensor-core variant's rounding (p_dtype) and the dispatch ----------

U = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}  # unit roundoff


def _grouped_inputs(BKV, G, S, Sk, D, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dtype).float()
                 for s in ((BKV, G, S, D), (BKV, Sk, D), (BKV, Sk, D),
                           (BKV, G, S, D)))


def _p_ds(qg, kg, vg, out, lse, do, kw):
    """The plain backward's f32 p and ds."""
    s = ref._masked_scores(qg, kg, kw["causal"], kw.get("window"),
                           kw.get("prefix", 0))
    p = torch.where(s <= ref.NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    delta = (do * out).sum(-1)
    dp = torch.einsum("bgsd,btd->bgst", do, vg)
    return p, p * (dp - delta[..., None])


def test_bwd_plain_p_dtype_none_is_the_f32_arithmetic():
    qg, kg, vg, do = _grouped_inputs(2, 4, 40, 40, 16, seed=1)
    for kw in MASKS.values():
        out, lse = ref.flash_attention_fwd(qg, kg, vg, **kw)
        a = ref.flash_attention_bwd(qg, kg, vg, out, lse, do, **kw)
        b = ref.flash_attention_bwd(qg, kg, vg, out, lse, do, p_dtype=None,
                                    **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="slack needs a p_dtype"):
        ref.flash_attention_bwd(qg, kg, vg, out, lse, do, slack=True)


@pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mask", list(MASKS))
def test_bwd_plain_rounded_within_its_bound_of_pallas(mask, p_dtype):
    """p_dtype rounds p before p^T do and ds before ds k and ds^T q: each
    moves by at most the unit roundoff u of its type, so dv moves by at
    most u (p^T |do|), dq by u (|ds| |k|) / sqrt(D) and dk by
    u (|ds|^T |q|) / sqrt(D) from the Pallas backward's f32 (plus the f32
    tolerance, 2e-5 of the largest |gradient|)."""
    q, k, v, do = _inputs(2, 32, 32, 8, 2, 16, seed=21)
    kw = MASKS[mask]
    want = _jax_grads(*(jnp.asarray(a) for a in (q, k, v, do)), **kw)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    qg, kg, vg = (t.contiguous() for t in group(tq, tk, tv))
    dog = group(tdo, tk, tv)[0].contiguous()
    out, lse = ref.flash_attention_fwd(qg, kg, vg, **kw)
    got = ref.flash_attention_bwd(qg, kg, vg, out, lse, dog,
                                  p_dtype=p_dtype, **kw)
    p, ds = _p_ds(qg, kg, vg, out, lse, dog, kw)
    scale = 1.0 / np.sqrt(16)
    u = U[p_dtype]
    bounds = (u * scale * torch.einsum("bgst,btd->bgsd", ds.abs(), kg.abs()),
              u * scale * torch.einsum("bgst,bgsd->btd", ds.abs(), qg.abs()),
              u * torch.einsum("bgst,bgsd->btd", p, dog.abs()))
    B, KV, G = 2, 2, 4
    for name, g, b, w in zip("qkv", got, bounds, want):
        if name == "q":
            g, b = (t.reshape(B, KV * G, 32, 16).transpose(1, 2)
                    for t in (g, b))
        else:
            g, b = (t.reshape(B, KV, 32, 16).transpose(1, 2) for t in (g, b))
        w = np.asarray(w, np.float32)
        err = np.abs(g.numpy() - w)
        assert (err <= b.numpy() + F32_REL * np.abs(w).max()).all(), name


def _kernel_like_bwd(qg, kg, vg, out, lse, do, p_dtype, kw):
    """The tensor-core B8's arithmetic with its products summed in
    float64 (another order than the plain version's f32): p in base 2
    against lse log2 e, p and ds rounded to ``p_dtype`` for the last
    three products."""
    s = ref._masked_scores(qg.double(), kg.double(), kw["causal"],
                           kw.get("window"), kw.get("prefix", 0)).float()
    x = s * ref.LOG2E - (lse * ref.LOG2E)[..., None]
    p = torch.where(s <= ref.NEG_INF / 2, 0.0, torch.exp2(x))
    delta = (do.double() * out.double()).sum(-1).float()
    dp = torch.einsum("bgsd,btd->bgst", do.double(), vg.double()).float()
    ds = (p * (dp - delta[..., None])).to(p_dtype).double()
    scale = 1.0 / np.sqrt(qg.shape[-1])
    dv = torch.einsum("bgst,bgsd->btd", p.to(p_dtype).double(), do.double())
    dq = torch.einsum("bgst,btd->bgsd", ds, kg.double()) * scale
    dk = torch.einsum("bgst,bgsd->btd", ds, qg.double()) * scale
    return tuple(t.float().to(p_dtype).float() for t in (dq, dk, dv))


@pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("BKV,G,S,Sk,kw", [
    (4, 8, 96, 96, dict(causal=True)),
    (4, 3, 129, 77, dict(causal=True, prefix=40)),
    (2, 8, 37, 37, dict(causal=True, window=9)),
    (8, 4, 32, 80, dict(causal=False)),
])
def test_bwd_kernel_arithmetic_within_tolerance_and_slack(BKV, G, S, Sk, kw,
                                                          p_dtype):
    """The tensor-core kernel's arithmetic, its sums in another order,
    lies within the kernel checks' bf16 tolerance (2^-8 |want| + 2e-5
    max |want|) of the plain version with the same p_dtype, once p's and
    ds's within ROUNDING_EPS of a rounding boundary may round either way
    (the slack)."""
    qg, kg, vg, do = _grouped_inputs(BKV, G, S, Sk, 64, seed=S + Sk,
                                     dtype=p_dtype)
    out, lse = ref.flash_attention_fwd(qg, kg, vg, **kw)
    out = out.to(p_dtype).float()
    got = _kernel_like_bwd(qg, kg, vg, out, lse, do, p_dtype, kw)
    want, slack = ref.flash_attention_bwd(qg, kg, vg, out, lse, do,
                                          p_dtype=p_dtype, slack=True, **kw)
    for name, g, w, sl in zip("qkv", got, want, slack):
        lim = 2.0 ** -8 * w.abs() + 2e-5 * float(w.abs().max()) + sl
        assert ((g - w).abs() <= lim).all(), name


@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 128, "tc"), (torch.float16, 256, "tc"),
    (torch.bfloat16, 64, "tc"), (torch.float32, 64, "f32"),
    (torch.bfloat16, 32, "f32"), (torch.float16, 8, "f32")])
def test_bwd_gpu_dispatch_calls_one_variant(monkeypatch, dtype, d, variant):
    """``flash_attention_bwd_gpu`` hands the inputs to the variant that
    ``uses_tensor_cores`` names, and to no other."""
    from repro_torch.kernels import flash_attention_bwd as fb

    calls = []
    monkeypatch.setattr(fb, "flash_attention_bwd_tc_cuda",
                        lambda *a, **kw: calls.append("tc"))
    monkeypatch.setattr(fb, "flash_attention_bwd_cuda",
                        lambda *a, **kw: calls.append("f32"))
    q = torch.zeros((2, 2, 8, d), dtype=dtype)
    k = torch.zeros((2, 8, d), dtype=dtype)
    lse = torch.zeros((2, 2, 8))
    fb.flash_attention_bwd_gpu(q, k, k, q, lse, q, causal=True)
    assert calls == [variant]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fb._check(q, k, k, q, lse, q, "flash_attention_bwd_tc_cuda")
