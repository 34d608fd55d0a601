"""Transformer building blocks of the dense family (counterpart of
``repro.models.layers``): plain functions on tensors and parameter dicts.

Layouts are the JAX package's: activations (B, S, d), heads (B, S, H, D),
projections ``wq`` (d, H, hd), ``wo`` (H, hd, d), MLP ``w_*`` (d, f) and
(f, d).  Every function casts a weight to the activations' dtype at use,
as the JAX code does; the serving path hands in weights cast once
(``Model.cast``), so the cast is then a no-op.

Attention: ``attention(impl="flash")`` runs the B7 kernel through
``kernels.ops``; ``impl="xla"`` is the JAX package's chunked online-softmax
baseline in plain PyTorch; ``decode_attention`` (bf16 cache) is plain, as in
the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import runtime

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def apply_norm(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float()
        out = out + p["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (full or partial/"2d")
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, fraction: float, theta: float):
    """(rotated dims, inverse frequencies (rot / 2,) f32), computed in numpy
    float32 as the JAX package does."""
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return rot, torch.from_numpy(np.asarray(inv, np.float32))


@functools.lru_cache(maxsize=32)
def _inv_freq_on(head_dim: int, fraction: float, theta: float,
                 device: torch.device) -> torch.Tensor:
    """The inverse frequencies, copied to ``device`` once: a copy from
    pageable host memory at every call would wait for the device's queue
    to drain, twice a layer on the decode path."""
    return rope_frequencies(head_dim, fraction, theta)[1].to(device)


def apply_rope(x, positions, *, fraction: float = 1.0,
               theta: float = 10_000.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    inv = _inv_freq_on(d, fraction, theta, x.device)
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., :, None, None].float() * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = xr[..., 0::2].float()
    x2 = xr[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < d else out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnMask:
    """Positional mask family: causal, optionally windowed, optionally with
    a bidirectional prefix, or fully bidirectional."""

    causal: bool = True
    window: Optional[int] = None     # local attention: k > q - window
    prefix: int = 0                  # first `prefix` kv positions all-visible

    def __call__(self, q_pos, k_pos):
        shape = torch.broadcast_shapes(q_pos.shape, k_pos.shape)
        ok = torch.ones(shape, dtype=torch.bool, device=q_pos.device)
        if self.causal:
            vis = k_pos <= q_pos
            if self.window is not None:
                vis &= k_pos > q_pos - self.window
            if self.prefix:
                vis |= k_pos < self.prefix
            ok &= vis
        return ok


def _gqa_scores(q, k):
    """q: (B, Sq, H, D), k: (B, Sk, KV, D) -> (B, KV, H/KV, Sq, Sk) f32
    (the JAX einsum's f32 result type: inputs widened, products in f32)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())


def _gqa_out(probs, v):
    """probs: (B, KV, g, Sq, Sk) f32, v: (B, Sk, KV, D) -> (B, Sq, H, D)
    f32."""
    B, KV, g, Sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(probs.dtype))
    return out.reshape(B, Sq, KV * g, v.shape[-1])


def fit_chunk(S: int, target: int) -> int:
    """The largest chunk up to ``target`` that divides ``S``, as the JAX
    package's modules pick theirs."""
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def chunked_attention(q, k, v, mask: AttnMask, *, chunk_q: int = 1024,
                      chunk_k: int = 1024):
    """The JAX package's memory-efficient baseline: query chunks, an
    online softmax over key chunks, at most (chunk_q x chunk_k) scores per
    (batch, head) at once; -inf masking with its isfinite guards."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / np.sqrt(D)
    chunk_q = min(chunk_q, S)
    chunk_k = min(chunk_k, Sk)
    if S % chunk_q or Sk % chunk_k:
        raise ValueError(f"chunks must divide the sequence: S={S}, Sk={Sk}, "
                         f"chunk_q={chunk_q}, chunk_k={chunk_k}")
    nq, nk = S // chunk_q, Sk // chunk_k
    KV = k.shape[2]
    g = H // KV
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * chunk_q:(qi + 1) * chunk_q]
        q_pos = qi * chunk_q + torch.arange(chunk_q, device=q.device)
        m = torch.full((B, KV, g, chunk_q), float("-inf"),
                       dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, g, chunk_q), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, KV, g, chunk_q, D), dtype=torch.float32,
                          device=q.device)
        for kj in range(nk):
            kblk = k[:, kj * chunk_k:(kj + 1) * chunk_k]
            vblk = v[:, kj * chunk_k:(kj + 1) * chunk_k]
            k_pos = kj * chunk_k + torch.arange(chunk_k, device=q.device)
            s = _gqa_scores(qblk, kblk) * scale
            ok = mask(q_pos[:, None], k_pos[None, :])
            s = torch.where(ok, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(ok, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vblk.float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, chunk_q, H, D))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention(q, k, v, mask: AttnMask, *, impl: str = "xla",
              chunk_q: int = 1024, chunk_k: int = 1024):
    """Attention dispatcher.  impl="flash": the B7 kernel (any sequence
    length, no chunks); impl="xla": :func:`chunked_attention`."""
    if impl == "flash":
        return ops.flash_attention(q, k, v, causal=mask.causal,
                                   window=mask.window, prefix=mask.prefix)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    return chunked_attention(q, k, v, mask, chunk_q=chunk_q, chunk_k=chunk_k)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                     prefix: int = 0):
    """Single-token attention against a float cache, plain.

    q: (B, 1, H, D); caches: (B, Smax, KV, D); cache_len: number of valid
    cache positions (the new token already written at cache_len - 1), a
    0-d int tensor on the device, compared there."""
    D = q.shape[-1]
    Smax = k_cache.shape[1]
    scale = 1.0 / np.sqrt(D)
    s = _gqa_scores(q, k_cache) * scale        # (B, KV, g, 1, Smax)
    k_pos = torch.arange(Smax, device=q.device)
    vis = k_pos < cache_len
    if window is not None:
        vis &= (k_pos >= cache_len - window) | (k_pos < prefix)
    s = torch.where(vis, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v_cache).to(q.dtype)


# ---------------------------------------------------------------------------
# projections, MLP, embedding, head
# ---------------------------------------------------------------------------


def _proj(x, w):
    """x (..., d) @ w (d, *out) -> (..., *out), in x's dtype."""
    w = w.to(x.dtype)
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def qkv(p, x, cfg, positions, *, rope: bool = True):
    cd = x.dtype
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if rope:
        q = apply_rope(q, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
        k = apply_rope(k, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
    return q, k, v


def attn_out(p, o):
    """o: (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    wo = p["wo"].to(o.dtype)
    return o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def mlp_hidden(p, x, act: str):
    """The MLP's hidden activation, the tensor the reference names
    ``mlp_hidden``: ``act(x @ w_gate) * (x @ w_up)`` for swiglu / geglu,
    ``gelu(x @ w_up + b_up)`` otherwise."""
    cd = x.dtype
    if act in ("swiglu", "geglu"):
        gate = x @ p["w_gate"].to(cd)
        up = x @ p["w_up"].to(cd)
        g = F.silu(gate) if act == "swiglu" else F.gelu(gate,
                                                       approximate="tanh")
        return g * up
    return F.gelu(x @ p["w_up"].to(cd) + p["b_up"].to(cd), approximate="tanh")


def mlp_out(p, h, reduce=None):
    """``h @ w_down``, summed by ``reduce`` (the tensor-parallel sum of a
    row-parallel product) before ``b_down`` is added."""
    y = h @ p["w_down"].to(h.dtype)
    if reduce is not None:
        y = reduce(y)
    if "b_down" in p:
        y = y + p["b_down"].to(h.dtype)
    return y


def apply_mlp(p, x, act: str, reduce=None):
    return mlp_out(p, mlp_hidden(p, x, act), reduce)


def embed(p, tokens, dtype):
    """The rows of ``tokens``, gathered then cast (the same numbers as
    casting the whole table first).  Under tensor parallelism the table
    is this rank's vocab block: tokens outside it give zeros, and the
    ranks' rows are summed."""
    table = p["table"]
    start = runtime.tp_offset(table.shape[0])
    if start is None:
        return table[tokens].to(dtype)
    ids = tokens - start
    inside = (ids >= 0) & (ids < table.shape[0])
    x = table[ids.clamp(0, table.shape[0] - 1)].to(dtype)
    return runtime.tp_sum(torch.where(inside[..., None], x, 0))


def lm_logits(head, x, *, tied_table=None):
    if tied_table is not None:
        return x @ tied_table.to(x.dtype).T
    return x @ head["w"].to(x.dtype)
