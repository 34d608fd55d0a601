"""Mixture-of-Experts block (counterpart of ``repro.models.moe``):
capacity-bounded top-k routing with a sort-based dispatch, for qwen3-moe
(128 experts, top 8) and phi3.5-moe (16 experts, top 2).

1. router logits in f32 (TF32 off) -> softmax -> top-k (expert, prob) a
   token, the k probabilities renormalised to sum to 1,
2. the (token, k) pairs, in ``repeat(arange(N), K)`` order, stably sorted
   by expert; each expert keeps the first C pairs of its run (GShard
   capacity C = ceil(K N / E cf), rounded up to 8), the others are dropped,
3. the kept pairs' rows gathered into an (E, C, d) buffer,
4. the expert FFN as three batched products over (E, C, .),
5. each pair's output gathered back from its (expert, slot), weighted by
   its probability, and a token's K terms summed in f32 in a fixed order.

The reference scatters the pairs into the buffer (a dropped pair into a
dead row E) and scatter-adds the outputs back; the port gathers both ways,
which keeps the same pairs and adds nothing with atomics, so a decode step
gives the same result eagerly and replayed from a CUDA graph.  Every shape
follows from static sizes and nothing is read back to the host.  The
products are plain ``torch.bmm``: the JAX package computes them as einsums
outside any kernel.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.models.params import param


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """``router`` (d, E), ``w_gate``/``w_up`` (E, d, f), ``w_down``
    (E, f, d): the JAX tree's names and shapes, drawn on ``gen``, each a
    standard normal over the square root of its product's fan-in (d for
    the router, ``w_gate`` and ``w_up``, f for ``w_down``).  The JAX init
    takes every weight's leading axis as its fan-in, which for an
    expert's weight is the expert count: at qwen3-moe's width an expert's
    output is then about 40 times a fan-in init's, and the random model
    turns a rounding into other routing (``ROADMAP.md`` §C)."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    up = ("expert", "embed", "expert_mlp")
    return {"router": param((d, E), gen, axes=("embed_no_fsdp", "expert"),
                            dtype=dtype),
            "w_gate": param((E, d, f), gen, axes=up, scale=d ** -0.5,
                            dtype=dtype),
            "w_up": param((E, d, f), gen, axes=up, scale=d ** -0.5,
                          dtype=dtype),
            "w_down": param((E, f, d), gen,
                            axes=("expert", "expert_mlp", "embed"),
                            scale=f ** -0.5, dtype=dtype)}


def capacity(n_tokens: int, num_experts: int, top_k: int, cf: float) -> int:
    c = int(math.ceil(top_k * n_tokens / num_experts * cf))
    return max(8, int(math.ceil(c / 8)) * 8)


@contextlib.contextmanager
def _no_tf32():
    """Full f32 matmuls on the card (the reference's router product)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def route(router, xt, top_k: int):
    """xt (..., d) -> (probs (..., K) f32 renormalised, experts (..., K))."""
    with _no_tf32():
        logits = torch.matmul(xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    return top_p / top_p.sum(dim=-1, keepdim=True), top_e


def sorted_runs(ids, num_ids: int, width: int):
    """Group the entries of ``ids`` (R, n) by id: each id's run of the
    stable sort, cut to ``width``.  Returns (src (R, num_ids, width): the
    entry at each (id, slot), valid (R, num_ids, width), pos (R, n): each
    entry's slot in its run).  Ids outside [0, num_ids) sort past every
    run and take no slot."""
    R, n = ids.shape
    order = torch.sort(ids, dim=1, stable=True).indices
    sid = torch.gather(ids, 1, order)
    bounds = torch.searchsorted(
        sid, torch.arange(num_ids + 1, dtype=sid.dtype, device=ids.device)
        .expand(R, -1).contiguous(), side="left")
    at = bounds[:, :-1, None] + torch.arange(width, device=ids.device)
    valid = at < bounds[:, 1:, None]
    src = torch.gather(order, 1, at.clamp(max=n - 1).reshape(R, -1))
    sorted_pos = (torch.arange(n, device=ids.device)
                  - torch.gather(bounds, 1, sid.clamp(0, num_ids).long()))
    pos = torch.empty_like(sorted_pos).scatter_(1, order, sorted_pos)
    return src.reshape(R, num_ids, width), valid, pos


def expert_ffn(xe, w_gate, w_up, w_down):
    """SwiGLU experts on their gathered rows: xe (G, C, d), w_* (G, d, f)
    and (G, f, d), cast to xe's dtype -> (G, C, d)."""
    cd = xe.dtype
    gate = torch.bmm(xe, w_gate.to(cd))
    up = torch.bmm(xe, w_up.to(cd))
    return torch.bmm(F.silu(gate) * up, w_down.to(cd))


def combine(out, at, kept, probs, n_tokens: int, top_k: int, dtype):
    """Each (token, k) pair's row ``out[at]`` (out (R, M, d), at (R, n K)),
    weighted by its probability in ``dtype``, 0 where not ``kept``; a
    token's K terms summed in f32 in k order -> (R, n, d) in ``dtype``."""
    R, _, d = out.shape
    rows = torch.gather(out, 1, at[..., None].expand(-1, -1, d))
    rows = rows * probs.to(dtype)[..., None]
    rows = torch.where(kept[..., None], rows, torch.zeros((), dtype=dtype,
                                                          device=out.device))
    return rows.float().reshape(R, n_tokens, top_k, d).sum(2).to(dtype)


def apply_moe(p, x, cfg):
    """x (B, S, d) -> (B, S, d); ``p`` holds ``router``, ``w_gate``,
    ``w_up``, ``w_down``."""
    m = cfg.moe
    B, S, d = x.shape
    N, E, K = B * S, m.num_experts, m.top_k
    C = capacity(N, E, K, m.capacity_factor)
    xt = x.reshape(N, d)
    top_p, top_e = route(p["router"], xt, K)
    flat_e = top_e.reshape(1, N * K)
    # pair j is token j // K; expert e keeps the first C pairs of its run
    src, valid, pos = sorted_runs(flat_e, E, C)
    tok = torch.where(valid, src // K, 0)[0]
    xe = torch.where(valid[0, ..., None], xt[tok], 0)
    out = expert_ffn(xe, p["w_gate"], p["w_up"], p["w_down"])
    at = flat_e * C + pos.clamp(max=C - 1)
    y = combine(out.reshape(1, E * C, d), at, pos < C, top_p.reshape(1, -1),
                N, K, x.dtype)
    return y.reshape(B, S, d)


def load_balance_stats(p, x, cfg) -> dict:
    """Each expert's share of the (token, k) pairs (``expert_load`` (E,)
    f32) and the share dropped past the capacity (``drop_frac``, 0-d)."""
    m = cfg.moe
    B, S, d = x.shape
    N, E, K = B * S, m.num_experts, m.top_k
    C = capacity(N, E, K, m.capacity_factor)
    top_e = route(p["router"], x.reshape(N, d), K)[1]
    counts = torch.bincount(top_e.reshape(-1), minlength=E)
    dropped = torch.clamp(counts - C, min=0).sum()
    return {"expert_load": counts.float() / (N * K),
            "drop_frac": dropped.float() / (N * K)}
