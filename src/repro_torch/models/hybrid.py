"""RecurrentGemma (recurrentgemma-2b): RG-LRU recurrent blocks and local
sliding-window attention in a (rec, rec, attn) pattern (counterpart of
``repro.models.hybrid``).

The RG-LRU recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
is a first-order linear recurrence: the JAX package runs
``lax.associative_scan``, the port log2(S) doubling steps over (a, b)
pairs in plain PyTorch (another rounding order).  The decode state is
the (B, lru_width) hidden, the conv tail and a ring buffer of the last
``window`` keys and values; it has no position limit.

The JAX package stores both blocks in every layer, so that ``lax.scan``
sees one tree, runs both and keeps one with ``jnp.where``.  The port holds
and runs only the live block: an attention layer is a transformer
:class:`~repro_torch.models.transformer.Layer` (``ln1``, ``attn``,
``ln2``, ``mlp``) that goes through ``transformer.apply_layer`` (so
``attn_impl="flash"`` reaches B7 with the window), a recurrent layer
holds ``norm``, ``w_x``, ``w_gate``, ``conv``, ``lambda_p``, ``w_a``,
``b_a``, ``w_i``, ``b_i`` and ``out_proj``.  The state keeps every
layer's slots, as the JAX one does; a layer writes only its own kind's
(the JAX package also writes the inert ones, which nothing reads).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import param

_C = 8.0    # RG-LRU temperature
_CONV = 4   # the recurrent block's conv width


# parameters the recurrent block reads in f32 whatever the compute dtype
# (the JAX function's ``.astype(jnp.float32)``): ``Model.cast`` keeps them
F32_PARAMS = ("lambda_p", "w_a", "b_a", "w_i", "b_i")


class HybridState(NamedTuple):
    lru: torch.Tensor          # (layers, B, lru_width) f32 recurrent hidden
    conv: torch.Tensor         # (layers, B, W-1, lru_width) conv tail
    k: torch.Tensor            # (layers, B, window, KV, hd) ring buffer
    v: torch.Tensor
    length: torch.Tensor       # 0-d int32 on the device: positions seen
    host_length: T.HostLength  # the same count on the host


def is_attn_layer(cfg, i: int) -> bool:
    hy = cfg.hybrid
    return i % hy.period == hy.attn_position


def init_rec_layer(cfg, gen: torch.Generator, dtype) -> dict:
    d = cfg.d_model
    lw = cfg.hybrid.lru_width or d
    return {
        "norm": T._norm(gen, d, "rmsnorm", dtype),
        "w_x": param((d, lw), gen, axes=("embed", "mlp"), dtype=dtype),
        "w_gate": param((d, lw), gen, axes=("embed", "mlp"), dtype=dtype),
        "conv": param((_CONV, lw), gen, axes=("conv", "mlp"), scale=0.1,
                      dtype=dtype),
        "lambda_p": param((lw,), gen, axes=("mlp",), init="ones",
                          dtype=dtype),
        "w_a": param((lw, lw), gen, axes=("mlp", None), dtype=dtype),
        "b_a": param((lw,), gen, axes=(None,), init="zeros", dtype=dtype),
        "w_i": param((lw, lw), gen, axes=("mlp", None), dtype=dtype),
        "b_i": param((lw,), gen, axes=(None,), init="zeros", dtype=dtype),
        "out_proj": param((lw, d), gen, axes=("mlp", "embed"), dtype=dtype),
    }


def init_hybrid(cfg, gen: torch.Generator, tp: int = 1,
                trainable: bool = False, tp_kv: int | None = None
                ) -> T.Transformer:
    """Random parameters of the live blocks in ``cfg.param_dtype`` on
    ``gen``'s device, by the JAX package's init kinds and shapes."""
    dtype = getattr(torch, cfg.param_dtype)
    tree = {
        "embedding": T.embedding_tree(gen, cfg.padded_vocab(), cfg.d_model,
                                      dtype),
        "layers": [T._layer_tree(cfg, gen, tp, dtype, tp_kv) if is_attn_layer(cfg, i)
                   else init_rec_layer(cfg, gen, dtype)
                   for i in range(cfg.n_layers)],
        "final_norm": T._norm(gen, cfg.d_model, "rmsnorm", dtype),
    }
    return T.Transformer(tree, trainable)


def _lru_scan(a, bx, h0=None):
    """h_t = a_t * h_{t-1} + bx_t along axis 1 (a, bx: (B, S, lw) f32):
    log2(S) doubling steps, each combining every position with the one
    ``d`` before it, ``(a_l * a_r, b_l * a_r + b_r)``."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], 1)
    S = a.shape[1]
    d = 1
    while d < S:
        bx = torch.cat([bx[:, :d], bx[:, :-d] * a[:, d:] + bx[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1)
        d *= 2
    return bx


def apply_rec_block(p, x, *, state=None, conv_tail=None):
    """RG-LRU block.  Training and prefill: ``state`` None, the whole
    sequence.  Decode: x (B, 1, d) with the layer's ``state`` (B, lw) and
    ``conv_tail`` (B, W-1, lw).  Returns (y, new state, new conv tail)."""
    cd = x.dtype
    h = L.apply_norm(p.norm, x, "rmsnorm")
    xin = L._proj(h, p.w_x)
    gate = L._proj(h, p.w_gate)
    kernel = p.conv.to(cd)
    W = kernel.shape[0]
    if conv_tail is None:
        xp = F.pad(xin, (0, 0, W - 1, 0))
    else:
        wd = torch.promote_types(conv_tail.dtype, cd)
        xp = torch.cat([conv_tail.to(wd), xin.to(wd)], dim=1)
        kernel = kernel.to(wd)
    conv = torch.zeros_like(xp[:, W - 1:])
    for w in range(W):
        conv = conv + xp[:, w:w + xin.shape[1]] * kernel[w]
    new_tail = xp[:, -(W - 1):]
    u = conv.float()
    r = torch.sigmoid(u @ p.w_a.float() + p.b_a.float())
    i = torch.sigmoid(u @ p.w_i.float() + p.b_i.float())
    log_a = -_C * r * F.softplus(p.lambda_p.float())
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u)
    if x.shape[1] == 1 and state is not None:
        new_state = a[:, 0] * state + gated_in[:, 0]
        hseq = new_state[:, None]
    else:
        hseq = _lru_scan(a, gated_in, h0=state)
        new_state = hseq[:, -1]
    y = hseq.to(cd) * F.gelu(gate, approximate="tanh")
    return x + L._proj(y, p.out_proj), new_state, new_tail


def forward(params: T.Transformer, tokens, cfg, *, chunk_q=1024,
            chunk_k=1024, attn_impl="xla"):
    """Training forward -> final hidden states (B, S, d): each layer's
    live block, under the remat policy."""
    cd = getattr(torch, cfg.compute_dtype)
    x = L.embed(params.embedding, tokens, cd)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    attn = T.remat_wrap(functools.partial(
        T.apply_layer, cfg=cfg, positions=positions, chunk_q=chunk_q,
        chunk_k=chunk_k, attn_impl=attn_impl), cfg)
    rec = T.remat_wrap(lambda lp, h: apply_rec_block(lp, h)[0], cfg)
    for i, lp in enumerate(params.layers):
        x = attn(lp, x) if is_attn_layer(cfg, i) else rec(lp, x)
    return L.apply_norm(params.final_norm, x, "rmsnorm")


def init_state(cfg, batch: int, device, tp: int = 1,
               dtype=torch.bfloat16, tp_kv: int | None = None) -> HybridState:
    lw = cfg.hybrid.lru_width or cfg.d_model
    _, KV = cfg.padded_heads(tp, tp_kv)
    ring = (cfg.n_layers, batch, cfg.hybrid.window, KV,
            cfg.resolved_head_dim)
    return HybridState(
        lru=torch.zeros((cfg.n_layers, batch, lw), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((cfg.n_layers, batch, _CONV - 1, lw), dtype=dtype,
                         device=device),
        k=torch.zeros(ring, dtype=dtype, device=device),
        v=torch.zeros(ring, dtype=dtype, device=device),
        length=T._zero_length(device), host_length=T.HostLength())


def _ring(S: int, Wd: int, device):
    """(positions (Wd,), valid (Wd,)): slot s holds the latest prompt
    position p < S with p % Wd == s, valid where such a p exists."""
    slots = torch.arange(Wd, device=device)
    r = S % Wd
    if S >= Wd:
        pos = torch.where(slots < r, S - r + slots, S - Wd - r + slots)
    else:
        pos = slots
    return pos.clamp(0, S - 1), slots < S


def prefill(params: T.Transformer, tokens, cfg, state: HybridState, *,
            chunk_q=1024, chunk_k=1024, attn_impl="xla"):
    """Run the prompt (B, S), write each recurrent layer's LRU state and
    conv tail and each attention layer's last ``window`` keys and values
    at their ring slots into ``state`` in place (conv tails and k/v
    rounded to bf16 first, as the JAX prefill does whatever the state's
    dtype), set its length to S; return (last-position logits (B, vocab),
    the state)."""
    cd = getattr(torch, cfg.compute_dtype)
    x = L.embed(params.embedding, tokens, cd)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    ring_pos, ring_valid = _ring(S, cfg.hybrid.window, x.device)
    mask = T._layer_mask(cfg)
    for i, lp in enumerate(params.layers):
        if is_attn_layer(cfg, i):
            hn = L.apply_norm(lp.ln1, x, cfg.norm)
            q, k, v = L.qkv(lp.attn, hn, cfg, positions)
            o = L.attention(q, k, v, mask, impl=attn_impl,
                            chunk_q=min(chunk_q, S), chunk_k=min(chunk_k, S))
            x = x + L.attn_out(lp.attn, o)
            x = T._mlp_block(lp, x, cfg)
            valid = ring_valid[None, :, None, None]
            state.k[i].copy_(torch.where(valid, k[:, ring_pos], 0)
                             .to(torch.bfloat16))
            state.v[i].copy_(torch.where(valid, v[:, ring_pos], 0)
                             .to(torch.bfloat16))
        else:
            x, lru, tail = apply_rec_block(lp, x)
            state.lru[i].copy_(lru)
            state.conv[i].copy_(tail.to(torch.bfloat16))
    T.set_length(state, S)
    h = L.apply_norm(params.final_norm, x[:, -1:], "rmsnorm")
    logits = T.logits_from_hidden(params, h, cfg)
    return logits[:, 0], state


def _attn_decode(lp, x, cfg, kc, vc, pos):
    """One attention layer's decode step against its ring buffer
    (B, window, KV, hd): the new key and value written at slot
    pos % window in place (pos a (1, 1) int32 tensor on the device),
    plain attention over the valid slots."""
    Wd = kc.shape[1]
    hn = L.apply_norm(lp.ln1, x, cfg.norm)
    q, k, v = L.qkv(lp.attn, hn, cfg, pos)
    slot = (pos.view(1) % Wd).long()
    kc.index_copy_(1, slot, k.to(kc.dtype))
    vc.index_copy_(1, slot, v.to(vc.dtype))
    s = L._gqa_scores(q, kc) / math.sqrt(q.shape[-1])
    vis = torch.arange(Wd, device=x.device) < torch.clamp(pos + 1, max=Wd)
    s = torch.where(vis.view(-1), s, float("-inf"))
    o = L._gqa_out(torch.softmax(s, dim=-1), vc)
    x = x + L.attn_out(lp.attn, o.to(x.dtype))
    return T._mlp_block(lp, x, cfg)


def decode_step(params: T.Transformer, state: HybridState, token, cfg):
    """One decode step: token (B, 1) -> (logits (B, vocab), state).  The
    new token's position and ring slot are read from the device
    ``length``; the state's tensors and both lengths are updated in
    place and nothing is read back, so the step can be captured in a CUDA
    graph."""
    cd = getattr(torch, cfg.compute_dtype)
    x = L.embed(params.embedding, token, cd)
    pos = state.length.view(1, 1).clone()   # the new token's position
    state.length.add_(1)
    state.host_length.n += 1
    for i, lp in enumerate(params.layers):
        if is_attn_layer(cfg, i):
            x = _attn_decode(lp, x, cfg, state.k[i], state.v[i], pos)
        else:
            x, lru, tail = apply_rec_block(lp, x, state=state.lru[i],
                                           conv_tail=state.conv[i])
            state.lru[i].copy_(lru)
            state.conv[i].copy_(tail)
    h = L.apply_norm(params.final_norm, x, "rmsnorm")
    logits = T.logits_from_hidden(params, h, cfg)
    return logits[:, 0], state
