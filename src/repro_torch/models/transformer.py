"""Decoder-only transformer, dense family (counterpart of
``repro.models.transformer``): parameters, the training forward, KV
caches, prefill and decode.

Where the JAX package scans stacked layers, the port keeps an
``nn.ModuleList`` of :class:`Layer` modules and loops over it; its remat
(``jax.checkpoint`` of the scan body) is ``torch.utils.checkpoint`` of each
layer.  Caches keep
the JAX layouts: :class:`KVCache` (L, B, Smax, KV, hd) in a float dtype,
:class:`QuantKVCache` (L, B, KV, Smax, hd) int8 codes with (L, B, KV, Smax)
f32 scales, so that a layer's int8 cache reshapes for free to the B9
kernel's (B*KV, Smax, hd).  The JAX functions return new caches; the port
writes the new positions in place (the returned cache holds the same
tensors, with the new length), which saves a copy of the cache a step.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.params import param


class KVCache(NamedTuple):
    k: torch.Tensor    # (L, B, Smax, KV, hd)
    v: torch.Tensor
    length: int        # valid positions


class QuantKVCache(NamedTuple):
    """int8 KV cache with per-(position, head) scales; layout
    (L, B, KV, Smax, hd) so the B9 kernel gets a free reshape."""

    k: torch.Tensor        # (L, B, KV, Smax, hd) int8
    v: torch.Tensor
    k_scale: torch.Tensor  # (L, B, KV, Smax) f32
    v_scale: torch.Tensor
    length: int


def _param_dict(tensors: dict, trainable: bool) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=trainable)
                             for k, t in tensors.items()})


class Layer(nn.Module):
    """One layer's parameters: ``ln1``, ``attn``, ``ln2``, ``mlp``, each a
    dict of tensors named as in the JAX tree."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        for name, sub in tree.items():
            self.add_module(name, _param_dict(sub, trainable))


class Transformer(nn.Module):
    """All parameters of a dense transformer: ``embedding``, ``layers``
    (one :class:`Layer` each), ``final_norm`` and, when the embedding is
    not tied, ``head``.  Frozen (``requires_grad`` False) for serving;
    ``trainable`` for training, where autograd fills each ``.grad``."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        self.embedding = _param_dict(tree["embedding"], trainable)
        self.layers = nn.ModuleList(Layer(t, trainable)
                                    for t in tree["layers"])
        self.final_norm = _param_dict(tree["final_norm"], trainable)
        self.head = (_param_dict(tree["head"], trainable) if "head" in tree
                     else None)

    def tree(self) -> dict:
        """The parameters as nested dicts of tensors (layers a list)."""
        out = {"embedding": dict(self.embedding),
               "layers": [{n: dict(sub) for n, sub in lp.named_children()}
                          for lp in self.layers],
               "final_norm": dict(self.final_norm)}
        if self.head is not None:
            out["head"] = dict(self.head)
        return out

    def map(self, fn) -> "Transformer":
        """A new frozen Transformer of ``fn(t)`` for every parameter ``t``
        (detached)."""
        def sub(d):
            return {k: fn(v.detach()) for k, v in d.items()}

        t = self.tree()
        return Transformer({
            "embedding": sub(t["embedding"]),
            "layers": [{n: sub(d) for n, d in lp.items()}
                       for lp in t["layers"]],
            "final_norm": sub(t["final_norm"]),
            **({"head": sub(t["head"])} if "head" in t else {})})

    def cast(self, dtype: torch.dtype) -> "Transformer":
        """A copy with every floating parameter cast to ``dtype``."""
        return self.map(
            lambda t: t.to(dtype) if t.is_floating_point() else t)


# ---------------------------------------------------------------------------
# initialisation
# ---------------------------------------------------------------------------


def _norm(gen, d, kind, dtype):
    p = {"scale": param((d,), gen, init="ones", dtype=dtype)}
    if kind != "rmsnorm":
        p["bias"] = param((d,), gen, init="zeros", dtype=dtype)
    return p


def _layer_tree(cfg, gen, tp, dtype):
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    H, KV = cfg.padded_heads(tp)
    attn = {"wq": param((d, H, hd), gen, dtype=dtype),
            "wk": param((d, KV, hd), gen, dtype=dtype),
            "wv": param((d, KV, hd), gen, dtype=dtype),
            "wo": param((H, hd, d), gen, dtype=dtype)}
    if cfg.qkv_bias:
        attn["bq"] = param((H, hd), gen, init="zeros", dtype=dtype)
        attn["bk"] = param((KV, hd), gen, init="zeros", dtype=dtype)
        attn["bv"] = param((KV, hd), gen, init="zeros", dtype=dtype)
    if cfg.act in ("swiglu", "geglu"):
        mlp = {"w_gate": param((d, f), gen, dtype=dtype),
               "w_up": param((d, f), gen, dtype=dtype),
               "w_down": param((f, d), gen, dtype=dtype)}
    else:
        mlp = {"w_up": param((d, f), gen, dtype=dtype),
               "b_up": param((f,), gen, init="zeros", dtype=dtype),
               "w_down": param((f, d), gen, dtype=dtype),
               "b_down": param((d,), gen, init="zeros", dtype=dtype)}
    return {"ln1": _norm(gen, d, cfg.norm, dtype), "attn": attn,
            "ln2": _norm(gen, d, cfg.norm, dtype), "mlp": mlp}


def init_transformer(cfg, gen: torch.Generator, tp: int = 1,
                     trainable: bool = False) -> Transformer:
    """Random parameters in ``cfg.param_dtype`` on ``gen``'s device, by
    the JAX package's init kinds and shapes (vocab padded)."""
    dtype = getattr(torch, cfg.param_dtype)
    V = cfg.padded_vocab()
    tree = {
        "embedding": {"table": param((V, cfg.d_model), gen, init="embed",
                                     scale=0.02, dtype=dtype)},
        "layers": [_layer_tree(cfg, gen, tp, dtype)
                   for _ in range(cfg.n_layers)],
        "final_norm": _norm(gen, cfg.d_model, cfg.norm, dtype),
    }
    if not cfg.tie_embeddings:
        tree["head"] = {"w": param((cfg.d_model, V), gen, dtype=dtype)}
    return Transformer(tree, trainable)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _layer_mask(cfg) -> L.AttnMask:
    return L.AttnMask(causal=True, window=cfg.attn_window, prefix=0)


def _mlp_block(lp, x, cfg):
    h = L.apply_norm(lp.ln2, x, cfg.norm)
    return x + L.apply_mlp(lp.mlp, h, cfg.act)


def apply_layer(lp, x, cfg, positions, *, chunk_q=1024, chunk_k=1024,
                attn_impl="xla"):
    h = L.apply_norm(lp.ln1, x, cfg.norm)
    q, k, v = L.qkv(lp.attn, h, cfg, positions)
    o = L.attention(q, k, v, _layer_mask(cfg), impl=attn_impl,
                    chunk_q=chunk_q, chunk_k=chunk_k)
    x = x + L.attn_out(lp.attn, o)
    return _mlp_block(lp, x, cfg)


def _position(pos: int, device) -> torch.Tensor:
    """(1, 1) int32 position, filled on the device (no host copy, which
    would wait for the device's queue)."""
    return torch.full((1, 1), pos, dtype=torch.int32, device=device)


def apply_layer_decode(lp, x, cfg, k_cache, v_cache, cache_len: int):
    """One-token decode step of one layer against a float cache.

    x: (B, 1, d); caches: (B, Smax, KV, hd), the new position written in
    place at cache_len - 1."""
    positions = _position(cache_len - 1, x.device)
    h = L.apply_norm(lp.ln1, x, cfg.norm)
    q, k, v = L.qkv(lp.attn, h, cfg, positions)
    k_cache[:, cache_len - 1] = k[:, 0]
    v_cache[:, cache_len - 1] = v[:, 0]
    o = L.decode_attention(q, k_cache, v_cache, cache_len,
                           window=cfg.attn_window, prefix=0)
    x = x + L.attn_out(lp.attn, o)
    return _mlp_block(lp, x, cfg)


def _quantize_kv(x):
    """x: (B, 1, KV, hd) -> ((B, KV, 1, hd) int8, (B, KV, 1) f32 scale),
    in the JAX package's order of operations: round(x / amax * 127) with
    amax = max|x| + 1e-8, clipped to +-127 (round half to even, as
    jnp.round), scale amax / 127."""
    xt = x.transpose(1, 2).float()
    amax = torch.amax(torch.abs(xt), dim=-1) + 1e-8
    q = torch.clamp(torch.round(xt / amax[..., None] * 127.0), -127, 127)
    return q.to(torch.int8), amax / 127.0


def apply_layer_decode_quant(lp, x, cfg, kq, ks, vq, vs, cache_len: int):
    """Decode layer against the int8 cache through the B9 kernel.

    kq, vq: (B, KV, Smax, hd) int8; ks, vs: (B, KV, Smax) f32; the new
    position is quantised and written in place at cache_len - 1."""
    assert cfg.attn_window is None, "quant decode kernel: no window support"
    positions = _position(cache_len - 1, x.device)
    h = L.apply_norm(lp.ln1, x, cfg.norm)
    q, k, v = L.qkv(lp.attn, h, cfg, positions)
    idx = cache_len - 1
    nk, nks = _quantize_kv(k)
    nv, nvs = _quantize_kv(v)
    kq[:, :, idx] = nk[:, :, 0]
    vq[:, :, idx] = nv[:, :, 0]
    ks[:, :, idx] = nks[:, :, 0]
    vs[:, :, idx] = nvs[:, :, 0]
    B, KV, Smax, hd = kq.shape
    H = q.shape[2]
    G = H // KV
    qg = q[:, 0].reshape(B * KV, G, hd).contiguous()
    o = ops.decode_attention(
        qg, kq.reshape(B * KV, Smax, hd), vq.reshape(B * KV, Smax, hd),
        cache_len, k_scale=ks.reshape(B * KV, Smax),
        v_scale=vs.reshape(B * KV, Smax))
    o = o.reshape(B, 1, H, hd)
    x = x + L.attn_out(lp.attn, o.to(x.dtype))
    return _mlp_block(lp, x, cfg)


# ---------------------------------------------------------------------------
# full passes
# ---------------------------------------------------------------------------


REMAT_POLICIES = ("full", "none")


def remat_wrap(body, cfg, remat_policy: str = "full"):
    """The layer's remat policy (counterpart of the JAX ``remat_wrap``):
      full  -- checkpoint the whole layer: only its input is kept, the
               layer runs again in the backward (non-reentrant
               ``torch.utils.checkpoint``)
      none  -- no remat (only viable for tiny configs and tests)
    ``cfg.remat`` False means none.  Outside autograd nothing is kept
    anyway, and the body runs as it is."""
    if remat_policy == "save_hot":
        raise NotImplementedError(
            "remat policy 'save_hot' is not ported yet (ROADMAP.md queue A, "
            "item 11.1, after optim/compression.py)")
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}")
    if (not cfg.remat or remat_policy == "none"
            or not torch.is_grad_enabled()):
        return body
    return functools.partial(torch.utils.checkpoint.checkpoint, body,
                             use_reentrant=False, preserve_rng_state=False)


def forward(params: Transformer, tokens, cfg, *, chunk_q=1024, chunk_k=1024,
            attn_impl="xla", remat_policy="full"):
    """Training and prefill-style forward -> final hidden states
    (B, S, d), differentiable, each layer under ``remat_policy``."""
    cd = getattr(torch, cfg.compute_dtype)
    x = L.embed(params.embedding, tokens, cd)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    body = remat_wrap(functools.partial(
        apply_layer, cfg=cfg, positions=positions, chunk_q=chunk_q,
        chunk_k=chunk_k, attn_impl=attn_impl), cfg, remat_policy)
    for lp in params.layers:
        x = body(lp, x)
    return L.apply_norm(params.final_norm, x, cfg.norm)


def logits_from_hidden(params: Transformer, hidden, cfg):
    tied = params.embedding["table"] if cfg.tie_embeddings else None
    return L.lm_logits(params.head, hidden, tied_table=tied)


def init_cache(cfg, batch: int, max_len: int, device, tp: int = 1,
               dtype=torch.bfloat16) -> KVCache:
    _, KV = cfg.padded_heads(tp)
    shape = (cfg.n_layers, batch, max_len, KV, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def init_quant_cache(cfg, batch: int, max_len: int, device,
                     tp: int = 1) -> QuantKVCache:
    _, KV = cfg.padded_heads(tp)
    shape = (cfg.n_layers, batch, KV, max_len, cfg.resolved_head_dim)
    return QuantKVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device), 0)


def decode_step(params: Transformer, cache, token, cfg):
    """One decode step: token (B, 1) -> (logits (B, vocab), cache with the
    new position written and length + 1).  The cache flavour picks the
    attention: plain over a float cache, the B9 kernel over int8."""
    cd = getattr(torch, cfg.compute_dtype)
    x = L.embed(params.embedding, token, cd)
    new_len = cache.length + 1
    if new_len > cache.k.shape[3 if isinstance(cache, QuantKVCache) else 2]:
        raise ValueError(f"the cache holds {cache.length} positions, all "
                         f"it has room for")
    for i, lp in enumerate(params.layers):
        if isinstance(cache, QuantKVCache):
            x = apply_layer_decode_quant(lp, x, cfg, cache.k[i],
                                         cache.k_scale[i], cache.v[i],
                                         cache.v_scale[i], new_len)
        else:
            x = apply_layer_decode(lp, x, cfg, cache.k[i], cache.v[i],
                                   new_len)
    h = L.apply_norm(params.final_norm, x, cfg.norm)
    logits = logits_from_hidden(params, h, cfg)
    return logits[:, 0], cache._replace(length=new_len)


def prefill(params: Transformer, tokens, cfg, cache: KVCache, *,
            chunk_q=1024, chunk_k=1024, attn_impl="xla"):
    """Run the prompt (B, S), write its keys and values into the float
    cache (positions 0 .. S - 1, in place), return (last-position logits
    (B, vocab), the cache with length S)."""
    if not isinstance(cache, KVCache):
        raise TypeError("prefill fills a float KVCache; an int8 cache takes "
                        "its prompt one token a step through decode_step")
    cd = getattr(torch, cfg.compute_dtype)
    x = L.embed(params.embedding, tokens, cd)
    S = x.shape[1]
    if S > cache.k.shape[2]:
        raise ValueError(f"prompt of {S} tokens, the cache holds "
                         f"{cache.k.shape[2]}")
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    mask = _layer_mask(cfg)
    for i, lp in enumerate(params.layers):
        hn = L.apply_norm(lp.ln1, x, cfg.norm)
        q, k, v = L.qkv(lp.attn, hn, cfg, positions)
        cache.k[i, :, :S] = k
        cache.v[i, :, :S] = v
        o = L.attention(q, k, v, mask, impl=attn_impl, chunk_q=chunk_q,
                        chunk_k=chunk_k)
        x = x + L.attn_out(lp.attn, o)
        x = _mlp_block(lp, x, cfg)
    h = L.apply_norm(params.final_norm, x[:, -1:], cfg.norm)
    logits = logits_from_hidden(params, h, cfg)
    return logits[:, 0], cache._replace(length=S)
