"""Whisper-medium encoder-decoder backbone (counterpart of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the JAX package: the input holds
precomputed frame embeddings (B, enc_seq, d).  Encoder: unmasked
self-attention, learned positions, layernorm and gelu.  Decoder: causal
self-attention, then unmasked cross-attention over the encoder states.
Under ``attn_impl="flash"`` all three attentions run the B7 kernel (the
encoder's and the cross attention without a mask, the cross attention
with S queries against enc_seq keys).

Parameters are a :class:`~repro_torch.models.transformer.Transformer` with
the JAX tree's names: ``embedding``, ``enc_pos``, ``dec_pos``,
``enc_layers`` (``ln1``, ``attn``, ``ln2``, ``mlp``), ``dec_layers``
(``ln1``, ``self_attn``, ``ln_cross``, ``cross_attn``, ``ln2``, ``mlp``),
``enc_norm`` and ``final_norm``.  The cache (:class:`EncDecCache`) holds
the decoder's keys and values and the cross keys and values of every
layer; as in ``models.transformer``, its ``length`` is a 0-d int32 tensor
on the device, which the decode step reads there (the learned position,
the cache write, the mask) and advances in place, so that
``serve.engine.decode_loop`` captures a step in a CUDA graph.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import param

_NORM = "layernorm"
_ACT = "gelu"
_SELF = L.AttnMask(causal=True)
_UNMASKED = L.AttnMask(causal=False)


_POS_AXES = ("seq", "embed_no_fsdp")


class EncDecCache(NamedTuple):
    self_k: torch.Tensor       # (L, B, Smax, KV, hd)
    self_v: torch.Tensor
    cross_k: torch.Tensor      # (L, B, enc_seq, KV, hd)
    cross_v: torch.Tensor
    length: torch.Tensor       # 0-d int32 on the device: decoder positions
    host_length: T.HostLength  # the same count on the host


def _dec_layer_tree(cfg, gen, tp, dtype, tp_kv=None) -> dict:
    d = cfg.d_model
    return {"ln1": T._norm(gen, d, _NORM, dtype),
            "self_attn": T._attn_tree(cfg, gen, tp, dtype, tp_kv),
            "ln_cross": T._norm(gen, d, _NORM, dtype),
            "cross_attn": T._attn_tree(cfg, gen, tp, dtype, tp_kv),
            "ln2": T._norm(gen, d, _NORM, dtype),
            "mlp": T._mlp_tree(cfg, gen, dtype)}


def init_encdec(cfg, gen: torch.Generator, tp: int = 1,
                trainable: bool = False, tp_kv: int | None = None
                ) -> T.Transformer:
    """Random parameters in ``cfg.param_dtype`` on ``gen``'s device, by
    the JAX package's init kinds and shapes (vocab padded; ``dec_pos`` has
    ``cfg.max_seq`` rows)."""
    dtype = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    tree = {
        "embedding": T.embedding_tree(gen, cfg.padded_vocab(), d, dtype),
        "enc_pos": param((cfg.encdec.enc_seq, d), gen, axes=_POS_AXES,
                         init="embed",
                         scale=0.02, dtype=dtype),
        "dec_pos": param((cfg.max_seq, d), gen, axes=_POS_AXES, init="embed",
                         scale=0.02,
                         dtype=dtype),
        "enc_layers": [{"ln1": T._norm(gen, d, _NORM, dtype),
                        "attn": T._attn_tree(cfg, gen, tp, dtype, tp_kv),
                        "ln2": T._norm(gen, d, _NORM, dtype),
                        "mlp": T._mlp_tree(cfg, gen, dtype)}
                       for _ in range(cfg.encdec.n_enc_layers)],
        "dec_layers": [_dec_layer_tree(cfg, gen, tp, dtype, tp_kv)
                       for _ in range(cfg.n_layers)],
        "enc_norm": T._norm(gen, d, _NORM, dtype),
        "final_norm": T._norm(gen, d, _NORM, dtype),
    }
    if not cfg.tie_embeddings:
        tree["head"] = T.head_tree(gen, d, cfg.padded_vocab(), dtype)
    return T.Transformer(tree, trainable)


def _ffn(lp, x):
    return x + L.apply_mlp(lp.mlp, L.apply_norm(lp.ln2, x, _NORM), _ACT)


def _enc_layer(lp, x, cfg, positions, chunk, attn_impl):
    h = L.apply_norm(lp.ln1, x, _NORM)
    q, k, v = L.qkv(lp.attn, h, cfg, positions, rope=False)
    o = L.attention(q, k, v, _UNMASKED, impl=attn_impl, chunk_q=chunk,
                    chunk_k=chunk)
    return _ffn(lp, x + L.attn_out(lp.attn, o))


def encode(params: T.Transformer, frames, cfg, *, chunk=512,
           attn_impl="xla"):
    """frames (B, enc_seq, d), the stub frontend's embeddings -> encoder
    states (B, enc_seq, d) in the compute dtype."""
    cd = getattr(torch, cfg.compute_dtype)
    S = frames.shape[1]
    x = frames.to(cd) + params.enc_pos.to(cd)[None, :S]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    body = T.remat_wrap(functools.partial(
        _enc_layer, cfg=cfg, positions=positions,
        chunk=L.fit_chunk(S, chunk), attn_impl=attn_impl), cfg)
    for lp in params.enc_layers:
        x = body(lp, x)
    return L.apply_norm(params.enc_norm, x, _NORM)


def _cross_kv(lp, enc):
    """A decoder layer's cross keys and values (B, enc_seq, KV, hd) of
    the encoder states, in their dtype."""
    ca = lp.cross_attn
    return L._proj(enc, ca["wk"]), L._proj(enc, ca["wv"])


def _dec_layer(lp, x, enc, cfg, positions, chunk_q, chunk_k, attn_impl):
    """One decoder layer over the whole sequence -> (x, its self keys and
    values, its cross keys and values)."""
    h = L.apply_norm(lp.ln1, x, _NORM)
    q, k, v = L.qkv(lp.self_attn, h, cfg, positions, rope=False)
    o = L.attention(q, k, v, _SELF, impl=attn_impl, chunk_q=chunk_q,
                    chunk_k=chunk_q)
    x = x + L.attn_out(lp.self_attn, o)
    h = L.apply_norm(lp.ln_cross, x, _NORM)
    q = L._proj(h, lp.cross_attn["wq"])
    ek, ev = _cross_kv(lp, enc)
    o = L.attention(q, ek, ev, _UNMASKED, impl=attn_impl, chunk_q=chunk_q,
                    chunk_k=chunk_k)
    return _ffn(lp, x + L.attn_out(lp.cross_attn, o)), (k, v, ek, ev)


def _dec_input(params, tokens, cfg):
    cd = getattr(torch, cfg.compute_dtype)
    S = tokens.shape[1]
    x = L.embed(params.embedding, tokens, cd) + params.dec_pos.to(cd)[None, :S]
    return x, torch.arange(S, dtype=torch.int32, device=x.device)[None, :]


def decode_train(params: T.Transformer, tokens, enc_states, cfg, *,
                 chunk_q=1024, chunk_k=1024, attn_impl="xla"):
    """Teacher-forced decoder pass -> hidden states (B, S, d),
    differentiable, each layer under the remat policy."""
    x, positions = _dec_input(params, tokens, cfg)
    body = T.remat_wrap(lambda lp, h, enc: _dec_layer(
        lp, h, enc, cfg, positions, L.fit_chunk(tokens.shape[1], chunk_q),
        L.fit_chunk(enc_states.shape[1], chunk_k), attn_impl)[0], cfg)
    for lp in params.dec_layers:
        x = body(lp, x, enc_states)
    return L.apply_norm(params.final_norm, x, _NORM)


def forward(params: T.Transformer, tokens, frames, cfg, attn_impl="xla",
            **kw):
    """Encoder then teacher-forced decoder -> hidden states (B, S, d)."""
    enc = encode(params, frames, cfg, attn_impl=attn_impl)
    return decode_train(params, tokens, enc, cfg, attn_impl=attn_impl, **kw)


def init_cache(cfg, batch: int, max_len: int, device, tp: int = 1,
               dtype=torch.bfloat16, tp_kv: int | None = None
               ) -> EncDecCache:
    """An empty cache of ``max_len`` decoder positions (at most
    ``cfg.max_seq``: the learned positions end there)."""
    if max_len > cfg.max_seq:
        raise ValueError(f"{max_len} decoder positions, the model's learned "
                         f"positions end at {cfg.max_seq}")
    _, KV = cfg.padded_heads(tp, tp_kv)
    hd = cfg.resolved_head_dim
    self_shape = (cfg.n_layers, batch, max_len, KV, hd)
    cross_shape = (cfg.n_layers, batch, cfg.encdec.enc_seq, KV, hd)
    return EncDecCache(
        *(torch.zeros(s, dtype=dtype, device=device)
          for s in (self_shape, self_shape, cross_shape, cross_shape)),
        T._zero_length(device), T.HostLength())


def fill_cross_cache(params: T.Transformer, enc_states, cfg,
                     cache: EncDecCache) -> EncDecCache:
    """Write every layer's cross keys and values of ``enc_states`` into
    the cache, in place (once a request); returns the cache."""
    for i, lp in enumerate(params.dec_layers):
        ek, ev = _cross_kv(lp, enc_states)
        cache.cross_k[i] = ek
        cache.cross_v[i] = ev
    return cache


def prefill(params: T.Transformer, tokens, frames, cfg, cache: EncDecCache,
            *, chunk_q=1024, chunk_k=1024, attn_impl="xla"):
    """Encode ``frames`` (through ``attn_impl`` too, so that the flash
    prefill runs the encoder through B7), run the prompt (B, S) through
    the decoder, write its self keys and values (positions 0 .. S - 1)
    and every layer's cross keys and values into the cache in place (the
    attention reads them in the compute dtype, the cache keeps them in
    its own), set its length to S; return (last-position logits
    (B, vocab), the cache)."""
    S = tokens.shape[1]
    if S > cache.self_k.shape[2]:
        raise ValueError(f"prompt of {S} tokens, the cache holds "
                         f"{cache.self_k.shape[2]}")
    enc = encode(params, frames, cfg, attn_impl=attn_impl)
    x, positions = _dec_input(params, tokens, cfg)
    cq, ck = L.fit_chunk(S, chunk_q), L.fit_chunk(enc.shape[1], chunk_k)
    for i, lp in enumerate(params.dec_layers):
        x, (k, v, ek, ev) = _dec_layer(lp, x, enc, cfg, positions, cq, ck,
                                       attn_impl)
        cache.self_k[i, :, :S] = k
        cache.self_v[i, :, :S] = v
        cache.cross_k[i] = ek
        cache.cross_v[i] = ev
    T.set_length(cache, S)
    h = L.apply_norm(params.final_norm, x[:, -1:], _NORM)
    return T.logits_from_hidden(params, h, cfg)[:, 0], cache


def decode_step(params: T.Transformer, cache: EncDecCache, token, cfg):
    """One decoder token (B, 1) against the self and cross caches ->
    (logits (B, vocab), cache).  The learned position, the cache write
    and the mask read the device length, which advances in place with the
    host's; nothing is read back, so the step can be captured in a CUDA
    graph."""
    if cache.host_length.n >= cache.self_k.shape[2]:
        raise ValueError(f"the cache holds {cache.host_length.n} positions, "
                         f"all it has room for")
    cd = getattr(torch, cfg.compute_dtype)
    cache.length.add_(1)
    cache.host_length.n += 1
    idx = (cache.length - 1).view(1).long()
    x = (L.embed(params.embedding, token, cd)
         + params.dec_pos.index_select(0, idx).to(cd)[None])
    n_enc = cache.cross_k.shape[2]
    for i, lp in enumerate(params.dec_layers):
        sk, sv = cache.self_k[i], cache.self_v[i]
        h = L.apply_norm(lp.ln1, x, _NORM)
        q, k, v = L.qkv(lp.self_attn, h, cfg, None, rope=False)
        sk.index_copy_(1, idx, k.to(sk.dtype))
        sv.index_copy_(1, idx, v.to(sv.dtype))
        o = L.decode_attention(q, sk, sv, cache.length)
        x = x + L.attn_out(lp.self_attn, o)
        h = L.apply_norm(lp.ln_cross, x, _NORM)
        q = L._proj(h, lp.cross_attn["wq"])
        o = L.decode_attention(q, cache.cross_k[i], cache.cross_v[i], n_enc)
        x = _ffn(lp, x + L.attn_out(lp.cross_attn, o))
    h = L.apply_norm(params.final_norm, x, _NORM)
    return T.logits_from_hidden(params, h, cfg)[:, 0], cache
