"""Decoder-only transformer, dense and MoE families and the VLM's decoder
(counterpart of ``repro.models.transformer``): parameters, the training
forward, KV caches, prefill and decode.  The families differ in one block:
a layer's feed-forward is the dense MLP or the MoE block (``models.moe``),
chosen in :func:`_mlp_block`, which every path shares.  A VLM
(``models.vlm``) puts its projected patches in front of the tokens
(``embeddings=``), and every query sees them (the mask's ``prefix``).

Where the JAX package scans stacked layers, the port keeps an
``nn.ModuleList`` of :class:`Layer` modules and loops over it; its remat
(``jax.checkpoint`` of the scan body) is ``torch.utils.checkpoint`` of each
layer.  Caches keep
the JAX layouts: :class:`KVCache` (L, B, Smax, KV, hd) in a float dtype,
:class:`QuantKVCache` (L, B, KV, Smax, hd) int8 codes with (L, B, KV, Smax)
f32 scales, so that a layer's int8 cache reshapes for free to the B9
kernel's (B*KV, Smax, hd).  A cache's ``length`` is a 0-d int32 tensor on
its device, as in the reference: the rope position, the cache writes and
the attention mask read it there, so a decode step launches the same
kernels at every length and replays as one CUDA graph
(``serve.engine.decode_loop``).  The JAX functions return new caches; the
port writes the new positions and advances the length in place (the
returned cache holds the same tensors), which saves a copy of the cache a
step.  ``host_length`` (:class:`HostLength`) is the host's count of the
same positions, so the capacity check reads nothing from the device.
"""
from __future__ import annotations

import contextvars
import functools
import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe, runtime
from repro_torch.models.params import param


class HostLength:
    """A cache's count of valid positions on the host, beside its device
    ``length``.  Like ``length`` it is one mutable object, shared by every
    tuple ``_replace`` makes of the cache, and a step advances both in
    place, so no tuple of a cache holds a count its device length
    disagrees with."""

    __slots__ = ("n",)

    def __init__(self, n: int = 0):
        self.n = n

    def __repr__(self) -> str:
        return f"HostLength({self.n})"


class KVCache(NamedTuple):
    k: torch.Tensor          # (L, B, Smax, KV, hd)
    v: torch.Tensor
    length: torch.Tensor     # 0-d int32 on the device: valid positions
    host_length: HostLength  # the same count on the host


class QuantKVCache(NamedTuple):
    """int8 KV cache with per-(position, head) scales; layout
    (L, B, KV, Smax, hd) so the B9 kernel gets a free reshape."""

    k: torch.Tensor        # (L, B, KV, Smax, hd) int8
    v: torch.Tensor
    k_scale: torch.Tensor  # (L, B, KV, Smax) f32
    v_scale: torch.Tensor
    length: torch.Tensor   # 0-d int32 on the device
    host_length: HostLength


def _parameter(t: torch.Tensor, trainable: bool) -> nn.Parameter:
    """``t`` as a parameter, its logical axes (``params.param``) kept."""
    p = nn.Parameter(t, requires_grad=trainable)
    if hasattr(t, "axes"):
        p.axes = t.axes
    return p


def _param_dict(tensors: dict, trainable: bool) -> nn.ParameterDict:
    return nn.ParameterDict({k: _parameter(t, trainable)
                             for k, t in tensors.items()})


class Layer(nn.Module):
    """One layer's parameters, named as in the JAX tree: each dict of
    tensors a ``ParameterDict`` (a transformer layer's ``ln1``, ``attn``,
    ``ln2`` and ``mlp`` or ``moe``; an SSM or recurrent layer's
    ``norm``), each tensor a parameter of its own (an SSM layer's
    ``w_zx``, ...)."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        for name, sub in tree.items():
            if isinstance(sub, dict):
                self.add_module(name, _param_dict(sub, trainable))
            else:
                self.register_parameter(name, _parameter(sub, trainable))

    def tree(self) -> dict:
        """The layer as nested dicts of tensors."""
        out = {n: dict(sub) for n, sub in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


def _map_tree(tree, fn, name=None):
    """``fn(name, t)`` for every tensor ``t`` of nested dicts and lists
    (detached), ``name`` its key."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn, name) for v in tree]
    return fn(name, tree.detach())


class Transformer(nn.Module):
    """All parameters of a model of any family the port serves, named as
    in the JAX tree: ``embedding``, ``layers`` (one :class:`Layer` each: a
    transformer layer, an SSM or recurrent layer, or a hybrid model's
    attention layer), ``final_norm`` and, when the embedding is not tied,
    ``head``; a VLM's ``patch_proj`` beside them; an encoder-decoder's
    ``enc_layers`` and ``dec_layers`` in place of ``layers``, with
    ``enc_pos``, ``dec_pos`` (tensors) and ``enc_norm``.  A list of the
    tree becomes a ``ModuleList`` of layers, a dict a ``ParameterDict``, a
    tensor a parameter; ``head`` is None when the tree has none.  Frozen
    (``requires_grad`` False) for serving; ``trainable`` for training,
    where autograd fills each ``.grad``."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        for name, sub in tree.items():
            if isinstance(sub, list):
                self.add_module(name, nn.ModuleList(Layer(t, trainable)
                                                    for t in sub))
            elif isinstance(sub, dict):
                self.add_module(name, _param_dict(sub, trainable))
            else:
                self.register_parameter(name, _parameter(sub, trainable))
        if "head" not in tree:
            self.head = None

    def tree(self) -> dict:
        """The parameters as nested dicts of tensors (layers a list)."""
        out = {n: ([lp.tree() for lp in m] if isinstance(m, nn.ModuleList)
                   else dict(m))
               for n, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out

    def map(self, fn) -> "Transformer":
        """A new frozen Transformer of ``fn(t)`` for every parameter ``t``
        (detached)."""
        return Transformer(_map_tree(self.tree(), lambda _, t: fn(t)))

    def cast(self, dtype: torch.dtype, keep=()) -> "Transformer":
        """A copy with every floating parameter cast to ``dtype``, but
        those named in ``keep`` (the ones the model reads in f32)."""
        return Transformer(_map_tree(self.tree(), lambda k, t: (
            t.to(dtype) if t.is_floating_point() and k not in keep else t)))


# ---------------------------------------------------------------------------
# initialisation
# ---------------------------------------------------------------------------


_NORM_AXES = ("embed_no_fsdp",)


def _norm(gen, d, kind, dtype):
    p = {"scale": param((d,), gen, axes=_NORM_AXES, init="ones",
                       dtype=dtype)}
    if kind != "rmsnorm":
        p["bias"] = param((d,), gen, axes=_NORM_AXES, init="zeros",
                          dtype=dtype)
    return p


def _attn_tree(cfg, gen, tp, dtype, tp_kv=None):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.padded_heads(tp, tp_kv)
    attn = {"wq": param((d, H, hd), gen, axes=("embed", "heads", "head_dim"),
                         dtype=dtype),
            "wk": param((d, KV, hd), gen,
                        axes=("embed", "kv_heads", "head_dim"), dtype=dtype),
            "wv": param((d, KV, hd), gen,
                        axes=("embed", "kv_heads", "head_dim"), dtype=dtype),
            "wo": param((H, hd, d), gen, axes=("heads", "head_dim", "embed"),
                        dtype=dtype)}
    if cfg.qkv_bias:
        attn["bq"] = param((H, hd), gen, axes=("heads", "head_dim"),
                           init="zeros", dtype=dtype)
        attn["bk"] = param((KV, hd), gen, axes=("kv_heads", "head_dim"),
                           init="zeros", dtype=dtype)
        attn["bv"] = param((KV, hd), gen, axes=("kv_heads", "head_dim"),
                           init="zeros", dtype=dtype)
    return attn


def _mlp_tree(cfg, gen, dtype):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        up = ("embed", "mlp")
        return {"w_gate": param((d, f), gen, axes=up, dtype=dtype),
                "w_up": param((d, f), gen, axes=up, dtype=dtype),
                "w_down": param((f, d), gen, axes=("mlp", "embed"),
                                dtype=dtype)}
    return {"w_up": param((d, f), gen, axes=("embed", "mlp"), dtype=dtype),
            "b_up": param((f,), gen, axes=("mlp",), init="zeros", dtype=dtype),
            "w_down": param((f, d), gen, axes=("mlp", "embed"), dtype=dtype),
            "b_down": param((d,), gen, axes=_NORM_AXES, init="zeros",
                            dtype=dtype)}


def _layer_tree(cfg, gen, tp, dtype, tp_kv=None):
    d = cfg.d_model
    out = {"ln1": _norm(gen, d, cfg.norm, dtype),
           "attn": _attn_tree(cfg, gen, tp, dtype, tp_kv),
           "ln2": _norm(gen, d, cfg.norm, dtype)}
    if cfg.family == "moe":
        # no dense mlp beside the experts, as in the JAX init_layer
        out["moe"] = moe.init_moe(gen, cfg, dtype)
    else:
        out["mlp"] = _mlp_tree(cfg, gen, dtype)
    return out


def embedding_tree(gen, vocab: int, d: int, dtype) -> dict:
    return {"table": param((vocab, d), gen, axes=("vocab", "embed"),
                           init="embed", scale=0.02, dtype=dtype)}


def head_tree(gen, d: int, vocab: int, dtype) -> dict:
    return {"w": param((d, vocab), gen, axes=("embed", "vocab"),
                       dtype=dtype)}


def transformer_tree(cfg, gen: torch.Generator, tp: int = 1,
                     tp_kv: int | None = None) -> dict:
    """The decoder's random parameters as a tree of tensors in
    ``cfg.param_dtype`` on ``gen``'s device, by the JAX package's init
    kinds and shapes (vocab padded; q heads padded to ``tp``, kv heads to
    ``tp_kv``, ``tp`` by default)."""
    dtype = getattr(torch, cfg.param_dtype)
    V = cfg.padded_vocab()
    tree = {
        "embedding": embedding_tree(gen, V, cfg.d_model, dtype),
        "layers": [_layer_tree(cfg, gen, tp, dtype, tp_kv)
                   for _ in range(cfg.n_layers)],
        "final_norm": _norm(gen, cfg.d_model, cfg.norm, dtype),
    }
    if not cfg.tie_embeddings:
        tree["head"] = head_tree(gen, cfg.d_model, V, dtype)
    return tree


def init_transformer(cfg, gen: torch.Generator, tp: int = 1,
                     trainable: bool = False,
                     tp_kv: int | None = None) -> Transformer:
    """Random parameters of :func:`transformer_tree`."""
    return Transformer(transformer_tree(cfg, gen, tp, tp_kv), trainable)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _prefix(cfg) -> int:
    """Key positions every query sees: a VLM's image prefix, else 0."""
    return cfg.vlm.num_patches if (cfg.family == "vlm" and cfg.vlm) else 0


def _layer_mask(cfg) -> L.AttnMask:
    return L.AttnMask(causal=True, window=cfg.attn_window,
                      prefix=_prefix(cfg))


def _mlp_block(lp, x, cfg):
    """The residual feed-forward of every path: the MoE block for the MoE
    family, else the dense MLP (column-parallel ``w_gate``/``w_up``,
    row-parallel ``w_down`` under a mesh)."""
    h = L.apply_norm(lp.ln2, x, cfg.norm)
    if cfg.family == "moe":
        return x + moe.apply_moe(lp.moe, h, cfg)
    return x + L.apply_mlp(lp.mlp, runtime.tp_copy(h), cfg.act,
                           reduce=runtime.tp_sum)


# A layer in three parts, split at the tensors that ``save_hot`` keeps:
# the attention output before ``wo`` (the reference names it ``attn_out``
# on the flash path) and the MLP's hidden activation (``mlp_hidden``).
# Each part reads its parameters through ``runtime.local_params``, which
# under a mesh gathers only the weights the part uses.


def _layer_qkv(lp, x, cfg, positions):
    """A layer's q, k, v of ``x`` (column-parallel under a mesh)."""
    h = runtime.tp_copy(L.apply_norm(lp.ln1, x, cfg.norm))
    return L.qkv(lp.attn, h, cfg, positions)


def _attn_part(lp, x, cfg, positions, mask, chunk_q, chunk_k, attn_impl):
    lp = runtime.local_params(lp)
    q, k, v = _layer_qkv(lp, x, cfg, positions)
    return L.attention(q, k, v, mask, impl=attn_impl, chunk_q=chunk_q,
                       chunk_k=chunk_k)


def _mid_part(lp, x, o, cfg):
    """-> (the residual after attention, the MLP's hidden activation); a
    MoE layer's whole feed-forward, and no hidden activation."""
    lp = runtime.local_params(lp)
    x = x + runtime.tp_sum(L.attn_out(lp.attn, o))
    if cfg.family == "moe":
        return _mlp_block(lp, x, cfg), None
    h = runtime.tp_copy(L.apply_norm(lp.ln2, x, cfg.norm))
    return x, L.mlp_hidden(lp.mlp, h, cfg.act)


def _out_part(lp, x, hidden):
    if hidden is None:
        return x
    lp = runtime.local_params(lp)
    return x + L.mlp_out(lp.mlp, hidden, reduce=runtime.tp_sum)


def apply_layer(lp, x, cfg, positions, *, mask=None, chunk_q=1024,
                chunk_k=1024, attn_impl="xla"):
    """One layer.  Under ``save_hot`` (:func:`remat_wrap`) the parts up
    to the kept tensors are checkpointed each: the attention (on the
    flash path, whose output the reference keeps; the xla path recomputes
    it with the next part), then up to the MLP's hidden activation; the
    rest runs as it is."""
    attn = functools.partial(_attn_part, cfg=cfg, positions=positions,
                             mask=mask or _layer_mask(cfg), chunk_q=chunk_q,
                             chunk_k=chunk_k, attn_impl=attn_impl)
    if not _SAVE_HOT.get():
        lp = runtime.local_params(lp)
        return _out_part(lp, *_mid_part(lp, x, attn(lp, x), cfg))
    if attn_impl == "flash":
        o = runtime.checkpoint(attn, lp, x)
        x, hidden = runtime.checkpoint(
            functools.partial(_mid_part, cfg=cfg), lp, x, o)
    else:
        x, hidden = runtime.checkpoint(
            lambda lp, x: _mid_part(lp, x, attn(lp, x), cfg), lp, x)
    return _out_part(lp, x, hidden)


def _position(cache_len: torch.Tensor) -> torch.Tensor:
    """The new token's (1, 1) int32 position, cache_len - 1, computed on
    the device."""
    return (cache_len - 1).view(1, 1)


def apply_layer_decode(lp, x, cfg, k_cache, v_cache, cache_len):
    """One-token decode step of one layer against a float cache.

    x: (B, 1, d); caches: (B, Smax, KV, hd), the new position written in
    place at cache_len - 1 (cache_len a 0-d int32 tensor on the device).
    Under a mesh (``models.runtime``) the layer's parameters are read
    through ``runtime.local_params``, and x and the caches are this rank's
    batch rows and kv heads."""
    lp = runtime.local_params(lp)
    positions = _position(cache_len)
    q, k, v = _layer_qkv(lp, x, cfg, positions)
    idx = positions.view(1).long()
    k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
    o = L.decode_attention(q, k_cache, v_cache, cache_len,
                           window=cfg.attn_window, prefix=_prefix(cfg))
    x = x + runtime.tp_sum(L.attn_out(lp.attn, o))
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


def apply_layer_decode_quant(lp, x, cfg, kq, ks, vq, vs, cache_len):
    """Decode layer against the int8 cache through the B9 kernel.

    kq, vq: (B, KV, Smax, hd) int8; ks, vs: (B, KV, Smax) f32; the new
    position is quantised and written in place at cache_len - 1 (a 0-d
    int32 tensor on the device, which B9 reads there).  Under a mesh these
    are this rank's blocks (:func:`apply_layer_decode`), and B9 runs on
    the rank's (B*KV) rows, its batch rows outer and its kv heads inner
    (``runtime.fused_bkv_spec``)."""
    assert cfg.attn_window is None, "quant decode kernel: no window support"
    lp = runtime.local_params(lp)
    positions = _position(cache_len)
    q, k, v = _layer_qkv(lp, x, cfg, positions)
    idx = positions.view(1).long()
    nk, nks = _quantize_kv(k)
    nv, nvs = _quantize_kv(v)
    kq.index_copy_(2, idx, nk)
    vq.index_copy_(2, idx, nv)
    ks.index_copy_(2, idx, nks)
    vs.index_copy_(2, idx, nvs)
    B, KV, Smax, hd = kq.shape
    H = q.shape[2]
    G = H // KV
    qg = q[:, 0].reshape(B * KV, G, hd).contiguous()
    o = ops.decode_attention(
        qg, kq.reshape(B * KV, Smax, hd), vq.reshape(B * KV, Smax, hd),
        cache_len, k_scale=ks.reshape(B * KV, Smax),
        v_scale=vs.reshape(B * KV, Smax))
    o = o.reshape(B, 1, H, hd)
    x = x + runtime.tp_sum(L.attn_out(lp.attn, o.to(x.dtype)))
    return _mlp_block(lp, x, cfg)


# ---------------------------------------------------------------------------
# full passes
# ---------------------------------------------------------------------------


REMAT_POLICIES = ("full", "save_hot", "none")

# set while a layer runs under ``save_hot``: apply_layer checkpoints its
# parts itself
_SAVE_HOT: contextvars.ContextVar = contextvars.ContextVar("save_hot",
                                                           default=False)


def remat_wrap(body, cfg, remat_policy: str = "full"):
    """The layer's remat policy (counterpart of the JAX ``remat_wrap``):
      full      -- checkpoint the whole layer: only its input is kept, the
                   layer runs again in the backward (non-reentrant
                   ``torch.utils.checkpoint``)
      save_hot  -- keep the attention output before ``wo`` (flash path)
                   and the MLP's hidden activation, recompute the rest
                   (the reference's ``save_only_these_names("mlp_hidden",
                   "attn_out")``; :func:`apply_layer` splits the layer at
                   those tensors)
      none      -- no remat (only viable for tiny configs and tests)
    ``cfg.remat`` False means none.  Outside autograd nothing is kept
    anyway, and the body runs as it is.  The recompute runs under the
    forward's mesh (``runtime.checkpoint``)."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}")
    if (not cfg.remat or remat_policy == "none"
            or not torch.is_grad_enabled()):
        return body
    if remat_policy == "full":
        return functools.partial(runtime.checkpoint, body)

    def hot(*a, **kw):
        token = _SAVE_HOT.set(True)
        try:
            return body(*a, **kw)
        finally:
            _SAVE_HOT.reset(token)
    return hot


def _embed(params: Transformer, tokens, cfg, embeddings):
    """The token embeddings in the compute dtype, ``embeddings``
    (B, S_extra, d) in front of them when given; with their positions
    (1, S) int32, which count the prefix."""
    cd = getattr(torch, cfg.compute_dtype)
    x = runtime.constrain(
        L.embed(runtime.local_params(params.embedding), tokens, cd),
        "batch", None, None)
    if embeddings is not None:
        x = torch.cat([embeddings.to(cd), x], dim=1)
    S = x.shape[1]
    return x, torch.arange(S, dtype=torch.int32, device=x.device)[None, :]


def forward(params: Transformer, tokens, cfg, *, embeddings=None, mask=None,
            chunk_q=1024, chunk_k=1024, attn_impl="xla",
            remat_policy="full"):
    """Training and prefill-style forward -> final hidden states
    (B, S, d), differentiable, each layer under ``remat_policy``.
    ``embeddings`` (B, S_extra, d), a VLM's projected patches, go in front
    of the token embeddings; ``mask`` replaces the config's."""
    x, positions = _embed(params, tokens, cfg, embeddings)
    body = remat_wrap(functools.partial(
        apply_layer, cfg=cfg, positions=positions, mask=mask,
        chunk_q=chunk_q, chunk_k=chunk_k, attn_impl=attn_impl), cfg,
        remat_policy)
    for lp in params.layers:
        x = body(lp, x)
    return L.apply_norm(runtime.local_params(params.final_norm), x, cfg.norm)


def logits_from_hidden(params: Transformer, hidden, cfg):
    """The head's logits; under a mesh this rank's vocab block."""
    tied = (runtime.local_params(params.embedding)["table"]
            if cfg.tie_embeddings else None)
    return L.lm_logits(runtime.local_params(params.head),
                       runtime.tp_copy(hidden), tied_table=tied)


def _zero_length(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def init_cache(cfg, batch: int, max_len: int, device, tp: int = 1,
               dtype=torch.bfloat16, tp_kv: int | None = None) -> KVCache:
    _, KV = cfg.padded_heads(tp, tp_kv)
    shape = (cfg.n_layers, batch, max_len, KV, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   _zero_length(device), HostLength())


def init_quant_cache(cfg, batch: int, max_len: int, device,
                     tp: int = 1, tp_kv: int | None = None) -> QuantKVCache:
    _, KV = cfg.padded_heads(tp, tp_kv)
    shape = (cfg.n_layers, batch, KV, max_len, cfg.resolved_head_dim)
    return QuantKVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        _zero_length(device), HostLength())


def capacity(cache) -> float:
    """Positions the cache has room for: a KV cache's positions, an
    encoder-decoder cache's decoder positions
    (``models.encdec.EncDecCache``); no limit (``inf``) for any other
    decode state, an SSM state (``models.ssm.SSMState``) or a hybrid's
    ring buffer (``models.hybrid.HybridState``), which keep a summary or
    the last window of any number of positions."""
    from repro_torch.models.encdec import EncDecCache

    if isinstance(cache, EncDecCache):
        return cache.self_k.shape[2]
    if isinstance(cache, QuantKVCache):
        return cache.k.shape[3]
    if isinstance(cache, KVCache):
        return cache.k.shape[2]
    return math.inf


def copy_cache(cache):
    """A copy whose tensors and counts are its own: steps on the copy
    leave the original as it was.  Any decode state: a KV cache, an SSM
    state, a hybrid state (every tensor field cloned)."""
    return cache._replace(
        host_length=HostLength(cache.host_length.n),
        **{f: getattr(cache, f).clone() for f in cache._fields
           if isinstance(getattr(cache, f), torch.Tensor)})


def set_length(cache, n: int) -> None:
    """Set both counts of the cache to ``n`` positions (the device's by
    a fill: nothing is read back)."""
    cache.length.fill_(n)
    cache.host_length.n = n


def decode_step(params: Transformer, cache, token, cfg):
    """One decode step: token (B, 1) -> (logits (B, vocab), cache).  The
    cache's lengths, on the device and on the host, advance in place, the
    new position is written at length - 1, and nothing is read back from
    the device, so the step can be captured in a CUDA graph.  The cache
    flavour picks the attention: plain over a float cache, the B9 kernel
    over int8.  Under a mesh (``models.runtime``) ``token`` and the cache
    are this rank's blocks (the batch rows and kv heads that
    ``decode_state_axes`` give it) and the logits its (B_local, V_local)
    block."""
    if cache.host_length.n >= capacity(cache):
        raise ValueError(f"the cache holds {cache.host_length.n} positions, "
                         f"all it has room for")
    cd = getattr(torch, cfg.compute_dtype)
    x = L.embed(runtime.local_params(params.embedding), token, cd)
    cache.length.add_(1)
    cache.host_length.n += 1
    for i, lp in enumerate(params.layers):
        if isinstance(cache, QuantKVCache):
            x = apply_layer_decode_quant(lp, x, cfg, cache.k[i],
                                         cache.k_scale[i], cache.v[i],
                                         cache.v_scale[i], cache.length)
        else:
            x = apply_layer_decode(lp, x, cfg, cache.k[i], cache.v[i],
                                   cache.length)
    h = L.apply_norm(runtime.local_params(params.final_norm), x, cfg.norm)
    logits = logits_from_hidden(params, h, cfg)
    return logits[:, 0], cache


def prefill(params: Transformer, tokens, cfg, cache: KVCache, *,
            embeddings=None, chunk_q=1024, chunk_k=1024, attn_impl="xla"):
    """Run the prompt (B, S), ``embeddings`` (B, S_extra, d) in front of
    it when given, write its keys and values into the float cache
    (positions 0 .. S_extra + S - 1, in place) and set its length to
    S_extra + S, return (last-position logits (B, vocab), the cache).
    Under a mesh the prompt and the cache are this rank's blocks, B7 runs
    on its local (B*KV) block (``kernels.ops.flash_attention``) and the
    logits are its (B_local, V_local) block."""
    if not isinstance(cache, KVCache):
        raise TypeError("prefill fills a float KVCache; an int8 cache takes "
                        "its prompt one token a step through decode_step")
    x, positions = _embed(params, tokens, cfg, embeddings)
    S = x.shape[1]
    if S > cache.k.shape[2]:
        raise ValueError(f"prompt of {S} positions, the cache holds "
                         f"{cache.k.shape[2]}")
    mask = _layer_mask(cfg)
    for i, lp in enumerate(params.layers):
        lp = runtime.local_params(lp)
        q, k, v = _layer_qkv(lp, x, cfg, positions)
        cache.k[i, :, :S] = k
        cache.v[i, :, :S] = v
        o = L.attention(q, k, v, mask, impl=attn_impl, chunk_q=chunk_q,
                        chunk_k=chunk_k)
        x = x + runtime.tp_sum(L.attn_out(lp.attn, o))
        x = _mlp_block(lp, x, cfg)
    set_length(cache, S)
    h = L.apply_norm(runtime.local_params(params.final_norm), x[:, -1:],
                     cfg.norm)
    logits = logits_from_hidden(params, h, cfg)
    return logits[:, 0], cache
