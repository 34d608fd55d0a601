"""Model facade (counterpart of ``repro.models.model``): one object per
architecture exposing init / loss / prefill / decode for the trainer and
the server.

The loss computes cross-entropy in SEQUENCE CHUNKS, each checkpointed, so
the (B, S, vocab) f32 logits never exist whole.  The port trains and
serves the dense family and serves every other family of the JAX
package: MoE (``models.moe``), SSM (``models.ssm``), hybrid
(``models.hybrid``), encoder-decoder (``models.encdec``) and VLM
(``models.vlm``), whose ``hidden`` and ``loss`` run too.  The
encoder-decoder reads ``batch["frames"]`` (B, enc_seq, d), the VLM
``batch["patches"]`` (B, num_patches, patch_dim): the stub frontends'
inputs.  As in the JAX package, ``cache_quant`` changes nothing for the
SSM, hybrid and encoder-decoder families: their decode state is no
``KVCache``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import encdec, hybrid, runtime, ssm, vlm
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import logical_axes

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    tp: int = 1                    # head-shard degree: pads the heads
    tp_kv: int | None = None       # kv-head shard degree (decode-opt layout)
    cache_quant: bool = False      # int8 KV cache through the B9 kernel

    def __post_init__(self):
        if self.cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {self.cfg.family!r}")

    # ---- parameters -------------------------------------------------------
    def init(self, seed: int = 0, *, device=None,
             trainable: bool = False) -> T.Transformer:
        """Random parameters in ``cfg.param_dtype``, drawn on the device
        (``cuda`` unless the caller names another) from a
        ``torch.Generator`` seeded with ``seed``; frozen for serving,
        ``trainable`` for training.  A hybrid model holds each layer's
        live block only (the JAX tree holds both)."""
        return self._init(torch.Generator(resolve_device(device))
                          .manual_seed(seed), trainable)

    def _init(self, gen, trainable: bool = False) -> T.Transformer:
        cfg, tp, tp_kv = self.cfg, self.tp, self.tp_kv
        if cfg.family == "ssm":
            return ssm.init_mamba(cfg, gen, trainable)
        if cfg.family == "hybrid":
            return hybrid.init_hybrid(cfg, gen, tp, trainable, tp_kv)
        if cfg.family == "encdec":
            return encdec.init_encdec(cfg, gen, tp, trainable, tp_kv)
        if cfg.family == "vlm":
            return vlm.init_vlm(cfg, gen, tp, trainable, tp_kv)
        return T.init_transformer(cfg, gen, tp, trainable, tp_kv)

    def param_axes(self):
        """The parameters' logical-axes tree, without allocating them (the
        tree made on the ``meta`` device), as nested dicts and lists in
        the layout of ``Transformer.tree()``."""
        return logical_axes(self._init(None).tree())

    def decode_state_axes(self):
        """The decode state's logical axes, a state of the same type
        (``host_length`` None: a host count)."""
        cfg = self.cfg
        kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
        if cfg.family == "ssm":
            return ssm.SSMState(
                state=("layers", "batch", "heads", "head_dim", "state"),
                conv=("layers", "batch", "conv", "mlp"), length=(),
                host_length=None)
        if cfg.family == "hybrid":
            return hybrid.HybridState(
                lru=("layers", "batch", "mlp"),
                conv=("layers", "batch", "conv", "mlp"), k=kv, v=kv,
                length=(), host_length=None)
        if cfg.family == "encdec":
            return encdec.EncDecCache(self_k=kv, self_v=kv, cross_k=kv,
                                      cross_v=kv, length=(),
                                      host_length=None)
        if self.cache_quant:
            q = ("layers", "batch", "kv_heads", "seq", "head_dim")
            return T.QuantKVCache(k=q, v=q, k_scale=q[:-1], v_scale=q[:-1],
                                  length=(), host_length=None)
        return T.KVCache(k=kv, v=kv, length=(), host_length=None)

    def cast(self, params: T.Transformer) -> T.Transformer:
        """The parameters in ``cfg.compute_dtype``, for serving.  The JAX
        package casts each weight at every use; casting once when serving
        starts gives the same numbers (the cast is deterministic) without
        reading the f32 copy at every step.  The parameters an SSM or
        recurrent layer reads in f32 (``ssm.F32_PARAMS``,
        ``hybrid.F32_PARAMS``) stay in f32."""
        keep = {"ssm": ssm.F32_PARAMS,
                "hybrid": hybrid.F32_PARAMS}.get(self.cfg.family, ())
        return params.cast(getattr(torch, self.cfg.compute_dtype), keep)

    # ---- training forward / loss -----------------------------------------
    def hidden(self, params, batch, *, chunk_q=1024, chunk_k=1024,
               attn_impl="xla", remat_policy="full", ssm_chunk=None,
               ssm_bf16=False):
        """Final hidden states (B, S, d), under autograd when it is on.
        Under a mesh the dense family runs on local blocks layer by layer
        (``models.runtime``); another family's parameters are all made
        local first, which only a mesh of one rank allows (the trainer
        refuses more)."""
        cfg = self.cfg
        if cfg.family != "dense":
            params = runtime.local_params(params)
        if cfg.family == "ssm":
            return ssm.forward(params, batch["tokens"], cfg, chunk=ssm_chunk,
                               bf16=ssm_bf16)
        if cfg.family == "hybrid":
            return hybrid.forward(params, batch["tokens"], cfg,
                                  chunk_q=chunk_q, chunk_k=chunk_k,
                                  attn_impl=attn_impl)
        if cfg.family == "encdec":
            return encdec.forward(params, batch["tokens"], batch["frames"],
                                  cfg, chunk_q=chunk_q, chunk_k=chunk_k,
                                  attn_impl=attn_impl)
        if cfg.family == "vlm":
            return vlm.forward(params, batch["tokens"], batch["patches"],
                               cfg, chunk_q=chunk_q, chunk_k=chunk_k,
                               attn_impl=attn_impl)
        return T.forward(params, batch["tokens"], self.cfg, chunk_q=chunk_q,
                         chunk_k=chunk_k, attn_impl=attn_impl,
                         remat_policy=remat_policy)

    def loss(self, params, batch, **fwd_kw):
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (-1 masked), a 0-d f32 tensor; a VLM's
        image positions carry no loss."""
        h = self.hidden(params, batch, **fwd_kw)
        if self.cfg.family == "vlm":
            h = h[:, self.cfg.vlm.num_patches:]
        nll, _ = chunked_cross_entropy(h, batch["labels"], self.cfg, params)
        return nll

    # ---- serving -----------------------------------------------------------
    def _serving_params(self, params):
        """The dense family reads its parameters layer by layer
        (``runtime.local_params`` in ``models.transformer``); another
        family's are made local whole (a mesh of one rank)."""
        if self.cfg.family == "dense":
            return params
        return runtime.local_params(params)

    def init_decode_state(self, batch: int, max_len: int,
                          dtype=torch.bfloat16, *, device=None):
        """An empty cache: int8 codes and scales with ``cache_quant``, else
        ``dtype``; on ``cuda`` unless the caller names another device.  An
        SSM or hybrid model's state (``max_len`` unused: it has no
        position limit), its conv tails and ring buffer in ``dtype``; an
        encoder-decoder's self and cross caches; a VLM's cache holds
        ``max_len`` positions after its image prefix."""
        device = resolve_device(device)
        cfg, tp, tp_kv = self.cfg, self.tp, self.tp_kv
        if cfg.family == "ssm":
            return ssm.init_state(cfg, batch, device, dtype)
        if cfg.family == "hybrid":
            return hybrid.init_state(cfg, batch, device, tp, dtype, tp_kv)
        if cfg.family == "encdec":
            return encdec.init_cache(cfg, batch, max_len, device, tp, dtype,
                                     tp_kv)
        if cfg.family == "vlm":
            max_len += cfg.vlm.num_patches
        if self.cache_quant:
            return T.init_quant_cache(cfg, batch, max_len, device, tp, tp_kv)
        return T.init_cache(cfg, batch, max_len, device, tp, dtype, tp_kv)

    def decode_step(self, params, state, token):
        """token (B, 1) -> (logits (B, padded vocab), state); the state's
        tensors, its device ``length`` included, are updated in place.
        Under a mesh (``models.runtime``) the dense family runs on local
        blocks layer by layer: ``token`` and the state are this rank's
        blocks, the logits its (B_local, V_local) block; another family's
        parameters are made local whole, as in :meth:`hidden`."""
        params = self._serving_params(params)
        with torch.no_grad():
            if self.cfg.family == "ssm":
                return ssm.decode_step(params, state, token, self.cfg)
            if self.cfg.family == "hybrid":
                return hybrid.decode_step(params, state, token, self.cfg)
            if self.cfg.family == "encdec":
                return encdec.decode_step(params, state, token, self.cfg)
            return T.decode_step(params, state, token, self.cfg)

    def prefill(self, params, batch, state, *, chunk_q=1024, chunk_k=1024,
                attn_impl="xla", ssm_chunk=None):
        """Prompt ``batch["tokens"]`` (B, S) into a float cache or an SSM
        or hybrid state -> (last-position logits, state); an
        encoder-decoder encodes ``batch["frames"]`` first, a VLM puts
        ``batch["patches"]`` in front of the prompt.  Under a mesh as
        :meth:`decode_step`."""
        cfg, tokens = self.cfg, batch["tokens"]
        params = self._serving_params(params)
        with torch.no_grad():
            if cfg.family == "ssm":
                return ssm.prefill(params, tokens, cfg, state,
                                   chunk=ssm_chunk)
            if cfg.family == "hybrid":
                return hybrid.prefill(params, tokens, cfg, state,
                                      chunk_q=chunk_q, chunk_k=chunk_k,
                                      attn_impl=attn_impl)
            if cfg.family == "encdec":
                return encdec.prefill(params, tokens, batch["frames"], cfg,
                                      state, chunk_q=chunk_q,
                                      chunk_k=chunk_k, attn_impl=attn_impl)
            if cfg.family == "vlm":
                return vlm.prefill(params, tokens, batch["patches"], cfg,
                                   state, chunk_q=chunk_q, chunk_k=chunk_k,
                                   attn_impl=attn_impl)
            return T.prefill(params, batch["tokens"], self.cfg, state,
                             chunk_q=chunk_q, chunk_k=chunk_k,
                             attn_impl=attn_impl)


def _chunk_nll(h, lab, head_w, tied):
    """Summed NLL and count of one chunk: logits (B, c, V) f32.  Under
    tensor parallelism the logits are this rank's vocab block: the
    maximum, the sum of exponentials and the picked logit are reduced
    over the ranks."""
    head = None if head_w is None else {"w": head_w}
    logits = L.lm_logits(head, h, tied_table=tied).float()
    start = runtime.tp_offset(logits.shape[-1])
    if start is None:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              lab.clamp(min=0).long()[..., None])[..., 0]
    else:
        m = runtime.tp_max(logits.amax(dim=-1))
        lse = m + torch.log(runtime.tp_sum(
            torch.exp(logits - m[..., None]).sum(dim=-1)))
        ids = lab.long() - start
        inside = (ids >= 0) & (ids < logits.shape[-1])
        local = torch.gather(logits, -1, ids.clamp(
            0, logits.shape[-1] - 1)[..., None])[..., 0]
        picked = runtime.tp_sum(torch.where(inside, local, 0.0))
    mask = lab >= 0
    nll = torch.where(mask, lse - picked, 0.0)
    return nll.sum(), mask.sum(dtype=torch.int32)


def chunked_cross_entropy(hidden, labels, cfg, params, *, chunk: int = 512):
    """Mean next-token CE without materialising the full logits.

    hidden: (B, S, d), position t predicts labels[t]; labels: (B, S) int,
    -1 masked.  Chunks of ``chunk`` positions (shrunk to divide S), each
    checkpointed when ``cfg.remat``, summed in order.  Returns (mean_nll,
    token count).  Under a mesh (``models.runtime``) ``hidden`` and
    ``labels`` are this rank's batch rows and the head its vocab block;
    the sum and the count are summed over the batch shards, so every rank
    returns the mean over the whole batch."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    hidden = runtime.tp_copy(hidden)
    tied = (runtime.local_params(params.embedding)["table"]
            if cfg.tie_embeddings else None)
    head_w = (runtime.local_params(params.head)["w"]
              if params.head is not None else None)
    body = _chunk_nll
    if cfg.remat and torch.is_grad_enabled():
        body = functools.partial(runtime.checkpoint, _chunk_nll)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c0 in range(0, S, chunk):
        nll, n = body(hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                      head_w, tied)
        tot = tot + nll
        cnt = cnt + n
    tot = runtime.batch_sum(tot)
    cnt = runtime.batch_sum(cnt)
    return tot / torch.clamp(cnt, min=1), cnt


def build(cfg: ModelConfig, tp: int = 1, **kw) -> Model:
    """The model of ``cfg``, its q heads padded to ``tp`` and its kv heads
    to ``tp_kv`` (``tp`` by default; the decode-opt layout of
    ``launch.cells`` shards the kv heads over fewer ranks than the q
    heads), ``cache_quant`` for the int8 cache."""
    return Model(cfg, tp, **kw)
