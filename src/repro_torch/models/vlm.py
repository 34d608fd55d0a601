"""PaliGemma-3B backbone: a gemma decoder with a bidirectional image prefix
(counterpart of ``repro.models.vlm``).

The SigLIP vision tower is a stub, as in the JAX package: the input holds
precomputed patch embeddings (B, num_patches, patch_dim); this module owns
the projection into d_model (``patch_proj``) and the prefix-LM attention
pattern: every query sees the image positions, the text is causal.  The
decoder is ``models.transformer`` with the patches in front of the tokens
(its ``embeddings=``); the decode cache holds the image prefix too, so a
decode step is the transformer's.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import param


def init_vlm(cfg, gen: torch.Generator, tp: int = 1,
             trainable: bool = False, tp_kv: int | None = None
             ) -> T.Transformer:
    """The decoder's random parameters and ``patch_proj`` (``w``
    (patch_dim, d_model), ``b`` zeros) in ``cfg.param_dtype`` on ``gen``'s
    device."""
    dtype = getattr(torch, cfg.param_dtype)
    tree = T.transformer_tree(cfg, gen, tp, tp_kv)
    tree["patch_proj"] = {
        "w": param((cfg.vlm.patch_dim, cfg.d_model), gen, axes=(None, "embed"),
                   dtype=dtype),
        "b": param((cfg.d_model,), gen, axes=("embed_no_fsdp",),
                   init="zeros", dtype=dtype)}
    return T.Transformer(tree, trainable)


def project_patches(params: T.Transformer, patches, cfg):
    """(B, num_patches, patch_dim) -> (B, num_patches, d_model) in the
    compute dtype."""
    cd = getattr(torch, cfg.compute_dtype)
    pp = params.patch_proj
    return L._proj(patches.to(cd), pp["w"]) + pp["b"].to(cd)


def forward(params: T.Transformer, tokens, patches, cfg, *, chunk_q=1024,
            chunk_k=1024, attn_impl="xla"):
    """Prefix-LM forward over [image positions ; text tokens] -> final
    hidden states (B, num_patches + S, d)."""
    emb = project_patches(params, patches, cfg)
    cq = L.fit_chunk(emb.shape[1] + tokens.shape[1], chunk_q)
    mask = L.AttnMask(causal=True, prefix=cfg.vlm.num_patches)
    return T.forward(params, tokens, cfg, embeddings=emb, mask=mask,
                     chunk_q=cq, chunk_k=cq, attn_impl=attn_impl)


def prefill(params: T.Transformer, tokens, patches, cfg, cache, *,
            chunk_q=1024, chunk_k=1024, attn_impl="xla"):
    """The image positions and the prompt into the float cache ->
    (last-position logits, the cache, its length num_patches + S)."""
    emb = project_patches(params, patches, cfg)
    cq = L.fit_chunk(emb.shape[1] + tokens.shape[1], chunk_q)
    return T.prefill(params, tokens, cfg, cache, embeddings=emb,
                     chunk_q=cq, chunk_k=cq, attn_impl=attn_impl)
