"""Batched serving: prefill, then a decode loop with the distributed top-k
head (counterpart of ``repro.serve.engine``).

``make_serve_step`` builds the one-token step
``(params, state, token) -> (next_token, state)``: the model's decode step,
then the head.  With ``shards > 1`` the logits row is cut into ``shards``
stacked vocab shards and the §3.2.3 top-k merge picks the token
(``serve.sampling``); with ``shards == 1`` the head is ``argmax``, as in
the JAX package when the mesh has no model axis.
"""
from __future__ import annotations

import torch

from repro_torch.serve.sampling import distributed_topk_sample, topk_logits


def make_serve_step(model, *, shards: int, k: int = 8, greedy: bool = True,
                    generator: torch.Generator | None = None):
    """One decode step with the distributed top-k head over ``shards``
    vocab shards (a power of two dividing the padded vocab).  Greedy takes
    the top id; otherwise one categorical draw from the top-k values on
    ``generator``."""
    V = model.cfg.padded_vocab()
    if shards < 1 or shards & (shards - 1) or V % shards:
        raise ValueError(f"shards must be a power of two dividing the padded "
                         f"vocab {V}, got {shards}")
    if not greedy and generator is None:
        raise ValueError("sampling needs a torch.Generator")

    def serve_step(params, state, token):
        logits, state = model.decode_step(params, state, token[:, None])
        if shards == 1:
            return torch.argmax(logits, dim=-1), state
        B = logits.shape[0]
        local = logits.reshape(B, shards, V // shards).transpose(0, 1)
        if greedy:
            return topk_logits(local, k)[1][0, :, 0], state
        return distributed_topk_sample(local, k, generator), state

    return serve_step


def decode_loop(model, params, state, first_token, steps: int, *,
                shards: int, k: int = 8, greedy: bool = True,
                generator: torch.Generator | None = None):
    """Host-driven decode loop: ``steps`` serve steps from ``first_token``
    (B,) -> (tokens (B, steps + 1), state)."""
    step_fn = make_serve_step(model, shards=shards, k=k, greedy=greedy,
                              generator=generator)
    toks = [first_token]
    for _ in range(steps):
        nxt, state = step_fn(params, state, toks[-1])
        toks.append(nxt)
    return torch.stack(toks, dim=1), state
