"""Batched serving: prefill, then a decode loop with the distributed top-k
head (counterpart of ``repro.serve.engine``).

``make_serve_step`` builds the one-token step
``(params, state, token) -> (next_token, state)``: the model's decode step,
then the head.  With ``shards > 1`` the logits row is cut into ``shards``
stacked vocab shards and the §3.2.3 top-k merge picks the token
(``serve.sampling``); with ``shards == 1`` the head is ``argmax``, as in
the JAX package when the mesh has no model axis.

``decode_loop`` is the counterpart of the reference's loop over
``jax.jit(make_serve_step(...))``: on a CUDA device it captures one step
in a ``torch.cuda.CUDAGraph`` and replays it, one launch from the host a
step instead of thousands.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.transformer import capacity
from repro_torch.serve.sampling import distributed_topk_sample, topk_logits


def make_head(model, *, shards: int, k: int = 8, greedy: bool = True,
              generator: torch.Generator | None = None):
    """The decode head, logits (B, V) -> next token (B,), over ``shards``
    stacked vocab shards (a power of two dividing the padded vocab).
    Greedy takes the top id; otherwise one categorical draw from the top-k
    values on ``generator``."""
    V = model.cfg.padded_vocab()
    if shards < 1 or shards & (shards - 1) or V % shards:
        raise ValueError(f"shards must be a power of two dividing the padded "
                         f"vocab {V}, got {shards}")
    if not greedy and generator is None:
        raise ValueError("sampling needs a torch.Generator")

    def head(logits):
        if shards == 1:
            return torch.argmax(logits, dim=-1)
        B = logits.shape[0]
        local = logits.reshape(B, shards, V // shards).transpose(0, 1)
        if greedy:
            return topk_logits(local, k)[1][0, :, 0]
        return distributed_topk_sample(local, k, generator)

    return head


def make_serve_step(model, *, shards: int, k: int = 8, greedy: bool = True,
                    generator: torch.Generator | None = None):
    """One decode step with the distributed top-k head (:func:`make_head`)."""
    head = make_head(model, shards=shards, k=k, greedy=greedy,
                     generator=generator)

    def serve_step(params, state, token):
        logits, state = model.decode_step(params, state, token[:, None])
        return head(logits), state

    return serve_step


def decode_loop(model, params, state, first_token, steps: int, *,
                shards: int, k: int = 8, greedy: bool = True,
                generator: torch.Generator | None = None,
                forced: torch.Tensor | None = None,
                logits_out: list | None = None):
    """``steps`` serve steps from ``first_token`` (B,) -> (tokens
    (B, steps + 1): ``first_token``, then each step's choice; state).

    Step i > 0 is fed the token step i - 1 chose or, given ``forced``
    (B, steps - 1), ``forced[:, i - 1]`` (teacher forcing: a prompt fed one
    token a step).  ``logits_out``, a list, receives each step's logits.

    On a CUDA device the first step runs eagerly on a side stream (the
    warm-up), the second is captured into a CUDA graph that reads a static
    token buffer and updates the state's tensors in place (the cache
    length included, which the kernels read on the device), and that
    graph is replayed for every later step; the kernels' launch counters
    add, for each replay, what the captured step launched.  A capture that
    fails raises.  On the CPU every step runs eagerly."""
    B = first_token.shape[0]
    if forced is not None and tuple(forced.shape) != (B, max(steps - 1, 0)):
        raise ValueError(f"forced must be ({B}, {max(steps - 1, 0)}), got "
                         f"{tuple(forced.shape)}")
    if state.host_length.n + steps > capacity(state):
        raise ValueError(f"{steps} steps from {state.host_length.n} positions "
                         f"overrun the cache's {capacity(state)}")
    head = make_head(model, shards=shards, k=k, greedy=greedy,
                     generator=generator)
    toks = torch.empty((B, steps + 1), dtype=first_token.dtype,
                       device=first_token.device)
    toks[:, 0] = first_token
    if first_token.device.type != "cuda":
        for i in range(steps):
            tok = toks[:, i] if forced is None or i == 0 else forced[:, i - 1]
            logits, state = model.decode_step(params, state, tok[:, None])
            if logits_out is not None:
                logits_out.append(logits)
            toks[:, i + 1] = head(logits)
        return toks, state
    if steps == 0:
        return toks, state

    # the warm-up: step 0, eagerly, on a side stream
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream(device=first_token.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        logits, state = model.decode_step(params, state, first_token[:, None])
        toks[:, 1] = head(logits)
        if logits_out is not None:
            logits_out.append(logits)
    main.wait_stream(side)
    if steps == 1:
        return toks, state

    # one step captured, reading `tok` (a buffer of its own: the caller's
    # tensors are never written) and writing the state in place
    tok = torch.empty((B,), dtype=toks.dtype, device=toks.device)
    tok.copy_(toks[:, 1] if forced is None else forced[:, 0])
    graph = torch.cuda.CUDAGraph()
    if not greedy:
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError("this torch cannot register a generator with "
                               "a CUDA graph: a sampled decode cannot be "
                               "captured")
        graph.register_generator_state(generator)
    before = ops.launch_counts()
    with torch.cuda.graph(graph):
        g_logits, _ = model.decode_step(params, state, tok[:, None])
        g_next = head(g_logits)
    # the captured step ran nothing: its host count comes off again, and
    # each replay puts it back
    state.host_length.n -= 1
    per_replay = {n: c - before[n] for n, c in ops.launch_counts().items()
                  if c != before[n]}
    ops.add_launch_counts({n: -c for n, c in per_replay.items()})
    for i in range(1, steps):
        if i > 1:
            tok.copy_(g_next if forced is None else forced[:, i - 1])
        graph.replay()
        state.host_length.n += 1
        ops.add_launch_counts(per_replay)
        toks[:, i + 1] = g_next
        if logits_out is not None:
            logits_out.append(g_logits.clone())
    return toks, state
