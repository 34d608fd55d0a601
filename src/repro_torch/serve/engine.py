"""Batched serving: prefill, then a decode loop with the distributed top-k
head (counterpart of ``repro.serve.engine``).

``make_serve_step`` builds the one-token step
``(params, state, token) -> (next_token, state)``: the model's decode step,
then the head.  Two layouts:

- a ``DeviceMesh`` (``launch/mesh.py``), one process a rank: the decode
  step runs under the mesh (``models.runtime``) on this rank's blocks of
  the parameters and the state, and the token is its batch rows.  The
  logits are its vocab block, and the head is the §3.2.3 merge across the
  ranks of the mesh's ``model*`` dims that the batch does not use
  (``serve.sampling``), or ``argmax`` where those dims hold one rank, as
  the reference's ``shard_map`` head.  The dense family runs on a mesh of
  any size, another family on a mesh of one rank;
- no mesh, one process: with ``shards > 1`` the logits row is cut into
  ``shards`` stacked vocab shards and the §3.2.3 merge runs among them;
  with ``shards == 1`` the head is ``argmax``.

``decode_loop`` is the counterpart of the reference's loop over
``jax.jit(make_serve_step(...))``: on a CUDA device it captures one step
in a ``torch.cuda.CUDAGraph`` and replays it, one launch from the host a
step instead of thousands.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ops
from repro_torch.models import runtime
from repro_torch.models import sharding as SH
from repro_torch.models.transformer import capacity
from repro_torch.serve.sampling import (_flat_index, distributed_topk_sample,
                                        topk_logits)


def _head_axes(mesh, rules) -> tuple:
    """The mesh dims the head merges over: the ``model*`` dims that the
    batch rule does not use (the reference's ``model_axes``), in mesh
    order, those of more than one rank only."""
    spec = SH.partition_spec(("batch",), mesh, rules)[0]
    used = (spec,) if isinstance(spec, str) else tuple(spec or ())
    sizes = SH.mesh_shape(mesh)
    return tuple(a for a in sizes if a.startswith("model") and a not in used
                 and sizes[a] > 1)


def check_mesh_family(model, mesh) -> None:
    """Serving under a mesh of more than one rank runs the dense family
    only; another family raises."""
    if model.cfg.family != "dense" and mesh.size() > 1:
        raise ValueError(
            f"serving under a mesh runs the dense family; "
            f"{model.cfg.family!r} over a mesh of {mesh.size()} ranks waits "
            f"for ROADMAP.md queue A, item 11.4")


def _mesh_head(model, mesh, rules, k, greedy, generator):
    """The head over a mesh: logits (B_local, V_local) -> (B_local,).
    The logits' vocab is split over the ``vocab`` rule's dims; where the
    head's dims go beyond them (a batch replicated over ``model_b``),
    each rank keeps its row-major share of its block, so the head's ids
    stay the global ones."""
    check_mesh_family(model, mesh)
    axes = _head_axes(mesh, rules)
    if not axes:
        return lambda logits: torch.argmax(logits, dim=-1)
    spec = SH.partition_spec(("vocab",), mesh, rules)[0]
    sizes = SH.mesh_shape(mesh)
    vocab = tuple(a for a in ((spec,) if isinstance(spec, str)
                              else tuple(spec or ())) if sizes[a] > 1)
    if axes[:len(vocab)] != vocab:
        raise ValueError(f"the head merges over {axes}, the logits' vocab "
                         f"is split over {vocab}: the vocab rule must name "
                         f"leading head dims")
    share, shares = _flat_index(mesh, axes[len(vocab):])

    def head(logits):
        if shares > 1:
            c = logits.shape[-1] // shares
            logits = logits[:, share * c:(share + 1) * c]
        if greedy:
            tok = topk_logits(logits, k, mesh=mesh, axes=axes)[1][:, 0]
        else:
            tok = distributed_topk_sample(logits, k, generator, mesh=mesh,
                                          axes=axes)
        return tok.long()

    return head


def make_head(model, *, shards: int = 1, k: int = 8, greedy: bool = True,
              generator: torch.Generator | None = None, mesh=None,
              rules=None):
    """The decode head, logits -> next token: over a ``mesh``
    (:func:`_mesh_head`), else over ``shards`` stacked vocab shards (a
    power of two dividing the padded vocab) of logits (B, V).  Greedy
    takes the top id; otherwise one categorical draw from the top-k values
    on ``generator`` (seeded alike on every rank of a mesh)."""
    if not greedy and generator is None:
        raise ValueError("sampling needs a torch.Generator")
    if mesh is not None:
        return _mesh_head(model, mesh, rules, k, greedy, generator)
    V = model.cfg.padded_vocab()
    if shards < 1 or shards & (shards - 1) or V % shards:
        raise ValueError(f"shards must be a power of two dividing the padded "
                         f"vocab {V}, got {shards}")

    def head(logits):
        if shards == 1:
            return torch.argmax(logits, dim=-1)
        B = logits.shape[0]
        local = logits.reshape(B, shards, V // shards).transpose(0, 1)
        if greedy:
            return topk_logits(local, k)[1][0, :, 0]
        return distributed_topk_sample(local, k, generator)

    return head


def _decode_fn(model, mesh, rules, head):
    """(params, state, token (B,)) -> (logits, next token, state): the
    model's decode step under the mesh (if any), then the head."""
    def run(params, state, tok):
        under = (contextlib.nullcontext() if mesh is None
                 else runtime.mesh_rules(mesh, rules))
        with under:
            logits, state = model.decode_step(params, state, tok[:, None])
        return logits, head(logits), state

    return run


def make_serve_step(model, mesh=None, *, k: int = 8, greedy: bool = True,
                    rules=None, generator: torch.Generator | None = None,
                    shards: int = 1):
    """One decode step with the distributed top-k head (:func:`make_head`).
    With a ``mesh``, ``rules`` (the reference's rules by default) must be
    those the parameters and the state were laid out by, the batch rule
    degraded for the global batch (``sharding.rules_for``); the step
    takes and returns this rank's batch rows, and the token comes back
    the same on every rank of the head's dims."""
    run = _decode_fn(model, mesh, rules, make_head(
        model, shards=shards, k=k, greedy=greedy, generator=generator,
        mesh=mesh, rules=rules))

    def serve_step(params, state, token):
        _, nxt, state = run(params, state, token)
        return nxt, state

    return serve_step


def decode_loop(model, params, state, first_token, steps: int, mesh=None, *,
                shards: int = 1, k: int = 8, greedy: bool = True,
                rules=None, generator: torch.Generator | None = None,
                forced: torch.Tensor | None = None,
                logits_out: list | None = None):
    """``steps`` serve steps (:func:`make_serve_step`) from ``first_token``
    (B,) -> (tokens (B, steps + 1): ``first_token``, then each step's
    choice; state).  Under a ``mesh`` the tokens, the state and the
    logits are this rank's blocks.

    Step i > 0 is fed the token step i - 1 chose or, given ``forced``
    (B, steps - 1), ``forced[:, i - 1]`` (teacher forcing: a prompt fed one
    token a step).  ``logits_out``, a list, receives each step's logits.

    On a CUDA device the first step runs eagerly on a side stream (the
    warm-up), the second is captured into a CUDA graph that reads a static
    token buffer and updates the state's tensors in place (the cache
    length included, which the kernels read on the device), and that
    graph is replayed for every later step; the kernels' launch counters
    (and ``ops.local_shard_counts``) add, for each replay, what the
    captured step ran.  A capture that fails raises.  On the CPU every
    step runs eagerly.  Under a mesh whose head dims hold one rank (one
    card) the step makes no collective call; across ranks it runs the
    head's point-to-point swaps inside the graph."""
    B = first_token.shape[0]
    if forced is not None and tuple(forced.shape) != (B, max(steps - 1, 0)):
        raise ValueError(f"forced must be ({B}, {max(steps - 1, 0)}), got "
                         f"{tuple(forced.shape)}")
    if state.host_length.n + steps > capacity(state):
        raise ValueError(f"{steps} steps from {state.host_length.n} positions "
                         f"overrun the cache's {capacity(state)}")
    run = _decode_fn(model, mesh, rules, make_head(
        model, shards=shards, k=k, greedy=greedy, generator=generator,
        mesh=mesh, rules=rules))
    toks = torch.empty((B, steps + 1), dtype=first_token.dtype,
                       device=first_token.device)
    toks[:, 0] = first_token
    if first_token.device.type != "cuda":
        for i in range(steps):
            tok = toks[:, i] if forced is None or i == 0 else forced[:, i - 1]
            logits, toks[:, i + 1], state = run(params, state, tok)
            if logits_out is not None:
                logits_out.append(logits)
        return toks, state
    if steps == 0:
        return toks, state

    # the warm-up: step 0, eagerly, on a side stream
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream(device=first_token.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        logits, toks[:, 1], state = run(params, state, first_token)
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
    before, local_before = ops.launch_counts(), ops.local_shard_counts()
    with torch.cuda.graph(graph):
        g_logits, g_next, _ = run(params, state, tok)
    # the captured step ran nothing: its host count comes off again, and
    # each replay puts it back
    state.host_length.n -= 1
    per_replay = {n: c - before[n] for n, c in ops.launch_counts().items()
                  if c != before[n]}
    local_per_replay = {n: c - local_before[n]
                        for n, c in ops.local_shard_counts().items()
                        if c != local_before[n]}
    ops.add_launch_counts({n: -c for n, c in per_replay.items()},
                          {n: -c for n, c in local_per_replay.items()})
    for i in range(1, steps):
        if i > 1:
            tok.copy_(g_next if forced is None else forced[:, i - 1])
        graph.replay()
        state.host_length.n += 1
        ops.add_launch_counts(per_replay, local_per_replay)
        toks[:, i + 1] = g_next
        if logits_out is not None:
            logits_out.append(g_logits.clone())
    return toks, state
