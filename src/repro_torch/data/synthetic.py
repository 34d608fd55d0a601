"""Deterministic sharded data pipeline (counterpart of
``repro.data.synthetic``).

Shard i of step t is a pure function of (seed, t, i): any node can
regenerate any shard.  :meth:`SyntheticLM.host_batch` is the JAX package's
numpy code and gives the same tokens bit for bit.  :meth:`device_batch`
draws its uniforms on the device from a ``torch.Generator`` seeded from
(seed, step), so its tokens differ from JAX's ``jax.random`` ones; the
truncated-zipf transform that turns uniforms into tokens is
:func:`zipf_tokens`, the same arithmetic as JAX's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def zipf_tokens(u: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Truncated zipf by inverse cdf of uniforms ``u`` in [1e-6, 1):
    ``int32(exp(-log u * 0.35) - 1)`` clipped to [0, vocab_size - 1]."""
    z = (torch.exp(-torch.log(u) * 0.35) - 1.0).to(torch.int32)
    return torch.clamp(z, 0, vocab_size - 1)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_topics: int = 64

    def host_batch(self, step: int, shard: int = 0, num_shards: int = 1):
        """Numpy batch for shard `shard` of `num_shards` (host-side)."""
        b = self.global_batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard])
        )
        # zipf-ish unigram over vocab, shifted per topic
        topics = rng.integers(0, self.num_topics, b)
        ranks = np.arange(1, self.vocab_size + 1)
        base = 1.0 / ranks
        base /= base.sum()
        tokens = np.empty((b, self.seq_len + 1), np.int32)
        for i in range(b):
            shift = (topics[i] * 97) % self.vocab_size
            p = np.roll(base, shift)
            tokens[i] = rng.choice(self.vocab_size, self.seq_len + 1, p=p)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def device_batch(self, step: int, *, device):
        """Fast on-device batch with the same (seed, step) determinism:
        uniforms in [1e-6, 1) from a generator on ``device`` seeded from
        (seed, step), through :func:`zipf_tokens` (no host loop)."""
        seed = int(np.random.SeedSequence([self.seed, step])
                   .generate_state(1, np.uint64)[0] >> 1)
        gen = torch.Generator(device).manual_seed(seed)
        shape = (self.global_batch, self.seq_len + 1)
        u = torch.rand(shape, generator=gen, device=device)
        u = 1e-6 + (1.0 - 1e-6) * u
        z = zipf_tokens(u, self.vocab_size)
        return {"tokens": z[:, :-1], "labels": z[:, 1:]}
