"""Bit packing and packed bitsets of the port, bit-identical to
``repro.core.compression`` at every width 0..32 (the edge set {0, 1, 31,
32} included) and on values with bit 31 set."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro_torch.core import compression as tc


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


def _values(width: int, n: int, seed: int) -> np.ndarray:
    if width == 0:
        return np.zeros(n, np.uint32)
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint64)
    vals[:3] = (1 << width) - 1           # all-ones codes (bit 31 at w=32)
    return vals.astype(np.uint32)


@pytest.mark.parametrize("width", range(33))
def test_pack_unpack_gather_bit_identical(width):
    n = 997  # odd: the last word is partial and straddles are exercised
    vals = _values(width, n, seed=width)
    want = np.asarray(jc.pack_bits(jnp.asarray(vals), width))
    got = tc.pack_bits(torch.from_numpy(vals.astype(np.int64)), width)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)

    np.testing.assert_array_equal(
        _u32(tc.unpack_bits(got, n, width)),
        np.asarray(jc.unpack_bits(jnp.asarray(want), n, width)))
    idx = np.random.default_rng(width + 100).integers(0, n, 64)
    np.testing.assert_array_equal(
        _u32(tc.gather_bits(got, torch.from_numpy(idx), width)),
        np.asarray(jc.gather_bits(jnp.asarray(want),
                                  jnp.asarray(idx, jnp.uint32), width)))


@pytest.mark.parametrize("width", [0, 1, 12, 31, 32])
def test_pack_bits_node_stacked_rows_are_independent(width):
    vals = np.stack([_values(width, 320, seed=s) for s in range(3)])
    got = tc.pack_bits(torch.from_numpy(vals.astype(np.int64)), width)
    assert got.shape == (3, tc.packed_words(320, width))
    for p in range(3):
        np.testing.assert_array_equal(
            _u32(got[p]), np.asarray(jc.pack_bits(jnp.asarray(vals[p]),
                                                  width)))
    np.testing.assert_array_equal(
        _u32(tc.unpack_bits(got, 320, width)), vals)


@pytest.mark.parametrize("n", [32, 96, 4096])
def test_bitsets_bit_identical(n):
    rng = np.random.default_rng(n)
    bits = rng.random(n) < 0.5
    bits[31] = True                        # bit 31 of the first word
    want = np.asarray(jc.pack_bitset(jnp.asarray(bits)))
    got = tc.pack_bitset(torch.from_numpy(bits))
    np.testing.assert_array_equal(_u32(got), want)
    m = n - 5
    np.testing.assert_array_equal(
        tc.unpack_bitset(got, m).numpy(),
        np.asarray(jc.unpack_bitset(jnp.asarray(want), m)))
    idx = rng.integers(0, n, 50)
    np.testing.assert_array_equal(
        tc.probe_bitset(got, torch.from_numpy(idx)).numpy(),
        np.asarray(jc.probe_bitset(jnp.asarray(want),
                                   jnp.asarray(idx, jnp.int32))))


@pytest.mark.parametrize("n,width", [(0, 5), (1, 0), (100, 7), (2 ** 20, 30)])
def test_host_helpers_agree(n, width):
    assert tc.packed_words(n, width) == jc.packed_words(n, width)
    assert tc.bitset_words(n) == jc.bitset_words(n)
    assert tc.required_width(n) == jc.required_width(n)
