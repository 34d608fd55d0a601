"""The port's kernels on the CPU (their plain PyTorch versions) against the
JAX package's Pallas kernels run in interpret mode.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against the same plain versions there.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.kernels.grouped_agg import filtered_group_sum as jax_group_sum
from repro.kernels.scan_filter import scan_filter_pallas, scan_filter_xla
from repro_torch.core import compression as tc
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_agg import launch_shape


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("width", [1, 2, 4, 6, 12, 21, 30])
def test_scan_filter_bit_identical_to_pallas_and_xla(width, negate):
    rng = np.random.default_rng(width)
    nodes, rows = 2, 1000 + 7 * width     # ragged: not a multiple of 32
    padded = -(-rows // 32) * 32
    codes = rng.integers(0, 1 << width, size=(nodes, padded),
                         dtype=np.uint64).astype(np.uint32)
    codes[:, :4] = (1 << width) - 1       # top codes, bit 29 at w=30
    lo = int(rng.integers(0, 1 << width))
    hi = min(lo + (1 << width) // 3, (1 << width) - 1)
    words = tc.pack_bits(torch.from_numpy(codes.astype(np.int64)), width)
    got = ops.scan_filter(words, lo, hi, rows=rows, padded_rows=padded,
                          width=width, negate=negate)
    assert got.shape == (nodes, padded // 32)
    for p in range(nodes):
        jw = jnp.asarray(_u32(words[p]))
        kw = dict(rows=rows, padded_rows=padded, width=width, negate=negate)
        want = np.asarray(scan_filter_pallas(jw, lo, hi, interpret=True,
                                             **kw))
        np.testing.assert_array_equal(_u32(got[p]), want)
        np.testing.assert_array_equal(
            want, np.asarray(scan_filter_xla(jw, lo, hi, **kw)))
    assert ops.launch_counts()["scan_filter"] == 0


@pytest.mark.parametrize("num_groups,c", [(6, 6), (6, 64), (512, 6),
                                          (512, 64), (1, 1), (8, 8),
                                          (9, 7), (65, 1)])
def test_filtered_group_sum_matches_pallas(num_groups, c):
    rng = np.random.default_rng(num_groups + c)
    nodes, n, cutoff = 2, 3001, 500
    measures = rng.random((nodes, n, c), dtype=np.float32)
    groups = rng.integers(0, num_groups, (nodes, n)).astype(np.int32)
    pred = rng.integers(0, 2 * cutoff, (nodes, n)).astype(np.int32)
    got = ops.filtered_group_sum(
        torch.from_numpy(measures), torch.from_numpy(groups),
        torch.from_numpy(pred), cutoff=cutoff, num_groups=num_groups)
    assert got.shape == (nodes, num_groups, c) and got.dtype == torch.float32
    for p in range(nodes):
        want = np.asarray(jax_group_sum(
            jnp.asarray(measures[p]), jnp.asarray(groups[p]),
            jnp.asarray(pred[p]), cutoff, num_groups, interpret=True))
        # f32 sums in another order than the Pallas grid's
        np.testing.assert_allclose(got[p].numpy(), want, rtol=1e-5)
    assert ops.launch_counts()["filtered_group_sum"] == 0


@pytest.mark.parametrize("num_groups,c,want", [
    (6, 6, True), (1, 1, True), (8, 8, True), (64, 1, True), (9, 7, True),
    (1, 8, True), (65, 1, False), (1, 9, False), (8, 9, False),
    (7, 9, False), (64, 64, False), (512, 6, False)])
def test_group_sum_variant_choice(num_groups, c, want):
    """The register variant takes C <= 8 and G * C <= 64 (Q1: 6 x 6); the
    shared-slab variant the rest.  The choice is a function of (G, C)
    alone, so it is the same on every input of a plan."""
    from repro_torch.kernels.grouped_agg import uses_registers

    assert uses_registers(num_groups, c) is want


@pytest.mark.parametrize("num_groups,c", [(6, 6), (512, 64), (1, 1)])
def test_group_sum_launch_shape_fits_the_card(num_groups, c):
    slabs, chunk, nblocks, smem = launch_shape(7_500_000, num_groups, c)
    assert 1 <= slabs * c <= 256                  # threads per block
    assert smem <= 227 * 1024                     # H100 shared memory
    assert slabs == 1 or smem <= 48 * 1024        # opt-in only when needed
    assert chunk == slabs * 256 and nblocks * chunk >= 7_500_000


def test_cuda_wrappers_reject_cpu_tensors():
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import (
        flash_attention_fwd_cuda, flash_attention_fwd_tc_cuda)
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_cuda, flash_attention_bwd_tc_cuda)
    from repro_torch.kernels.grouped_agg import filtered_group_sum_cuda
    from repro_torch.kernels.scan_filter import scan_filter_cuda

    with pytest.raises(ValueError, match="CUDA"):
        scan_filter_cuda(torch.zeros((1, 12), dtype=torch.int32), 0, 1,
                         rows=32, padded_rows=32, width=12)
    with pytest.raises(ValueError, match="CUDA"):
        filtered_group_sum_cuda(torch.zeros((1, 4, 2)),
                                torch.zeros((1, 4), dtype=torch.int32),
                                torch.zeros((1, 4), dtype=torch.int32),
                                cutoff=0, num_groups=2)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd_cuda(torch.zeros((1, 2, 8, 16)),
                                 torch.zeros((1, 8, 16)),
                                 torch.zeros((1, 8, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(torch.zeros((1, 2, 8, 16)),
                                 torch.zeros((1, 8, 16)),
                                 torch.zeros((1, 8, 16)),
                                 torch.zeros((1, 2, 8, 16)),
                                 torch.zeros((1, 2, 8)),
                                 torch.zeros((1, 2, 8, 16)))
    bf = dict(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd_tc_cuda(torch.zeros((1, 2, 8, 64), **bf),
                                    torch.zeros((1, 8, 64), **bf),
                                    torch.zeros((1, 8, 64), **bf))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_tc_cuda(torch.zeros((1, 2, 8, 64), **bf),
                                    torch.zeros((1, 8, 64), **bf),
                                    torch.zeros((1, 8, 64), **bf),
                                    torch.zeros((1, 2, 8, 64), **bf),
                                    torch.zeros((1, 2, 8)),
                                    torch.zeros((1, 2, 8, 64), **bf))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(torch.zeros((1, 2, 16)),
                              torch.zeros((1, 8, 16)),
                              torch.zeros((1, 8, 16)), 4)
    assert ops.launch_counts() == {
        k: 0 for k in ("scan_filter", "filtered_group_sum", "ef_encode",
                       "ef_decode", "mask_fold", "mask_unfold",
                       "flash_attention_fwd", "flash_attention_fwd_tc",
                       "flash_attention_bwd", "flash_attention_bwd_tc",
                       "decode_attention", "block_topk", "predicate_bitset",
                       "mbit_encode")}


def test_use_kernels_false_keeps_the_plain_version():
    words = tc.pack_bits(torch.arange(64).reshape(1, 64) % 16, 4)
    want = ops.scan_filter(words, 3, 9, rows=60, padded_rows=64, width=4)
    ops.use_kernels(False)
    try:
        got = ops.scan_filter(words, 3, 9, rows=60, padded_rows=64, width=4)
    finally:
        ops.use_kernels(True)
    assert torch.equal(got, want)
    bits = tc.unpack_bitset(got, 64)[0].numpy()
    codes = np.arange(64) % 16
    np.testing.assert_array_equal(
        bits, (codes >= 3) & (codes <= 9) & (np.arange(64) < 60))
    np.testing.assert_array_equal(
        _u32(got[0]),
        np.asarray(jc.pack_bitset(jnp.asarray(bits))))


@pytest.mark.parametrize("fn", ["group_sum_onehot", "group_count",
                                "group_sum_dense"])
def test_aggregation_matches_jax(fn):
    from repro.core import aggregation as jagg
    from repro_torch.core import aggregation as tagg

    rng = np.random.default_rng(len(fn))
    nodes, n, groups = 2, 1001, 7
    vals = rng.random((nodes, n), dtype=np.float32)
    ids = rng.integers(0, groups, (nodes, n)).astype(np.int32)
    mask = rng.random((nodes, n)) < 0.6
    args = {"group_sum_onehot": (vals, ids, groups, mask),
            "group_count": (ids, groups, mask),
            "group_sum_dense": (vals, ids, groups, mask)}[fn]
    got = getattr(tagg, fn)(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                              else a for a in args])
    for p in range(nodes):
        want = getattr(jagg, fn)(*[jnp.asarray(a[p])
                                   if isinstance(a, np.ndarray) else a
                                   for a in args])
        np.testing.assert_allclose(got[p].numpy(), np.asarray(want),
                                   rtol=1e-5)
