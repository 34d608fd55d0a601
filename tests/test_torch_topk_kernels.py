"""Kernels B4-B6 of the port (block top-k, predicate bitset, m-bit
encoder): their plain versions on the CPU against the JAX package's Pallas
kernels in interpret mode and its ``kernels.ref``, and the rewrites that
put them on the hand plans' path.

Words are int32 and must equal the JAX uint32 words bit for bit; top-k
values and keys must be identical, ties included.  The CUDA kernels run
only on the card, where ``chip_smoke.py`` holds them against these plain
versions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.core import topk_approx as jta
from repro.kernels import bitset_pack as jbp
from repro.kernels import mbit_codec as jmc
from repro.kernels import ref as jref
from repro.kernels import topk_select as jts
from repro_torch.core import compression as tc
from repro_torch.core import topk
from repro_torch.core import topk_approx as tta
from repro_torch.kernels import mbit_codec as mbc
from repro_torch.kernels import ops


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


# ---------------------------------------------------------------------------
# B4: block top-k
# ---------------------------------------------------------------------------


def test_block_topk_exhausted_block_repeats_row_zero():
    """Values 0..7, keys 100..107, only row 2 unmasked, k = 3: the JAX
    kernel and ref give [2, -inf, -inf] and keys [102, 100, 100]."""
    v = np.arange(8, dtype=np.float32)
    k = np.arange(100, 108, dtype=np.int32)
    m = np.zeros(8, bool)
    m[2] = True
    got_v, got_k = ops.block_topk(torch.from_numpy(v), torch.from_numpy(k),
                                  k=3, mask=torch.from_numpy(m), block=8)
    for fn in (lambda: jts.block_topk(jnp.asarray(v), jnp.asarray(k), 3,
                                      jnp.asarray(m), block=8,
                                      interpret=True),
               lambda: jref.block_topk(jnp.asarray(v), jnp.asarray(k), 3,
                                       jnp.asarray(m), 8)):
        want_v, want_k = (np.asarray(a) for a in fn())
        np.testing.assert_array_equal(got_v.numpy(), want_v)
        np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_v.numpy(), [[2, -np.inf, -np.inf]])
    np.testing.assert_array_equal(got_k.numpy(), [[102, 100, 100]])


@pytest.mark.parametrize("n,k,block,masked", [
    (256, 1, 64, False), (200, 5, 64, True), (130, 16, 32, True),
    (64, 64, 64, False), (100, 40, 32, True)])
def test_block_topk_bit_identical_to_jax(n, k, block, masked):
    """Ragged N (a padded last block), ties (integer-valued floats),
    masked rows, blocks with fewer unmasked rows than k."""
    rng = np.random.default_rng(n * 131 + k)
    v = rng.integers(0, 12, n).astype(np.float32)
    keys = (np.arange(n) * 3 + 7).astype(np.int32)
    m = rng.random(n) < 0.3 if masked else None
    got = ops.block_topk(torch.from_numpy(v), torch.from_numpy(keys), k=k,
                         mask=None if m is None else torch.from_numpy(m),
                         block=block)
    jm = None if m is None else jnp.asarray(m)
    for want in (jts.block_topk(jnp.asarray(v), jnp.asarray(keys), k, jm,
                                block=block, interpret=True),
                 jref.block_topk(jnp.asarray(v), jnp.asarray(keys), k, jm,
                                 block)):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _adversarial(kind: str, n: int, rng) -> np.ndarray:
    """Values that stress the selection's ties and its key order."""
    if kind == "ties_at_k":       # a few 9s, then ties at the k-th value
        v = np.where(rng.random(n) < 0.1, 9.0, 5.0)
        v[rng.random(n) < 0.2] = 3.0
    elif kind == "all_equal":
        v = np.full(n, 7.0)
    elif kind == "signed_zeros":  # -0.0 and +0.0 tie: index order decides
        v = rng.choice([-0.0, 0.0, 0.0, -0.0, -1.5, 2.5], n)
    elif kind == "infinities":    # -inf values are not finite ones
        v = rng.choice([np.inf, -np.inf, 1.0, -2.0, 0.0], n,
                       p=[0.1, 0.4, 0.2, 0.2, 0.1])
    else:                         # "exhausted": few finite values a block
        v = rng.integers(-5, 5, n).astype(np.float64)
    return v.astype(np.float32)


@pytest.mark.parametrize("kind,n,k,block,masked", [
    ("ties_at_k", 300, 10, 64, False), ("ties_at_k", 300, 40, 64, True),
    ("all_equal", 100, 5, 32, False), ("all_equal", 100, 32, 32, True),
    ("signed_zeros", 200, 8, 64, False), ("signed_zeros", 200, 16, 32, True),
    ("infinities", 150, 12, 32, False), ("infinities", 150, 32, 32, True),
    ("exhausted", 256, 20, 64, True)])
def test_block_topk_adversarial_blocks_match_jax(kind, n, k, block, masked):
    """Heavy ties at the k-th value, all-equal blocks, mixed -0.0 and
    +0.0, +-inf, k = block (a ragged last block of pads) and masked blocks
    that run out of finite values: keys identical to the Pallas kernel's
    and ref's, values equal (-0.0 == +0.0).  Subnormals stay out: XLA on
    the CPU flushes them; the card compares them (chip_smoke phase 6b)."""
    rng = np.random.default_rng(len(kind) * 1000 + n + k)
    v = _adversarial(kind, n, rng)
    keys = (np.arange(n) * 7 + 1).astype(np.int32)
    m = (rng.random(n) < (0.05 if kind == "exhausted" else 0.5)
         if masked else None)
    got = ops.block_topk(torch.from_numpy(v), torch.from_numpy(keys), k=k,
                         mask=None if m is None else torch.from_numpy(m),
                         block=block)
    jm = None if m is None else jnp.asarray(m)
    for want in (jts.block_topk(jnp.asarray(v), jnp.asarray(keys), k, jm,
                                block=block, interpret=True),
                 jref.block_topk(jnp.asarray(v), jnp.asarray(keys), k, jm,
                                 block)):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if kind in ("infinities", "exhausted") and masked:
        # past a block's finite values: -inf with the key of element 0
        first = keys[::block][:got[1].shape[0]]
        tail = torch.isneginf(got[0])
        assert tail.any()
        assert torch.equal(got[1][tail],
                           torch.from_numpy(first)[:, None].expand_as(
                               got[1])[tail])


def test_block_topk_rows_are_independent():
    """Node-stacked (L, N): each row equals the 1-D result of that row."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal((3, 90)).astype(np.float32))
    keys = torch.arange(270, dtype=torch.int32).reshape(3, 90)
    mask = torch.from_numpy(rng.random((3, 90)) < 0.5)
    out_v, out_k = ops.block_topk(v, keys, k=4, mask=mask, block=32)
    assert out_v.shape == (3, 3, 4) and out_k.dtype == torch.int32
    for r in range(3):
        rv, rk = ops.block_topk(v[r], keys[r], k=4, mask=mask[r], block=32)
        assert torch.equal(out_v[r], rv) and torch.equal(out_k[r], rk)


@pytest.mark.parametrize("n,k,block", [(32, 1, 4096), (1000, 1, 64),
                                       (1000, 7, 64), (777, 100, 128),
                                       (12500, 10, 4096), (50, 16, 16)])
def test_block_topk_then_rank_equals_local_topk(n, k, block):
    """The hand plans' rewrite: on unmasked finite values whose keys ascend
    with the row, B4 + a rank of its candidates is ``local_topk``, bit for
    bit (ties included: integer values)."""
    rng = np.random.default_rng(n + k)
    values = torch.from_numpy(rng.integers(0, 50, (4, n)).astype(np.float32))
    keys = tta.owner_keys(4, n, "cpu")
    got = tta.local_topk_blocks(values, keys, k, block=block)
    want = topk.local_topk(values, keys, k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---------------------------------------------------------------------------
# B5: predicate bitset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,value", [(1, 3), (31, 3), (32, 3), (100, 3),
                                     (257, 3), (300, -1), (300, 7)])
def test_predicate_bitset_bit_identical_to_jax(n, value):
    """Ragged N, a value absent (-1) and one present in every row (7)."""
    rng = np.random.default_rng(n)
    col = (np.full(n, 7, np.int32) if value == 7
           else rng.integers(0, 5, n).astype(np.int32))
    got = ops.predicate_bitset(torch.from_numpy(col), value=value)
    assert got.dtype == torch.int32 and got.shape == ((n + 31) // 32,)
    jcol = jnp.asarray(col)
    for want in (jbp.predicate_bitset(jcol, value, block=64, interpret=True),
                 jref.predicate_bitset(jcol, value)):
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("shape", [(3, 70), (2, 3, 37), (4, 64)])
def test_predicate_bitset_nd_rows_bit_identical_to_jax(shape):
    """2-D and 3-D columns, N % 4 != 0 and == 0 (the CUDA kernel's scalar
    and 16-byte variants): every row packed from bit 0, the words of the
    JAX kernel (the first row) and of its ref (every row)."""
    rng = np.random.default_rng(sum(shape))
    col = rng.integers(0, 3, shape).astype(np.int32)
    got = ops.predicate_bitset(torch.from_numpy(col), value=1)
    assert got.shape == shape[:-1] + ((shape[-1] + 31) // 32,)
    rows = col.reshape(-1, shape[-1])
    words = got.reshape(len(rows), -1)
    for r, row in enumerate(rows):
        np.testing.assert_array_equal(
            _u32(words[r]), np.asarray(jref.predicate_bitset(
                jnp.asarray(row), 1)))
    np.testing.assert_array_equal(_u32(words[0]), np.asarray(
        jbp.predicate_bitset(jnp.asarray(rows[0]), 1, block=64,
                             interpret=True)))


def test_predicate_bitset_vector_loads():
    """The 16-byte variant's condition: N % 4 == 0 and the column on 16
    bytes; a copy 4 bytes past them takes the scalar one.  The plain
    version gives both the same words."""
    from repro_torch.kernels import bitset_pack

    col = torch.from_numpy(np.random.default_rng(2).integers(
        0, 3, (8, 64)).astype(np.int32))
    mis = torch.empty(col.numel() + 1, dtype=torch.int32)[1:].view(8, 64)
    mis.copy_(col)
    assert col.data_ptr() % 16 == 0 and mis.data_ptr() % 16 == 4
    assert bitset_pack.vector_loads(64, col.data_ptr())
    assert not bitset_pack.vector_loads(64, mis.data_ptr())
    assert not bitset_pack.vector_loads(63, col.data_ptr())
    assert torch.equal(ops.predicate_bitset(mis, value=1),
                       ops.predicate_bitset(col, value=1))


def test_predicate_bitset_rows_match_alt2_bitset():
    """Node-stacked (L, n) columns, each row packed from bit 0: the words
    of ``semijoin.alt2_bitset`` per node, bit 31 set included."""
    from repro_torch.core import exchange, semijoin

    rng = np.random.default_rng(1)
    col = torch.from_numpy(rng.integers(0, 3, (8, 70)).astype(np.int32))
    words = ops.predicate_bitset(col, value=1)
    assert torch.equal(exchange.allgather(words),
                       semijoin.alt2_bitset(col == 1))
    for r in range(8):
        want = jc.pack_bitset(jnp.pad(jnp.asarray(col[r].numpy() == 1),
                                      (0, 26)))
        np.testing.assert_array_equal(_u32(words[r]), np.asarray(want))


# ---------------------------------------------------------------------------
# B6: m-bit encoder
# ---------------------------------------------------------------------------


def _quantized(shape, seed, zero_groups_of=None):
    """q values as the §3.2.5 plan makes them: 0 <= q <= 2**30, with a
    spread of magnitudes (and optionally all-zero groups)."""
    rng = np.random.default_rng(seed)
    q = (rng.integers(0, 1 << 30, shape)
         >> rng.integers(0, 31, shape)).astype(np.int64)
    q.reshape(-1)[:5] = [0, 1, 1 << 30, 255, 256][:q.size]
    if zero_groups_of:
        q.reshape(-1, zero_groups_of)[::3] = 0
    return q.astype(np.int32)


def _plant_edges(q, m, group):
    """The encoder's value edges in the first groups of ``q``: all zeros, a
    maximum of 2^31 - 1, of exactly 2^m - 1 and of exactly 2^m (where the
    shift changes), and ones."""
    g = q.reshape(-1, group)
    for i, e in enumerate([0, 2 ** 31 - 1, (1 << m) - 1, 1 << m, 1]):
        g[i] = np.minimum(g[i], e)
        g[i, -1] = e
    return q


# (m, group, value edges planted, the CUDA kernel's unit for K = 12 group
# on 16 bytes: a thread a segment of lcm(group, 32 / m) <= 16 values, with
# 16-byte loads where that segment is a multiple of 4, else a warp)
@pytest.mark.parametrize("m,group,edges,unit", [
    pytest.param(4, 8, False, "thread16", id="4-8"),
    pytest.param(8, 4, False, "thread16", id="8-4"),
    pytest.param(8, 64, False, "warp", id="8-64"),
    pytest.param(16, 2, False, "thread", id="16-2"),
    pytest.param(16, 32, False, "warp", id="16-32"),
    pytest.param(2, 16, True, "thread16", id="2-16-edges"),
    pytest.param(2, 32, True, "warp", id="2-32-edges"),
    pytest.param(16, 2, True, "thread", id="16-2-edges"),
    pytest.param(16, 4, True, "thread16", id="16-4-edges"),
    pytest.param(16, 1024, True, "warp", id="16-1024-edges")])
def test_mbit_encode_bit_identical_to_jax(m, group, edges, unit):
    """Where the JAX kernel's contract holds (group a multiple of 32 / m):
    words and shifts equal the Pallas kernel's and ref's."""
    K = group * 12
    q = _quantized(K, m * 100 + group, zero_groups_of=group)
    if edges:
        q = _plant_edges(q, m, group)
    assert mbc.variant(K, m, group) == unit
    words, shifts = ops.mbit_encode(torch.from_numpy(q), m=m, group=group)
    jq = jnp.asarray(q.view(np.uint32))
    for want_w, want_s in (jmc.encode(jq, m, group, groups_per_block=4,
                                      interpret=True),
                           jref.mbit_encode(jq, m, group)):
        np.testing.assert_array_equal(_u32(words), np.asarray(want_w))
        np.testing.assert_array_equal(_u32(shifts), np.asarray(want_s))
    lo, hi = ops.mbit_decode_bounds(words, shifts, m=m, group=group)
    jlo, jhi = jmc.decode_bounds(jnp.asarray(_u32(words)),
                                 jnp.asarray(_u32(shifts)), m, group)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    qv = q.astype(np.int64)
    assert ((lo.numpy() <= qv) & (qv <= hi.numpy())).all()


@pytest.mark.parametrize("m", [4, 8, 16])
def test_mbit_encode_rows_match_the_plans_pack(m):
    """The §3.2.5 plan's layout at SF 1 over 8 nodes: (8, 1,250)-code rows
    in groups of 2 (a half word at m = 8 ends each row), against JAX
    ``encode_partials`` + ``vmap(pack_bits)`` and the plan's bounds."""
    P, Kp, group = 8, 1250, 2
    q = _quantized((P, Kp), m)
    words, shifts = ops.mbit_encode(torch.from_numpy(q), m=m, group=group)
    assert words.shape == (P, tc.packed_words(Kp, m))
    jq = jnp.asarray(q.view(np.uint32).reshape(-1))
    codes, jshifts = jta.encode_partials(jq, m, group)
    jwords = jax.vmap(lambda c: jc.pack_bits(c, m))(codes.reshape(P, Kp))
    np.testing.assert_array_equal(_u32(words), np.asarray(jwords))
    np.testing.assert_array_equal(_u32(shifts).reshape(-1),
                                  np.asarray(jshifts))
    # the port's step-1 codes and the plan's decode
    tcodes, tshifts = tta.encode_partials(torch.from_numpy(q), m, group)
    np.testing.assert_array_equal(_u32(tcodes).reshape(-1),
                                  np.asarray(codes))
    assert torch.equal(tshifts, shifts)
    lo, hi = ops.mbit_decode_bounds(words, shifts, m=m, group=group)
    jcodes = jax.vmap(lambda w: jc.unpack_bits(w, Kp, m))(jwords)
    jlo, jhi = jax.vmap(lambda c, s: jta.decode_bounds(c, s, group))(
        jcodes, jshifts.reshape(P, -1))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    tlo, thi = tta.decode_bounds(tcodes, tshifts, group)
    assert torch.equal(tlo, lo) and torch.equal(thi, hi)


def test_mbit_encode_1d_is_the_jax_ops_call():
    """A 1-D input is the one-row case of JAX ``ops.mbit_encode``."""
    from repro.kernels import ops as jops

    q = _quantized(4096, 9, zero_groups_of=1024)
    words, shifts = ops.mbit_encode(torch.from_numpy(q), m=8, group=1024)
    want_w, want_s = jops.mbit_encode(jnp.asarray(q.view(np.uint32)), m=8,
                                      group=1024)
    np.testing.assert_array_equal(_u32(words), np.asarray(want_w))
    np.testing.assert_array_equal(_u32(shifts), np.asarray(want_s))


def test_mbit_encode_rejects_bad_parameters():
    q = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="divide 32"):
        ops.mbit_encode(q, m=3, group=4)
    with pytest.raises(ValueError, match="does not divide"):
        ops.mbit_encode(q, m=8, group=5)


def test_new_cuda_wrappers_reject_cpu_tensors_and_count_launches():
    from repro_torch.kernels.bitset_pack import predicate_bitset_cuda
    from repro_torch.kernels.mbit_codec import mbit_encode_cuda
    from repro_torch.kernels.topk_select import block_topk_cuda

    with pytest.raises(ValueError, match="CUDA"):
        block_topk_cuda(torch.zeros(8), torch.zeros(8, dtype=torch.int32),
                        k=1)
    with pytest.raises(ValueError, match="CUDA"):
        predicate_bitset_cuda(torch.zeros(8, dtype=torch.int32), value=1)
    with pytest.raises(ValueError, match="CUDA"):
        mbit_encode_cuda(torch.zeros(8, dtype=torch.int32), m=8, group=4)
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    for name in ("block_topk", "predicate_bitset", "mbit_encode"):
        assert counts[name] == 0
    # the plain versions on CPU tensors count nothing
    ops.block_topk(torch.zeros(8), torch.zeros(8, dtype=torch.int32), k=1)
    assert ops.launch_counts()["block_topk"] == 0
