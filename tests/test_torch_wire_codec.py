"""The port's wire codec (kernel B3's plain versions on the CPU) and its
byte-accurate cost model against the JAX package.

The encoder must emit the same words as the JAX reference codec, its
gather-light XLA formulation and its Pallas lane kernels (run in interpret
mode), including low-bit widths that straddle words (l = 7, 14, 17); the
decoder must recover keys and mask.  The CUDA kernels run only on the
card, where ``chip_smoke.py`` holds them against these plain versions.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.kernels import ops as jops
from repro.kernels import wire_codec as jwc
from repro_torch.core import compression as tc
from repro_torch.kernels import ops

CODEC_KERNELS = ("ef_encode", "ef_decode", "mask_fold", "mask_unfold")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


def _synth_buckets(cap, domain, rows=4, seed=0, top=False):
    """Sorted per-destination buckets: row 0 empty, row 1 full, row 2 with
    every key repeated (duplicates), the rest random fills; row d's keys
    lie in [d * domain, (d + 1) * domain).  ``top`` puts the last 20 keys
    of each row at the top of the domain (high part 15 where the domain is
    a power of two)."""
    rng = np.random.default_rng(seed)
    buckets = np.zeros((rows, cap), np.int32)
    mask = np.zeros((rows, cap), bool)
    for d in range(rows):
        count = (0 if d == 0 else cap if d == 1
                 else int(rng.integers(1, cap + 1)))
        keys = np.sort(rng.integers(0, domain, count))
        if d == 2:
            keys = np.sort(np.repeat(keys[:max(1, count // 3)], 3)[:count])
            count = len(keys)
        if top:
            keys[-20:] = domain - 1
        buckets[d, :count] = keys + d * domain
        mask[d, :count] = True
    return buckets, mask


# the JAX package's parity shapes (l = 0, 1, 4, 8), then the SF 0.01 and
# SF 10 exchange domains whose low parts straddle words: l = 7, 14, 17;
# then capacities of one slot, under a word and one past a 1,024-slot
# tile at l = 2 and 16 (widths that divide 32)
CODEC_SHAPES = [(8, 16), (33, 32), (64, 250), (100, 1000), (96, 4096),
                (257, 1875), (300, 187500), (64, 1875000),
                (1, 64), (1, 2 ** 20), (31, 64), (31, 2 ** 20), (1025, 64),
                (1025, 2 ** 20)]


@pytest.mark.parametrize("cap,domain", CODEC_SHAPES)
def test_ef_codec_bit_identical_to_jax_codecs(cap, domain):
    buckets, mask = _synth_buckets(cap, domain, seed=cap + domain)
    rows = buckets.shape[0]
    jb, jm = jnp.asarray(buckets), jnp.asarray(mask)
    want = {
        "ref": jops._ef_encode(jb, jm, domain=domain, impl="ref"),
        "xla": jops._ef_encode(jb, jm, domain=domain, impl="xla"),
        "pallas": jwc.ef_encode(jb, jm, domain, use_pallas=True,
                                interpret=True),
    }
    ops.reset_launch_counts()
    base = torch.arange(rows, dtype=torch.int64) * domain
    words = ops.ef_encode(torch.from_numpy(buckets), torch.from_numpy(mask),
                          base, domain=domain)
    assert words.dtype == torch.int32
    assert words.shape == (rows, jc.packed_request_words(cap, domain))
    for name, w in want.items():
        np.testing.assert_array_equal(_u32(words), np.asarray(w),
                                      err_msg=name)
    # decode each JAX encoder's words (offsets, base 0) with the port
    zero = torch.zeros(rows, dtype=torch.int64)
    offs = np.where(mask, buckets - np.arange(rows)[:, None] * domain, 0)
    for name, w in want.items():
        jw = torch.from_numpy(np.asarray(w).view(np.int32).copy())
        keys, got_mask = ops.ef_decode(jw, zero, capacity=cap, domain=domain)
        np.testing.assert_array_equal(got_mask.numpy(), mask, err_msg=name)
        np.testing.assert_array_equal(keys.numpy(), offs, err_msg=name)
    # with the row bases back, the keys come out exactly
    keys, _ = ops.ef_decode(words, base, capacity=cap, domain=domain)
    np.testing.assert_array_equal(keys.numpy(), np.where(mask, buckets, 0))
    assert all(ops.launch_counts()[k] == 0 for k in CODEC_KERNELS)


@pytest.mark.parametrize("cap,domain", [(64, 250), (257, 1875)])
def test_ef_codec_node_stacked_rows(cap, domain):
    """Rows r = src * P + dst of P sources: each source's P rows encode as
    the JAX encoder encodes that source's (P, cap) buckets, and the
    receivers' rows r = dst * P + src decode with base dst * domain."""
    P = 4
    per_src = [_synth_buckets(cap, domain, rows=P, seed=s) for s in range(P)]
    buckets = np.stack([b for b, _ in per_src])          # (src, dst, cap)
    mask = np.stack([m for _, m in per_src])
    rows = torch.arange(P * P)
    words = ops.ef_encode(torch.from_numpy(buckets.reshape(P * P, cap)),
                          torch.from_numpy(mask.reshape(P * P, cap)),
                          (rows % P) * domain, domain=domain)
    for s in range(P):
        want = jops._ef_encode(jnp.asarray(buckets[s]), jnp.asarray(mask[s]),
                               domain=domain, impl="ref")
        np.testing.assert_array_equal(_u32(words[s * P:(s + 1) * P]),
                                      np.asarray(want))
    received = words.reshape(P, P, -1).transpose(0, 1).reshape(P * P, -1)
    keys, got = ops.ef_decode(received, (rows // P) * domain, capacity=cap,
                              domain=domain)
    np.testing.assert_array_equal(
        keys.numpy().reshape(P, P, cap),
        np.where(mask, buckets, 0).transpose(1, 0, 2))
    np.testing.assert_array_equal(got.numpy().reshape(P, P, cap),
                                  mask.transpose(1, 0, 2))


@pytest.mark.parametrize("cap,domain", [(31, 64), (31, 2 ** 20),
                                        (1020, 16), (1055, 2 ** 20)])
def test_ef_codec_top_keys_spill_past_the_last_slot(cap, domain):
    """Keys at the top of a power-of-two domain have high part 15, so the
    full row's last upper bit lies in a word past ceil(cap / 32): the
    upper words the kernels write beyond the slots' own."""
    buckets, mask = _synth_buckets(cap, domain, seed=cap, top=True)
    rows = buckets.shape[0]
    l, uw, _ = jc.ef_params(cap, domain)
    spill = (cap - 1 + 15) // 32
    assert (domain - 1) >> l == 15 and jc.bitset_words(cap) <= spill < uw
    jb, jm = jnp.asarray(buckets), jnp.asarray(mask)
    base = torch.arange(rows, dtype=torch.int64) * domain
    words = ops.ef_encode(torch.from_numpy(buckets), torch.from_numpy(mask),
                          base, domain=domain)
    assert _u32(words)[1, spill] >> ((cap - 1 + 15) & 31) & 1
    for name, w in {
            "ref": jops._ef_encode(jb, jm, domain=domain, impl="ref"),
            "xla": jops._ef_encode(jb, jm, domain=domain, impl="xla"),
            "pallas": jwc.ef_encode(jb, jm, domain, use_pallas=True,
                                    interpret=True)}.items():
        np.testing.assert_array_equal(_u32(words), np.asarray(w),
                                      err_msg=name)
    keys, got = ops.ef_decode(words, base, capacity=cap, domain=domain)
    np.testing.assert_array_equal(got.numpy(), mask)
    np.testing.assert_array_equal(keys.numpy(), np.where(mask, buckets, 0))


def test_ef_encode_clips_out_of_domain_offsets():
    """Offsets outside [0, domain) are clipped, as the reference clips
    them (the verifier's rules depend on it)."""
    cap, domain = 40, 250
    buckets = np.sort(np.random.default_rng(3).integers(-50, 300, (2, cap)),
                      axis=1).astype(np.int32)
    mask = np.ones((2, cap), bool)
    mask[1, 30:] = False
    got = ops.ef_encode(torch.from_numpy(buckets), torch.from_numpy(mask),
                        torch.arange(2) * domain, domain=domain)
    want = jops._ef_encode(jnp.asarray(buckets), jnp.asarray(mask),
                           domain=domain, impl="ref")
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("cols", [8, 32, 33, 97, 256])
def test_mask_fold_bit_identical_to_jax(cols):
    rng = np.random.default_rng(cols)
    mask = rng.random((4, cols)) < 0.5
    ops.reset_launch_counts()
    words = ops.mask_fold(torch.from_numpy(mask))
    jm = jnp.asarray(mask)
    for name, w in {"ref": jops._mask_fold(jm, impl="ref"),
                    "xla": jops._mask_fold(jm, impl="xla"),
                    "pallas": jwc.mask_fold(jm, use_pallas=True,
                                            interpret=True)}.items():
        np.testing.assert_array_equal(_u32(words), np.asarray(w),
                                      err_msg=name)
    back = ops.mask_unfold(words, n=cols)
    np.testing.assert_array_equal(back.numpy(), mask)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jwc.mask_unfold(jnp.asarray(_u32(words)),
                                                 cols, use_pallas=True,
                                                 interpret=True)))
    assert all(ops.launch_counts()[k] == 0 for k in CODEC_KERNELS)


def test_codec_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never run the plain
    version."""
    from repro_torch.kernels.wire_codec import ef_encode_cuda, mask_fold_cuda

    with pytest.raises(ValueError, match="CUDA"):
        mask_fold_cuda(torch.zeros((2, 40), dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        ef_encode_cuda(torch.zeros((2, 40), dtype=torch.int32),
                       torch.zeros((2, 40), dtype=torch.bool),
                       torch.zeros(2, dtype=torch.int64), domain=100)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32])
@pytest.mark.parametrize("cols,offset,want", [
    (4096, 0, True), (4096, 1, False), (4096, 16, True), (4100, 0, False),
    (1, 0, False), (1024, 3, False), (1040, 0, True)])
def test_vector_rows_needs_whole_16_byte_rows(dtype, cols, offset, want):
    """The codec wrappers take a kernel's 16-byte variant only where every
    row of 16-slot units starts on 16 bytes: ``cols`` a multiple of 16,
    from a tensor that starts on 16 bytes (``offset`` elements past a
    fresh allocation)."""
    from repro_torch.kernels.wire_codec import vector_rows

    flat = torch.zeros(2 * cols + 16, dtype=dtype)
    assert flat.data_ptr() % 16 == 0
    t = flat[offset:offset + 2 * cols].view(2, cols)
    assert vector_rows(cols, t) is want


# -- the byte-accurate §3.2.2 model ---------------------------------------


@pytest.mark.parametrize("P", [1, 2, 8, 64])
def test_wire_cost_model_equals_jax(P):
    for cap in (1, 31, 64, 257, 4096, 131072, 8388608):
        for domain in (1, 2, 16, 250, 1875, 187500, 1875000):
            assert tc.ef_params(cap, domain) == jc.ef_params(cap, domain)
            assert (tc.packed_request_words(cap, domain)
                    == jc.packed_request_words(cap, domain))
            for packed in (True, False):
                assert (tc.alt1_wire_bytes(cap, P, domain, packed=packed)
                        == jc.alt1_wire_bytes(cap, P, domain, packed=packed))
            for m in (250, 200_000, 15_000_000):
                assert tc.alt2_wire_bytes(m, P) == jc.alt2_wire_bytes(m, P)
                for packed in (True, False):
                    kw = dict(domain=domain, packed=packed)
                    assert (tc.choose_semijoin_wire(cap, m, P, **kw)
                            == jc.choose_semijoin_wire(cap, m, P, **kw))
    for n in (0, 10, 1e4, 1e7):
        for m in (250, 1e6):
            assert tc.alt1_bits(n, m, P) == jc.alt1_bits(n, m, P)
            for gamma in (0.0, 0.04, 0.5, 1.0):
                assert tc.alt2_bits(m, gamma) == jc.alt2_bits(m, gamma)
                assert (tc.choose_semijoin(n, m, gamma, P)
                        == jc.choose_semijoin(n, m, gamma, P))


def test_wire_calibration_is_not_ported():
    from repro_torch.query import stats
    from repro_torch.query.ir import LoweringError

    with pytest.raises(NotImplementedError, match="calibration of the card"):
        tc.choose_semijoin_wire(64, 1000, 8, domain=125, cal=object())
    with pytest.raises(LoweringError, match="calibration of the card"):
        stats.wire_format_for(1000, 8, kind="auto")
