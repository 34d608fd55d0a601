"""Fixed-width bit packing and packed bitsets (paper §3.2.1).

Counterpart of ``repro.core.compression`` (the packing and bitset parts;
the §3.2.2 cost model and the Elias–Fano helpers come with the exchange
slice).  Words are bit-identical to the JAX package's ``uint32`` words, but
stored as ``int32``: this torch build has no shifts, adds or comparisons on
``uint32``.  All shift and compare arithmetic runs in ``int64`` masked with
``0xFFFFFFFF``, so a word with bit 31 set is treated as unsigned, never
sign-extended.  ``words.numpy().view(np.uint32)`` is the JAX word array.

Functions take a leading batch of any shape (the node axis of the
node-stacked cluster): ``pack_bits`` on ``(P, n)`` values gives ``(P,
words)``, etc.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def packed_words(n: int, width: int) -> int:
    """Number of 32-bit words needed for n values of `width` bits."""
    return (n * width + 31) // 32


def bitset_words(n: int) -> int:
    """32-bit words of an n-bit packed bitset."""
    return (max(n, 0) + 31) // 32


def required_width(max_val: int) -> int:
    """Smallest width that can represent max_val (host-side helper);
    ``required_width(0) == 0``."""
    return int(max_val).bit_length()


def _width_mask(width: int) -> int:
    return (1 << width) - 1 if width < 32 else M32


def as_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 (or any int) words -> int64 holding the unsigned value."""
    return words.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2**32) -> int32 of the same bits."""
    x = x & M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_bits(vals: torch.Tensor, width: int) -> torch.Tensor:
    """Pack ``vals`` (..., n) — non-negative ints < 2**width — into (...,
    packed_words(n, width)) int32 words, little-endian bit order.

    32 consecutive values occupy exactly ``width`` words from a word
    boundary, so after padding n to a multiple of 32 every value's word
    index and bit offset within its group is STATIC: 32 vectorized
    shift/or steps and no scatter.  ``width == 0`` gives the empty word
    array (the constant-column degenerate)."""
    assert 0 <= width <= 32
    lead, n = tuple(vals.shape[:-1]), vals.shape[-1]
    if width == 0:
        return torch.zeros(lead + (0,), dtype=torch.int32, device=vals.device)
    v = vals.to(torch.int64) & _width_mask(width)
    pad = (-n) % 32
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    groups = v.shape[-1] // 32
    v = v.reshape(lead + (groups, 32))
    w = torch.zeros(lead + (groups, width), dtype=torch.int64,
                    device=vals.device)
    for j in range(32):
        bit = j * width
        wi, off = bit >> 5, bit & 31
        w[..., wi] |= (v[..., j] << off) & M32
        if off + width > 32:  # static straddle: high bits spill over
            w[..., wi + 1] |= v[..., j] >> (32 - off)
    w = w.reshape(lead + (groups * width,))[..., :packed_words(n, width)]
    return to_i32(w)


def gather_bits(words: torch.Tensor, idx: torch.Tensor,
                width: int) -> torch.Tensor:
    """Random-access extract: the codes at row indices ``idx`` (..., k) of
    a :func:`pack_bits` stream (..., nwords), as int32 (bit-identical to
    the JAX uint32 codes).  The late-materialization primitive: decode
    only the surviving rows."""
    assert 0 <= width <= 32
    if width == 0:
        return torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
    w = as_u32(words)
    nwords = w.shape[-1]
    bitpos = idx.to(torch.int64) * width
    word = bitpos >> 5
    off = bitpos & 31
    lo = torch.gather(w, -1, word) >> off
    nxt = torch.gather(w, -1, torch.clamp(word + 1, max=nwords - 1))
    hi = torch.where(off > 0, nxt << (32 - off), 0) & M32
    return to_i32((lo | hi) & _width_mask(width))


def unpack_bits(words: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """Inverse of pack_bits: (..., nwords) -> (..., n) int32 codes."""
    assert 0 <= width <= 32
    lead = tuple(words.shape[:-1])
    if width == 0:
        return torch.zeros(lead + (n,), dtype=torch.int32,
                           device=words.device)
    idx = torch.arange(n, device=words.device).expand(lead + (n,))
    return gather_bits(words, idx, width)


# ---------------------------------------------------------------------------
# packed bitsets
# ---------------------------------------------------------------------------


def pack_bitset(bits: torch.Tensor) -> torch.Tensor:
    """bool (..., n) -> int32 (..., n/32); n must be a multiple of 32 (the
    engine's fixed shapes; callers pad)."""
    n = bits.shape[-1]
    assert n % 32 == 0, f"bitset length must be multiple of 32, got {n}"
    lead = tuple(bits.shape[:-1])
    b = bits.reshape(lead + (n // 32, 32)).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    return to_i32((b * weights).sum(-1))


def unpack_bitset(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32 (..., nwords) -> bool (..., n)."""
    lead = tuple(words.shape[:-1])
    shifts = torch.arange(32, device=words.device)
    bits = (as_u32(words)[..., None] >> shifts) & 1
    return bits.reshape(lead + (-1,))[..., :n].to(torch.bool)


def probe_bitset(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Test bit ``idx`` (..., k) of a packed bitset (..., nwords)."""
    idx = idx.to(torch.int64)
    word = torch.gather(as_u32(words), -1, idx >> 5)
    return ((word >> (idx & 31)) & 1).to(torch.bool)
