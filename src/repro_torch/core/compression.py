"""Fixed-width bit packing and packed bitsets (paper §3.2.1), the §3.2.2
cost model of the semi-join alternatives, and the Elias–Fano wire
parameters that the exchange codec and the byte-accurate model share.

Counterpart of ``repro.core.compression``.  Words are bit-identical to the
JAX package's ``uint32`` words, but stored as ``int32``: this torch build
has no shifts, adds or comparisons on ``uint32``.  All shift and compare
arithmetic runs in ``int64`` masked with ``0xFFFFFFFF``, so a word with bit
31 set is treated as unsigned, never sign-extended.
``words.numpy().view(np.uint32)`` is the JAX word array.

Functions take a leading batch of any shape (the node axis of the
node-stacked cluster): ``pack_bits`` on ``(P, n)`` values gives ``(P,
words)``, etc.
"""
from __future__ import annotations

import numpy as np
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


# ---------------------------------------------------------------------------
# §3.2.2 analytic cost model (bits communicated per node)
# ---------------------------------------------------------------------------


def alt1_bits(n: float, m: float, P: int) -> float:
    """Request-based semi-join: n requests after local filtering (n/P per
    node), remote table of m rows: n/P * log2(m*P/n) bits per node."""
    if n <= 0:
        return 0.0
    return (n / P) * float(np.log2(max(m * P / n, 2.0)))


def alt2_bits(m: float, gamma: float) -> float:
    """Replicated-bitset semi-join: γm qualifying rows of an m-row table:
    γ·m·log2(1/γ) bits; γ <= 0 ships nothing worth counting, γ >= 1 the
    m raw bits."""
    if gamma <= 0:
        return 0.0
    if gamma >= 1:
        return float(m)
    return gamma * m * float(np.log2(1.0 / gamma))


def choose_semijoin(n: float, m: float, gamma: float, P: int) -> int:
    """1 or 2 — the cheaper alternative under the paper's model (for
    n/P > m Alternative 2 is better anyway)."""
    if n / P > m:
        return 2
    return 1 if alt1_bits(n, m, P) <= alt2_bits(m, gamma) else 2


# ---------------------------------------------------------------------------
# packed wire format parameters (shared by the exchange codec and the
# byte-accurate cost model, so the model is exact by construction)
# ---------------------------------------------------------------------------

# The EF high parts live in a bounded universe of EF_UNIVERSE values, so a
# decoder finds every high part from EF_UNIVERSE - 1 zero markers of the
# upper bitvector.
EF_UNIVERSE = 16


def ef_params(capacity: int, domain: int) -> tuple:
    """Elias–Fano split of ``capacity`` sorted keys from a per-destination
    domain of ``domain`` values: ``(l, upper_words, lower_words)``.  Each
    key keeps ``l = max(0, ceil(log2(domain)) - 4)`` low bits, packed at
    width l; its high part (< EF_UNIVERSE) is unary-coded in a bitvector
    of ``capacity + high_domain + 1 + EF_UNIVERSE - 1`` bits, whose spare
    zeros make every zero-marker query answerable."""
    c = max(1, int(capacity))
    d = max(1, int(domain))
    l = max(0, (d - 1).bit_length() - 4) if d > 1 else 0
    hd = (d - 1) >> l
    upper_bits = c + hd + 1 + (EF_UNIVERSE - 1)
    lw = packed_words(c, l) if l else 0
    return l, (upper_bits + 31) // 32, lw


def packed_request_words(capacity: int, domain: int) -> int:
    """32-bit words of one packed request row: EF upper bitvector + EF
    lower bits + the folded validity-mask bitset."""
    l, uw, lw = ef_params(capacity, domain)
    return uw + lw + bitset_words(capacity)


# ---------------------------------------------------------------------------
# byte-accurate §3.2.2 model: static wire bytes of the compiled exchanges
# ---------------------------------------------------------------------------


def alt1_wire_bytes(capacity: int, P: int, domain: int = 0, *,
                    packed: bool = True, reply_bytes: int = 1) -> float:
    """Per-node bytes of the Alt-1 request/reply exchange at the plan's
    static buffer shapes: P-1 remote destination rows of ``capacity``
    slots, requests plus replies.  raw = int32 key + bool mask + reply
    byte(s) per slot; packed = EF-coded keys with the mask folded in, and
    1-byte (boolean) replies as a bitset."""
    rows = max(P - 1, 1)
    if packed and domain > 0:
        reply_words = (bitset_words(capacity) if reply_bytes == 1
                       else -(-capacity * reply_bytes // 4))
        words = packed_request_words(capacity, domain) + reply_words
        return float(rows * words * 4)
    return float(rows * capacity * (4 + 1 + reply_bytes))


def alt2_wire_bytes(m: float, P: int) -> float:
    """Per-node bytes of the Alt-2 replicated bitset: the local partition's
    packed predicate bits (m/P rows), allgathered to the other P-1 nodes;
    the same on raw and packed wire."""
    local = (int(m) + max(P, 1) - 1) // max(P, 1)
    return float(max(P - 1, 1) * bitset_words(local) * 4)


def choose_semijoin_wire(capacity: int, m: float, P: int, *,
                         domain: int = 0, packed: bool = True,
                         cal=None) -> int:
    """Alternative at the plan's static exchange shapes, 1 or 2: the wire
    bytes of the Alt-1 exchange against the Alt-2 bitset allgather.  The
    JAX package's latency model (``cal``) rests on a calibration of other
    hardware; the port has none for the card."""
    if cal is not None:
        raise NotImplementedError(
            "the port has no wire calibration of the card yet")
    a1 = alt1_wire_bytes(capacity, P, domain, packed=packed)
    return 1 if a1 <= alt2_wire_bytes(m, P) else 2
