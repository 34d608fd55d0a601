"""Calibration of the scan-strategy choice (compressed residency).

Counterpart of ``repro.core.scancal`` (the rates, the predictors and the
chooser).  Sequential scans are bandwidth-bound: packing a column at ``width`` bits
streams ``width/32`` of the raw bytes but pays ALU work to test predicates
in code space.  Three machine rates and a roofline over them decide, per
scanned column, whether to evaluate the predicate on packed words or to
decode the column and filter raw:

  ``packed_ms = packed_bytes / mem_GBps + rows / scan_gvps``
  ``decode_ms = packed_bytes / mem_GBps + rows / unpack_gvps
              + raw_bytes / mem_GBps``       (write + re-read decoded)

The builtin rates are the JAX package's own defaults (a bandwidth-bound
node, packed wins at every realistic width), so both packages make the
same decisions; they are model parameters, not measurements of any device.
The file loader and the calibration tool wait for a slice that measures
the card: until then every plan uses :data:`BUILTIN`, so no calibration
file left in a checkout changes which scans run packed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import compression


@dataclasses.dataclass(frozen=True)
class ScanCalibration:
    """Machine rates of the scan roofline (GB/s and Gvalues/s)."""

    mem_gbps: float = 6.0
    scan_gvps: float = 4.0
    unpack_gvps: float = 4.0
    source: str = "builtin"


BUILTIN = ScanCalibration()


# ---------------------------------------------------------------------------
# roofline predictors (ms; bytes / GBps / 1e6 == ms, rows / Gvps / 1e6 == ms)
# ---------------------------------------------------------------------------


def packed_scan_bytes(rows: int, width: int) -> int:
    """Bytes streamed by predicate-on-packed: the packed words plus the
    emitted validity bitset."""
    return (compression.packed_words(rows, width)
            + compression.bitset_words(rows)) * 4


def decode_scan_bytes(rows: int, width: int, itemsize: int = 4) -> int:
    """Bytes touched by decode-then-filter: packed words in, decoded
    column out + re-read, bitset out."""
    return (compression.packed_words(rows, width) * 4
            + 2 * rows * itemsize + compression.bitset_words(rows) * 4)


def predict_packed_ms(rows: int, width: int, *,
                      cal: Optional[ScanCalibration] = None) -> float:
    cal = cal or BUILTIN
    return (packed_scan_bytes(rows, width) / (cal.mem_gbps * 1e6)
            + rows / (cal.scan_gvps * 1e6))


def predict_decode_ms(rows: int, width: int, itemsize: int = 4, *,
                      cal: Optional[ScanCalibration] = None) -> float:
    cal = cal or BUILTIN
    return (decode_scan_bytes(rows, width, itemsize) / (cal.mem_gbps * 1e6)
            + rows / (cal.unpack_gvps * 1e6))


def choose_scan_mode(rows: int, width: int, itemsize: int = 4, *,
                     cal: Optional[ScanCalibration] = None) -> str:
    """'packed' iff the roofline predicts the in-place code-space test is
    at least as fast as decoding the column and filtering raw."""
    packed = predict_packed_ms(rows, width, cal=cal)
    decode = predict_decode_ms(rows, width, itemsize, cal=cal)
    return "packed" if packed <= decode else "decode"
