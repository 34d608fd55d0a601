"""Calibration of the scan-strategy choice (compressed residency).

Counterpart of ``repro.core.scancal``.  Sequential scans are
bandwidth-bound: packing a column at ``width`` bits streams ``width/32``
of the raw bytes but pays ALU work to test predicates in code space.
Three machine rates and a roofline over them decide, per scanned column,
whether to evaluate the predicate on packed words or to decode the column
and filter raw:

  ``packed_ms = packed_bytes / mem_GBps + rows / scan_gvps``
  ``decode_ms = packed_bytes / mem_GBps + rows / unpack_gvps
              + raw_bytes / mem_GBps``       (write + re-read decoded)

The builtin rates are the JAX package's own defaults (a bandwidth-bound
node, packed wins at every realistic width), so both packages make the
same decisions where no calibration exists; they are model parameters,
not measurements of any device.  :func:`calibrate` measures the three
rates (``python -m repro_torch.core.scancal``) and the lowering loads
them (``load(strict=False)``) from the port's own file and variable,
``experiments/bench/torch_scan_calibration.json`` and
``REPRO_TORCH_SCAN_CAL``, so a calibration of the JAX package never
steers the port's scans, nor the reverse.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from repro_torch.core import compression

ENV_VAR = "REPRO_TORCH_SCAN_CAL"
DEFAULT_PATH = os.path.join("experiments", "bench",
                            "torch_scan_calibration.json")


@dataclasses.dataclass(frozen=True)
class ScanCalibration:
    """Machine rates of the scan roofline (GB/s and Gvalues/s).

    ``mem_gbps``: resident-column streaming bandwidth.  ``scan_gvps``:
    predicate-on-packed throughput (values tested per second, the scan
    kernel).  ``unpack_gvps``: full-column unpack throughput."""

    mem_gbps: float = 6.0
    scan_gvps: float = 4.0
    unpack_gvps: float = 4.0
    source: str = "builtin"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ScanCalibration":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


BUILTIN = ScanCalibration()


class ScanCalError(RuntimeError):
    """An explicitly requested calibration file is missing or unusable
    (the contract of :class:`repro_torch.core.wirecal.WireCalError`)."""


def load(path: Optional[str] = None, *,
         strict: Optional[bool] = None) -> ScanCalibration:
    """Calibration from ``path`` / $REPRO_TORCH_SCAN_CAL / the default
    location; explicit sources raise on failure, the implicit default
    falls back to :data:`BUILTIN`."""
    explicit = path or os.environ.get(ENV_VAR)
    if strict is None:
        strict = explicit is not None
    target = explicit or DEFAULT_PATH
    try:
        with open(target) as f:
            return ScanCalibration.from_json(json.load(f))
    except (OSError, ValueError, TypeError, AttributeError) as e:
        if strict:
            origin = "argument" if path else f"${ENV_VAR}"
            kind = ("unreadable" if isinstance(e, OSError)
                    else "not a calibration JSON object")
            raise ScanCalError(
                f"scan calibration file {target!r} (from {origin}) is "
                f"{kind}: {e}") from e
        return BUILTIN


def save(cal: ScanCalibration, path: Optional[str] = None) -> str:
    path = path or os.environ.get(ENV_VAR) or DEFAULT_PATH
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cal.to_json(), f, indent=1)
    return path


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


# ---------------------------------------------------------------------------
# calibration (run once per machine)
# ---------------------------------------------------------------------------


def calibrate(*, rows: int = 1 << 20, width: int = 12, repeat: int = 20,
              cal: Optional[ScanCalibration] = None,
              device=None) -> ScanCalibration:
    """Measure, on ``device`` (``cuda`` unless named), the streaming
    bandwidth (``torch.sum`` over an int32 column), the predicate-on-packed
    scan kernel (B1, ``kernels.ops.scan_filter``) and the full unpack
    (``compression.unpack_bits``) at a representative shape; CUDA events
    time each call on the card, the host clock on the CPU."""
    import numpy as np
    import torch

    from repro_torch.core.engine import resolve_device
    from repro_torch.core.wirecal import best_ms
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    base = cal or BUILTIN
    padded = -(-rows // 32) * 32
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(
        rng.integers(0, 1 << width, size=padded).astype(np.int64)).to(dev)
    words = compression.pack_bits(codes, width)[None]   # one node
    raw = codes.to(torch.int32)
    del codes

    t_mem = best_ms(lambda: torch.sum(raw), repeat, dev)
    t_scan = best_ms(lambda: ops.scan_filter(
        words, 1, 100, rows=rows, padded_rows=padded, width=width),
        repeat, dev)
    t_unpack = best_ms(lambda: compression.unpack_bits(words, padded, width),
                       repeat, dev)
    return dataclasses.replace(
        base,
        mem_gbps=rows * 4 / t_mem / 1e6,
        scan_gvps=rows / t_scan / 1e6,
        unpack_gvps=rows / t_unpack / 1e6,
        source=f"calibrated(rows={rows},width={width},device={dev.type})",
    )


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--width", type=int, default=12)
    ap.add_argument("--repeat", type=int, default=20)
    ap.add_argument("--device", type=str, default=None,
                    help="device the scan runs on (default: cuda)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    cal = calibrate(rows=args.rows, width=args.width, repeat=args.repeat,
                    cal=load(args.out, strict=False), device=args.device)
    path = save(cal, args.out)
    print(f"wrote {path}: mem {cal.mem_gbps:.2f} GB/s, "
          f"scan {cal.scan_gvps:.2f} Gv/s, unpack {cal.unpack_gvps:.2f} Gv/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
