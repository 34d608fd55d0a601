"""Latency calibration for the wire-format choice (paper §3.2.1, §5.3).

Counterpart of ``repro.core.wirecal``.  The byte-accurate model in
:mod:`repro_torch.core.compression` says how many bytes each wire format
ships; whether the PACKED format is also *faster* depends on where the
exchange is bottlenecked: compression pays only when the codec outruns
the network.  Three calibrated rates settle it, through a roofline:

  ``predicted_ms = codec_bytes / codec_GBps            (encode + decode)
                 + wire_bytes  / link_GBps             (serialized volume)
                 + collectives * msg_ms``              (per-message latency)

``raw`` wire has no codec term but ships ~4-6x the bytes in 3
collectives; ``packed`` pays the codec term and ships the Elias–Fano
words in 2.  The crossover is a property of the MACHINE, not of the plan,
so the rates are calibrated once (``python -m repro_torch.core.wirecal``)
and loaded by the planner.  The builtin defaults are the JAX package's
(the paper's GbE cluster: the link far slower than the codec, so packed
wins), so both packages decide alike where no calibration exists; they
are model parameters, not measurements of any device.

The port keeps its own file and variable, ``experiments/bench/
torch_wire_calibration.json`` and ``REPRO_TORCH_WIRE_CAL``: a calibration
of the JAX package's codec never steers the port's plans, nor the
reverse.  The JSON keys are the JAX package's, so a file written by
either package loads in the other.

:func:`calibrate` MEASURES the codec: the wire codec kernels (B3,
``kernels.ops.ef_encode`` / ``ef_decode``) at a representative shape, each
call timed with CUDA events on the card (the launch returns before the
kernel ends) and with the host clock on the CPU.  The link rate and the
per-message latency cannot be measured with every node on one device
(its "collectives" move memory, not packets), so they are deployment
knobs: set them in the calibration file.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from repro_torch.core import compression

# calibration file: the variable, else the repo's bench artifacts
ENV_VAR = "REPRO_TORCH_WIRE_CAL"
DEFAULT_PATH = os.path.join("experiments", "bench",
                            "torch_wire_calibration.json")


@dataclasses.dataclass(frozen=True)
class WireCalibration:
    """Machine rates of the roofline model (GB/s and ms).

    ``encode_gbps``/``decode_gbps``: packed-codec throughput in wire bytes
    produced/consumed per second.  ``link_gbps``: per-node all-to-all
    bandwidth.  ``msg_ms``: fixed per-collective latency (startup + sync).
    """

    encode_gbps: float = 1.0
    decode_gbps: float = 1.0
    link_gbps: float = 0.125   # the paper's GbE cluster: ~1 Gbit/s links
    msg_ms: float = 0.05
    source: str = "builtin"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "WireCalibration":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


BUILTIN = WireCalibration()


class WireCalError(RuntimeError):
    """An explicitly requested calibration file is missing or unusable.

    Raised only when the caller POINTED at a file (a ``path`` argument or
    $REPRO_TORCH_WIRE_CAL): planning on the builtin rates after a machine
    model was named would make every wire choice quietly wrong.  The
    implicit default location falls back to :data:`BUILTIN`: absence
    there means "never calibrated"."""


def load(path: Optional[str] = None, *,
         strict: Optional[bool] = None) -> WireCalibration:
    """Calibration from ``path`` / $REPRO_TORCH_WIRE_CAL / the default
    location.  An EXPLICIT source (argument or variable) that is missing
    or corrupt raises :class:`WireCalError`; only the implicit default
    falls back to :data:`BUILTIN`.  ``strict`` overrides that (e.g.
    ``strict=False`` to calibrate into a file that does not exist yet)."""
    explicit = path or os.environ.get(ENV_VAR)
    if strict is None:
        strict = explicit is not None
    target = explicit or DEFAULT_PATH
    try:
        with open(target) as f:
            return WireCalibration.from_json(json.load(f))
    except (OSError, ValueError, TypeError, AttributeError) as e:
        if strict:
            origin = "argument" if path else f"${ENV_VAR}"
            kind = ("unreadable" if isinstance(e, OSError)
                    else "not a calibration JSON object")
            raise WireCalError(
                f"wire calibration file {target!r} (from {origin}) is "
                f"{kind}: {e}") from e
        return BUILTIN


_CACHED: Optional[tuple] = None   # (source it was loaded from, calibration)


def cached() -> WireCalibration:
    """:func:`load`, cached per source (the variable's value, else the
    default path): the exchange layer's predictions read it once a
    lowered plan, never the file each time."""
    global _CACHED
    key = os.environ.get(ENV_VAR) or DEFAULT_PATH
    if _CACHED is None or _CACHED[0] != key:
        _CACHED = (key, load())
    return _CACHED[1]


def save(cal: WireCalibration, path: Optional[str] = None) -> str:
    path = path or os.environ.get(ENV_VAR) or DEFAULT_PATH
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cal.to_json(), f, indent=1)
    return path


# ---------------------------------------------------------------------------
# roofline predictor (ms; bytes / GBps / 1e6 == ms)
# ---------------------------------------------------------------------------


def alt1_codec_bytes(capacity: int, P: int, domain: int) -> float:
    """Bytes the packed codec touches for one Alt-1 exchange: the EF
    request rows (encoded at the sender, decoded at the receiver) plus the
    folded boolean reply bitsets."""
    rows = max(P - 1, 1)
    return float(rows * (compression.packed_request_words(capacity, domain)
                         + compression.bitset_words(capacity)) * 4)


def predict_codec_ms(capacity: int, P: int, domain: int, *,
                     cal: Optional[WireCalibration] = None):
    """(encode_ms, decode_ms) of the packed codec for one Alt-1 exchange:
    the two halves of the roofline's codec term."""
    cal = cal or BUILTIN
    cb = alt1_codec_bytes(capacity, P, domain)
    return cb / (cal.encode_gbps * 1e6), cb / (cal.decode_gbps * 1e6)


def predict_alt1_ms(capacity: int, P: int, domain: int, *, packed: bool,
                    cal: Optional[WireCalibration] = None):
    """(codec_ms, wire_ms) of one Alt-1 request/reply exchange.  ``wire_ms``
    is link volume plus per-collective latency at the format's collective
    count (2 packed / 1+2 raw: the request key+mask pair and the reply)."""
    cal = cal or BUILTIN
    nbytes = compression.alt1_wire_bytes(capacity, P, domain, packed=packed)
    if packed and domain > 0:
        codec_ms = sum(predict_codec_ms(capacity, P, domain, cal=cal))
        collectives = 2
    else:
        codec_ms = 0.0
        collectives = 3
    wire_ms = nbytes / (cal.link_gbps * 1e6) + collectives * cal.msg_ms
    return codec_ms, wire_ms


def predict_alt2_ms(m: float, P: int, *,
                    cal: Optional[WireCalibration] = None):
    """(codec_ms, wire_ms) of the Alt-2 replicated-bitset allgather (one
    collective; the bitset is packed on both wire kinds)."""
    cal = cal or BUILTIN
    nbytes = compression.alt2_wire_bytes(m, P)
    codec_ms = (nbytes / (cal.encode_gbps * 1e6)
                + nbytes / (cal.decode_gbps * 1e6))
    wire_ms = nbytes / (cal.link_gbps * 1e6) + cal.msg_ms
    return codec_ms, wire_ms


def choose_wire_kind(capacity: int, P: int, domain: int,
                     cal: Optional[WireCalibration] = None) -> str:
    """'packed' iff the roofline predicts the packed Alt-1 exchange is at
    least as fast as raw: the codec pays only when the exchange is
    network-bound (slow link / fast codec), never on codec-bound setups."""
    pc, pw = predict_alt1_ms(capacity, P, domain, packed=True, cal=cal)
    _, rw = predict_alt1_ms(capacity, P, domain, packed=False, cal=cal)
    return "packed" if pc + pw <= rw else "raw"


# ---------------------------------------------------------------------------
# codec-throughput calibration (run once per machine)
# ---------------------------------------------------------------------------


def best_ms(fn, repeat: int, device) -> float:
    """Fastest of ``repeat`` timed calls of ``fn`` in ms (after one warm
    call): CUDA events around each call on the card, the host clock with
    the call complete on the CPU."""
    import time

    import torch

    fn()
    times = []
    for _ in range(repeat):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def calibrate(*, capacity: int = 4096, domain: int = 3750, nodes: int = 8,
              repeat: int = 20, cal: Optional[WireCalibration] = None,
              device=None) -> WireCalibration:
    """Measure the codec kernels' encode/decode throughput on
    ``device`` (``cuda`` unless named) at a representative shape and
    return a calibration carrying the measured rates (the link knobs
    inherited from ``cal`` / builtin, see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.core.engine import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    base_cal = cal or BUILTIN
    rng = np.random.default_rng(0)
    fill = int(capacity * 0.8)
    buckets = np.zeros((nodes, capacity), np.int32)
    mask = np.zeros((nodes, capacity), bool)
    for p in range(nodes):
        buckets[p, :fill] = np.sort(
            rng.integers(0, domain, size=fill)) + p * domain
        mask[p, :fill] = True
    buckets = torch.from_numpy(buckets).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    base = torch.arange(nodes, dtype=torch.int64, device=dev) * domain
    words = ops.ef_encode(buckets, mask, base, domain=domain)

    nbytes = nodes * compression.packed_request_words(capacity, domain) * 4
    t_enc = best_ms(lambda: ops.ef_encode(buckets, mask, base,
                                          domain=domain), repeat, dev)
    t_dec = best_ms(lambda: ops.ef_decode(words, base, capacity=capacity,
                                          domain=domain), repeat, dev)
    return dataclasses.replace(
        base_cal,
        encode_gbps=nbytes / t_enc / 1e6,
        decode_gbps=nbytes / t_dec / 1e6,
        source=f"calibrated(capacity={capacity},domain={domain},"
               f"nodes={nodes},device={dev.type})",
    )


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--domain", type=int, default=3750)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=20)
    ap.add_argument("--device", type=str, default=None,
                    help="device the codec runs on (default: cuda)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    # tolerant load: calibrating INTO a path that does not exist yet is
    # the fresh-machine flow; the link knobs come from what is there
    cal = calibrate(capacity=args.capacity, domain=args.domain,
                    nodes=args.nodes, repeat=args.repeat,
                    cal=load(args.out, strict=False), device=args.device)
    path = save(cal, args.out)
    print(f"wrote {path}: encode {cal.encode_gbps:.3f} GB/s, "
          f"decode {cal.decode_gbps:.3f} GB/s, link {cal.link_gbps} GB/s, "
          f"msg {cal.msg_ms} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
