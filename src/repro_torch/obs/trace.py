"""Structured trace layer: nested spans, Chrome-trace export, text render.

Counterpart of ``repro.obs.trace``.

One :class:`Observer` object is threaded through the engine (driver,
router, lowering) instead of a global — tests construct
their own and assert on the exact spans a code path emitted.  A span is a
named, timed interval with attributes and children; an event is an
instant (zero-duration) child.  The driver records per-query spans (route
decision, plan-cache hit/miss, compile vs execute), the lowering records
its decisions, and a parameterization records what it extracted.  A
span's time is host wall time: work a span launches on the device may
still be running when it closes.

Export targets:

- :meth:`Observer.to_chrome_trace` — the Chrome trace-event JSON dict
  (``{"traceEvents": [...]}``; complete-``X`` spans, instant-``i``
  events, microsecond timestamps) that https://ui.perfetto.dev and
  ``chrome://tracing`` load directly; :meth:`Observer.save_chrome_trace`
  writes it to a file.
- :meth:`Observer.pretty` — an indented text tree for terminals/tests.

A disabled observer (``enabled=False``) swallows everything through a
shared null span, so instrumented code paths need no ``if`` guards; the
companion :class:`~repro_torch.obs.metrics.MetricsRegistry` rides on the
same object (``obs.metrics``) so every instrumented site can emit both.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

# root spans retained (FIFO): benchmark loops run thousands of queries and
# must not grow the trace without bound; exports see the most recent window
MAX_ROOT_SPANS = 1024


@dataclasses.dataclass
class Span:
    """One timed interval.  ``t0``/``dur`` are seconds relative to the
    observer's epoch; attributes are plain data (they land in the Chrome
    trace ``args`` field verbatim)."""

    name: str
    cat: str = "query"
    t0: float = 0.0
    dur: float = 0.0
    attrs: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)

    def set(self, **attrs) -> "Span":
        """Attach attributes mid-span (tier decided during execution)."""
        self.attrs.update(attrs)
        return self

    @property
    def instant(self) -> bool:
        return self.dur == 0.0 and not self.children

    def find(self, name: str) -> list:
        """All spans/events named ``name`` in this subtree (pre-order)."""
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out


class _NullSpan:
    """Shared do-nothing span handle for a disabled observer."""

    __slots__ = ()

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanContext:
    """Context manager driving one live span on the observer's stack."""

    __slots__ = ("obs", "span")

    def __init__(self, obs: "Observer", span: Span):
        self.obs = obs
        self.span = span

    def __enter__(self) -> Span:
        self.obs._stack.append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        span = self.obs._stack.pop()
        span.dur = self.obs._now() - span.t0
        if exc_type is not None:
            span.attrs["error"] = f"{exc_type.__name__}: {exc}"
        if self.obs._stack:
            self.obs._stack[-1].children.append(span)
        else:
            self.obs.spans.append(span)
        return False


class Observer:
    """The engine's observability hub: a span stack plus a metrics
    registry, explicitly threaded (never a global).

    ``enabled=False`` turns the trace layer off (spans become no-ops and
    nothing is retained) while the metrics registry stays live — counters
    are the always-on tier, traces the on-by-default-but-droppable one.

    The span stack is PER-THREAD: the serving tier records spans from the
    asyncio event loop and its dispatch executor concurrently, and a
    shared stack would interleave their push/pop sequences (a worker's
    ``execute`` span would pop the event loop's half-open request span).
    Each thread nests independently; completed roots from every thread
    land in the one shared ``spans`` deque (append is atomic).
    """

    def __init__(self, enabled: bool = True,
                 metrics: Optional[MetricsRegistry] = None):
        self.enabled = enabled
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.spans: deque = deque(maxlen=MAX_ROOT_SPANS)  # completed roots
        self._tls = threading.local()
        self._epoch = time.perf_counter()

    @property
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _now(self) -> float:
        return time.perf_counter() - self._epoch

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "query", **attrs):
        """``with obs.span("execute", source="q6") as sp: ...`` — nested
        spans attach to the innermost open span, top-level spans to
        ``obs.spans``."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanContext(self, Span(name=name, cat=cat, t0=self._now(),
                                       attrs=dict(attrs)))

    def event(self, name: str, cat: str = "query", **attrs) -> None:
        """Instant event, attached like a zero-duration child span."""
        if not self.enabled:
            return
        ev = Span(name=name, cat=cat, t0=self._now(), attrs=dict(attrs))
        if self._stack:
            self._stack[-1].children.append(ev)
        else:
            self.spans.append(ev)

    def open_span(self, name: str, cat: str = "query", **attrs):
        """Manually managed span for call sites that cannot scope a
        ``with`` block to one thread's stack — an asyncio task's request
        span stays open across ``await`` points while OTHER tasks on the
        same thread open and close theirs, so stack-nested spans would
        pop in the wrong order.  The returned span is detached (never on
        any stack); finish it with :meth:`close_span`."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(name=name, cat=cat, t0=self._now(), attrs=dict(attrs))

    def close_span(self, span) -> None:
        """Finish a span from :meth:`open_span`: stamp its duration and
        retain it as a root."""
        if span is _NULL_SPAN or not self.enabled:
            return
        span.dur = self._now() - span.t0
        self.spans.append(span)

    def clear(self) -> None:
        self.spans.clear()
        self._tls = threading.local()  # drops every thread's open stack

    # -- querying (tests assert on these) -----------------------------------
    def find(self, name: str) -> list:
        """All recorded spans/events named ``name``, across all roots."""
        out = []
        for s in self.spans:
            out.extend(s.find(name))
        return out

    def last(self, name: str) -> Optional[Span]:
        hits = self.find(name)
        return hits[-1] if hits else None

    # -- export -------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (loads in Perfetto / chrome://tracing)."""
        events = []

        def _emit(span: Span, tid: int):
            e = {
                "name": span.name,
                "cat": span.cat,
                "ts": span.t0 * 1e6,
                "pid": 1,
                "tid": tid,
                "args": _plain(span.attrs),
            }
            if span.instant:
                e.update(ph="i", s="t")
            else:
                e.update(ph="X", dur=span.dur * 1e6)
            events.append(e)
            for c in span.children:
                _emit(c, tid)

        for root in self.spans:
            _emit(root, tid=1)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"source": "repro_torch.obs"},
        }

    def save_chrome_trace(self, path: str) -> str:
        import os

        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
        return path

    def pretty(self) -> str:
        """Indented text rendering of every retained root span."""
        lines = []

        def _fmt_attrs(attrs: dict) -> str:
            if not attrs:
                return ""
            body = ", ".join(f"{k}={v}" for k, v in attrs.items())
            return f"  [{body}]"

        def _walk(span: Span, depth: int):
            pad = "  " * depth
            if span.instant:
                lines.append(f"{pad}* {span.name}{_fmt_attrs(span.attrs)}")
            else:
                lines.append(f"{pad}{span.name}: {span.dur * 1e3:.3f} ms"
                             f"{_fmt_attrs(span.attrs)}")
            for c in span.children:
                _walk(c, depth + 1)

        for root in self.spans:
            _walk(root, 0)
        return "\n".join(lines)


def _plain(attrs: dict) -> dict:
    """JSON-safe attribute dict (numpy scalars -> python, objects -> str)."""
    out = {}
    for k, v in attrs.items():
        if hasattr(v, "item") and callable(v.item) and getattr(v, "ndim", 1) == 0:
            v = v.item()
        if not isinstance(v, (int, float, str, bool, type(None))):
            v = str(v)
        out[k] = v
    return out
