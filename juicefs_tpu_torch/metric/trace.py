"""Span tracing for the port: a copy of the part of juicefs_tpu/metric/trace.py
that the hash pipeline uses.

`span()` returns a shared no-op while no reader is attached, a timing-only
shim when the call site binds a stage histogram, and a full span (emitted
as one JSON line to every open reader) otherwise. The always-on rollup is
`juicefs_torch_stage_seconds{layer,op,stage}` in the port's registry.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque

from . import global_registry

__all__ = ["NULL_SPAN", "Tracer", "global_tracer", "stage_hist"]

MAX_BUFFERED_EVENTS = 10240

_STAGE_SECONDS = global_registry().histogram(
    "juicefs_torch_stage_seconds",
    "Per-stage operation latency across layers of the PyTorch port",
    ("layer", "op", "stage"),
)


def stage_hist(layer: str, op: str, stage: str = "total"):
    """Pre-resolve one (layer, op, stage) histogram child for hot paths."""
    return _STAGE_SECONDS.labels(layer, op, stage)


class _NullSpan:
    """Shared no-op span: no consumer attached, no stage histogram."""

    __slots__ = ()
    active = False

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def set(self, **kw) -> None:
        pass


NULL_SPAN = _NullSpan()


class _TimedSpan:
    """No consumer attached but a stage histogram bound: time and observe."""

    __slots__ = ("_hist", "_t0")
    active = False

    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self._hist.observe(time.perf_counter() - self._t0)
        return False

    def set(self, **kw) -> None:
        pass


class Span:
    """One traced region; emitted as a JSON event line on exit."""

    __slots__ = ("tracer", "layer", "op", "stage", "hist", "attrs",
                 "trace_id", "span_id", "parent_id", "_t0", "_ts")
    active = True

    def __init__(self, tracer: "Tracer", layer: str, op: str, stage: str,
                 hist, attrs: dict):
        self.tracer = tracer
        self.layer = layer
        self.op = op
        self.stage = stage
        self.hist = hist
        self.attrs = attrs

    def __enter__(self):
        tr = self.tracer
        self.span_id = next(tr._ids)
        stack = tr._local.__dict__.setdefault("stack", [])
        if stack:
            top = stack[-1]
            self.trace_id, self.parent_id = top.trace_id, top.span_id
        else:  # root: the trace is named after its root span
            self.trace_id, self.parent_id = self.span_id, 0
        stack.append(self)
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        dur = time.perf_counter() - self._t0
        if self.hist is not None:
            self.hist.observe(dur)
        stack = self.tracer._local.__dict__.get("stack")
        if stack:
            if stack[-1] is self:
                stack.pop()
            elif self in stack:  # unbalanced exit: drop self only
                stack.remove(self)
        if et is not None:
            self.attrs["error"] = et.__name__
        self.tracer._emit(self, dur)
        return False

    def set(self, **kw) -> None:
        self.attrs.update(kw)


class Tracer:
    """Span hub: events reach every open reader's ring buffer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._readers: dict[int, deque[bytes]] = {}
        self._active = False
        self._local = threading.local()
        self._ids = itertools.count(1)

    @property
    def active(self) -> bool:
        return self._active

    def span(self, layer: str, op: str, stage: str = "", hist=None, **attrs):
        if not self._active:
            return _TimedSpan(hist) if hist is not None else NULL_SPAN
        return Span(self, layer, op, stage, hist, attrs)

    def _emit(self, span: Span, dur: float) -> None:
        ev = {
            "ts": round(span._ts, 6),
            "dur": round(dur, 6),
            "trace": span.trace_id,
            "id": span.span_id,
            "parent": span.parent_id,
            "layer": span.layer,
            "op": span.op,
        }
        if span.stage:
            ev["stage"] = span.stage
        if span.attrs:
            ev.update(span.attrs)
        try:
            line = (json.dumps(ev, default=str) + "\n").encode()
        except (TypeError, ValueError):
            return  # a bad attr must never break the traced operation
        with self._lock:
            for buf in self._readers.values():
                buf.append(line)

    def open_reader(self, fh: int) -> None:
        with self._lock:
            self._readers[fh] = deque(maxlen=MAX_BUFFERED_EVENTS)
            self._active = True

    def close_reader(self, fh: int) -> None:
        with self._lock:
            self._readers.pop(fh, None)
            self._active = bool(self._readers)

    def drain(self, fh: int) -> list[dict]:
        """Every buffered event of one reader, oldest first."""
        with self._lock:
            buf = self._readers.get(fh)
            lines = list(buf) if buf else []
            if buf:
                buf.clear()
        return [json.loads(line) for line in lines]


_tracer = Tracer()


def global_tracer() -> Tracer:
    return _tracer
