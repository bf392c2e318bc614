"""Request-scoped span tracing for the port (a copy of
juicefs_tpu/metric/trace.py).

`span()` returns a shared no-op while no reader is attached, a timing-only
shim when the call site binds a stage histogram, and a full span (emitted
as one JSON line to every open reader) otherwise. The always-on rollup is
`juicefs_torch_stage_seconds{layer,op,stage}` in the port's registry, the
per-stage attribution that chip_smoke.py prints.

Profiler ranges: while a `torch.profiler` runs in the process, every span
also opens a profiler range named `layer.op.stage` (`layer.op` with no
stage), so the profiler stamps the program's stages on the same clock as
the card's kernels and copies, on whichever thread opened them (a
`cpu_op` event in its trace). A profiler that records card activity
alone installs no host callback, and the range then records nothing. The
range is the profiler's `_RecordFunctionFast` (~1.4 us under a profiler
recording host ops), not `torch.profiler.record_function` (~15 us): that
one enters through the op dispatcher, which drops the interpreter lock at
each edge, and with ten fetch threads opening ranges it nearly doubled a
scan's time. With no profiler running, `span()` returns exactly what it
returns without ranges, and torch is never imported here.

Cross-thread propagation: span context rides a per-thread stack, so the
synchronous read path links automatically; pool crossings (upload pool,
download fan-out) capture `current_ref()` at submit time and pass it as
`parent=`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import sys
import threading
import time
from collections import deque
from typing import Optional

from . import global_registry

__all__ = ["NULL_SPAN", "Tracer", "global_tracer", "stage_hist",
           "stage_metrics_snapshot"]

MAX_BUFFERED_EVENTS = 10240

_STAGE_SECONDS = global_registry().histogram(
    "juicefs_torch_stage_seconds",
    "Per-stage operation latency across layers of the PyTorch port",
    ("layer", "op", "stage"),
)


def stage_hist(layer: str, op: str, stage: str = "total"):
    """Pre-resolve one (layer, op, stage) histogram child for hot paths
    (labels() does a locked dict lookup; call sites bind once)."""
    return _STAGE_SECONDS.labels(layer, op, stage)


def stage_metrics_snapshot() -> dict:
    """Compact {layer.op.stage: {count, sum_seconds}} dump of the stage
    rollup (chip_smoke.py prints it). The object layer's
    per-backend request histogram is folded in as object.<method>.<backend>,
    and the VFS ops' latency histogram as vfs.<method>, so the snapshot
    attributes every stage without double-observing on either hot path."""
    out = {}

    def collect(hist, keyfn):
        with hist._lock:
            children = list(hist._children.values())
        for c in children:
            out[keyfn(c._label_dict())] = {
                "count": c.total, "sum_seconds": round(c.sum, 6),
            }

    collect(_STAGE_SECONDS,
            lambda l: f"{l.get('layer')}.{l.get('op')}.{l.get('stage')}")
    metrics = global_registry()._metrics
    obj = metrics.get("juicefs_object_request_durations_histogram_seconds")
    if obj is not None:
        collect(obj,
                lambda l: f"object.{l.get('method', '?').lower()}"
                          f".{l.get('backend', '?')}")
    # the VFS op wrapper's latency histogram, as vfs.<method>: the name of
    # the profiler range the wrapper opens around the same op
    ops = metrics.get("juicefs_fuse_ops_durations_histogram_seconds")
    if ops is not None:
        collect(ops, lambda l: f"vfs.{l.get('method', '?')}")
    return out


class _NullSpan:
    """Shared no-op span: the zero-cost path when no consumer is attached
    and the call site carries no stage histogram."""

    __slots__ = ()
    active = False

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def set(self, **kw) -> None:
        pass

    def ref(self) -> None:
        return None


NULL_SPAN = _NullSpan()


class _CarriedRef:
    """Stack marker adopting a foreign (trace_id, span_id) as parent
    (Tracer.carried); never emitted, only resolved against."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, ref: tuple[int, int]):
        self.trace_id, self.span_id = ref


class _TimedSpan:
    """No consumer attached but a stage histogram bound: time the region
    and observe — nothing else (the <5% no-reader overhead budget)."""

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

    def ref(self) -> None:
        return None


def _profiling() -> bool:
    """True while a torch profiler runs in this process; a process that has
    not imported torch's profiler runs none."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _RangedSpan:
    """A span (any of the three above) inside a profiler range; only made
    while a torch profiler runs (`_profiling()`)."""

    __slots__ = ("inner", "_range")

    def __init__(self, inner, name: str):
        from torch._C._profiler import _RecordFunctionFast

        self.inner = inner
        self._range = _RecordFunctionFast(name)

    @property
    def active(self) -> bool:
        return self.inner.active

    def __enter__(self):
        self._range.__enter__()
        return self.inner.__enter__()

    def __exit__(self, et, ev, tb):
        try:
            return self.inner.__exit__(et, ev, tb)
        finally:
            self._range.__exit__(et, ev, tb)

    def set(self, **kw) -> None:
        self.inner.set(**kw)

    def ref(self):
        return self.inner.ref()


class Span:
    """One traced region; emitted as a JSON event line on exit."""

    __slots__ = ("tracer", "layer", "op", "stage", "hist", "attrs",
                 "trace_id", "span_id", "parent_id", "_t0", "_ts")
    active = True

    def __init__(self, tracer: "Tracer", layer: str, op: str, stage: str,
                 hist, parent, attrs: dict):
        self.tracer = tracer
        self.layer = layer
        self.op = op
        self.stage = stage
        self.hist = hist
        self.attrs = attrs
        if parent is not None:  # explicit (trace_id, span_id) ref
            self.trace_id, self.parent_id = parent
        else:
            self.trace_id = self.parent_id = -1  # resolve from stack on enter

    def __enter__(self):
        tr = self.tracer
        self.span_id = next(tr._ids)
        stack = tr._local.__dict__.setdefault("stack", [])
        if self.parent_id < 0:
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
        if et is not None and "errno" not in self.attrs:
            self.attrs["error"] = et.__name__
        self.tracer._emit(self, dur)
        return False

    def set(self, **kw) -> None:
        self.attrs.update(kw)

    def ref(self) -> tuple[int, int]:
        return (self.trace_id, self.span_id)


class Tracer:
    """Global span hub; reader bookkeeping mirrors AccessLogger."""

    def __init__(self):
        self._lock = threading.Lock()
        self._readers: dict[int, deque[bytes]] = {}
        self._active = False
        self._local = threading.local()
        self._ids = itertools.count(1)

    @property
    def active(self) -> bool:
        return self._active

    # -- span construction -------------------------------------------------
    def span(self, layer: str, op: str, stage: str = "", hist=None,
             parent: Optional[tuple[int, int]] = None, **attrs):
        if not self._active:
            sp = _TimedSpan(hist) if hist is not None else NULL_SPAN
        else:
            sp = Span(self, layer, op, stage, hist, parent, attrs)
        if _profiling():
            return _RangedSpan(sp, f"{layer}.{op}.{stage}" if stage
                               else f"{layer}.{op}")
        return sp

    def current_ref(self) -> Optional[tuple[int, int]]:
        """(trace_id, span_id) of the innermost open span on this thread,
        for crossing into worker pools; None when inactive/no span."""
        stack = self._local.__dict__.get("stack")
        if stack:
            top = stack[-1]
            return (top.trace_id, top.span_id)
        return None

    @contextlib.contextmanager
    def carried(self, ref: Optional[tuple[int, int]]):
        """Adopt a captured (trace_id, span_id) as this thread's current
        parent — the pool-crossing adapter for code that opens spans
        *internally* (the metered object wrapper under the resilience
        layer's worker pool).  Emits nothing itself; spans opened inside
        resolve their parent from the carried marker."""
        if ref is None or not self._active:
            yield
            return
        stack = self._local.__dict__.setdefault("stack", [])
        marker = _CarriedRef(ref)
        stack.append(marker)
        try:
            yield
        finally:
            if stack and stack[-1] is marker:
                stack.pop()
            elif marker in stack:  # unbalanced inner exits: drop self only
                stack.remove(marker)

    # -- event stream ------------------------------------------------------
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

    # -- reader lifecycle (one ring buffer per .trace open) ----------------
    def open_reader(self, fh: int) -> None:
        with self._lock:
            self._readers[fh] = deque(maxlen=MAX_BUFFERED_EVENTS)
            self._active = True

    def close_reader(self, fh: int) -> None:
        with self._lock:
            self._readers.pop(fh, None)
            self._active = bool(self._readers)

    def read(self, fh: int, max_bytes: int = 1 << 16) -> bytes:
        """Drain buffered events for one reader (blocking up to 1s so
        `tail -f` style consumers don't spin; same shape as accesslog)."""
        deadline = time.time() + 1.0
        while True:
            with self._lock:
                buf = self._readers.get(fh)
                if buf is None:
                    return b""
                out = bytearray()
                while buf:
                    line = buf[0]
                    if len(out) + len(line) > max_bytes:
                        if not out:  # a single oversized line: split it
                            out += line[:max_bytes]
                            buf[0] = line[max_bytes:]
                        break
                    out += buf.popleft()
            if out or time.time() >= deadline:
                return bytes(out)
            time.sleep(0.02)


_tracer = Tracer()


def global_tracer() -> Tracer:
    return _tracer
