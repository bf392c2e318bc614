"""Fault-injection wrapper for the meta engine seam (a copy of
juicefs_tpu/meta/fault.py).

The meta twin of ``object/fault.py``: installs configurable failure
injection over a live meta instance's engine ``do_*`` ops (the exact
seam ``meta/resilient.py`` guards), so the fault contract is
chaos-drilled hermetically — error rates, hangs that only deadline
abandonment rescues, throttle (BUSY) responses, added latency, and
scripted ``fault_schedule`` outage→heal timelines.  Deterministic given
a seed, so failures reproduce.

Install ORDER matters and mirrors the real stack: faults sit BELOW the
guard, so install the injector first, then configure resilience —
``configure_meta_retries`` wraps whatever ``do_*`` it finds, faulty
included::

    m = new_client("memkv://"); m.init(fmt); m.load()
    fm = FaultyMeta(m)                      # faults below...
    m.configure_meta_retries(max_attempts=4)  # ...the guard above
    fm.fault_schedule([(0.5, dict(error_rate=1.0)),
                       (None, dict(error_rate=0.0))])

Injected failures are classified by the resilience layer exactly like
their production counterparts: :class:`InjectedMetaFault` is a
``ConnectionError`` (TRANSIENT), :class:`InjectedMetaThrottle` a
:class:`~juicefs_tpu_torch.meta.resilient.MetaBusyError` (BUSY).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional, Sequence

from ..utils import get_logger
from .resilient import GUARDED_READS, GUARDED_WRITES, MetaBusyError

logger = get_logger("meta.fault")


class InjectedMetaFault(ConnectionError):
    """Deliberate failure from FaultyMeta (classified TRANSIENT —
    distinct from real engine errors)."""


class InjectedMetaThrottle(MetaBusyError, InjectedMetaFault):
    """Deliberate BUSY response — retried from the higher backoff
    floor, breaker-neutral (the engine answered)."""


class FaultyMeta:
    """Decorator injecting failures into a meta instance's engine ops.

    error_rate     probability [0,1] that a guarded engine op raises
    read_error_rate / write_error_rate   per-side overrides (None =
                   error_rate; reads are the GUARDED_READS set)
    latency        seconds added to every engine op
    throttle_rate  probability that an op raises InjectedMetaThrottle
    hang_rate      probability that an op blocks for hang_seconds (a
                   hung engine call; healing releases current hangers)
    hang_seconds   how long a hung op blocks (default: effectively
                   forever at drill scale — only abandonment rescues it)
    """

    _KEEP = object()

    def __init__(self, meta, error_rate: float = 0.0,
                 read_error_rate: float | None = None,
                 write_error_rate: float | None = None,
                 latency: float = 0.0, throttle_rate: float = 0.0,
                 hang_rate: float = 0.0, hang_seconds: float = 300.0,
                 seed: int = 0):
        self.meta = meta
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self.counters = {"errors": 0, "delayed": 0, "throttles": 0,
                         "hangs": 0}
        self.error_rate = error_rate
        self.read_error_rate = read_error_rate
        self.write_error_rate = write_error_rate
        self.latency = latency
        self.throttle_rate = throttle_rate
        self.hang_rate = hang_rate
        self.hang_seconds = hang_seconds
        self._hang_release = threading.Event()
        self._schedule: Optional[list[tuple[Optional[float], dict]]] = None
        self._schedule_t0 = 0.0
        self._schedule_phase = -1
        self._raw = {}
        for name in GUARDED_READS + GUARDED_WRITES:
            fn = getattr(meta, name, None)
            if fn is None:
                continue
            self._raw[name] = fn
            setattr(meta, name, self._wrap(name, fn, name in GUARDED_READS))

    def _wrap(self, name: str, fn, is_read: bool):
        def faulty(*a, **kw):
            self._maybe_fail(
                name,
                self.read_error_rate if is_read else self.write_error_rate)
            return fn(*a, **kw)

        faulty.__name__ = f"faulty_{name}"
        faulty.__wrapped__ = fn
        return faulty

    def uninstall(self) -> None:
        """Restore the raw engine methods (drills that hand the meta on)."""
        for name, fn in self._raw.items():
            setattr(self.meta, name, fn)

    def fault_config(self, error_rate=_KEEP, read_error_rate=_KEEP,
                     write_error_rate=_KEEP, latency=_KEEP,
                     throttle_rate=_KEEP, hang_rate=_KEEP,
                     hang_seconds=_KEEP) -> None:
        """Reconfigure live (drills heal or worsen mid-run); unspecified
        settings KEEP their current values."""
        if error_rate is not self._KEEP:
            self.error_rate = error_rate
        if read_error_rate is not self._KEEP:
            self.read_error_rate = read_error_rate
        if write_error_rate is not self._KEEP:
            self.write_error_rate = write_error_rate
        if latency is not self._KEEP:
            self.latency = latency
        if throttle_rate is not self._KEEP:
            self.throttle_rate = throttle_rate
        if hang_seconds is not self._KEEP:
            self.hang_seconds = hang_seconds
        if hang_rate is not self._KEEP:
            self.hang_rate = hang_rate
            # healing (or re-arming) a hang profile releases everything
            # currently stuck — drills must not wait out stale hangs
            self._hang_release.set()
            self._hang_release = threading.Event()

    # -- scripted fault timelines ------------------------------------------
    def fault_schedule(
        self, phases: Sequence[tuple[Optional[float], dict]]
    ) -> None:
        """Timeline of fault profiles: each (duration, config) phase
        holds for `duration` seconds; a None duration holds forever.
        Every op evaluates the timeline before its fault roll, so
        outage→heal sequences reproduce without a driver thread."""
        self._schedule = [(d, dict(cfg)) for d, cfg in phases]
        self._schedule_t0 = time.monotonic()
        self._schedule_phase = -1
        self._tick_schedule()

    def _tick_schedule(self) -> None:
        sched = self._schedule
        if sched is None:
            return
        elapsed = time.monotonic() - self._schedule_t0
        idx, acc = len(sched) - 1, 0.0
        for i, (dur, _cfg) in enumerate(sched):
            if dur is None or elapsed < acc + dur:
                idx = i
                break
            acc += dur
        with self._mu:
            # phases only ADVANCE (a preempted thread must not re-apply
            # an outage a newer thread already healed)
            if idx <= self._schedule_phase:
                return
            self._schedule_phase = idx
        self.fault_config(**sched[idx][1])

    # -- fault engine -------------------------------------------------------
    def _maybe_fail(self, op: str, rate: float | None) -> None:
        self._tick_schedule()
        if self.latency > 0:
            with self._mu:
                self.counters["delayed"] += 1
            time.sleep(self.latency)
        if self.hang_rate > 0:
            with self._mu:
                hang = self._rng.random() < self.hang_rate
                if hang:
                    self.counters["hangs"] += 1
                release = self._hang_release
            if hang:
                release.wait(self.hang_seconds)
                raise InjectedMetaFault(f"injected meta {op} hang (released)")
        if self.throttle_rate > 0:
            with self._mu:
                throttled = self._rng.random() < self.throttle_rate
                if throttled:
                    self.counters["throttles"] += 1
            if throttled:
                raise InjectedMetaThrottle(f"injected meta {op} throttle")
        r = self.error_rate if rate is None else rate
        if r > 0:
            with self._mu:
                hit = self._rng.random() < r
                if hit:
                    self.counters["errors"] += 1
            if hit:
                raise InjectedMetaFault(f"injected meta {op} failure")
