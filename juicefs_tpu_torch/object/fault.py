"""Fault-injection ObjectStorage wrapper (a copy of juicefs_tpu/object/
fault.py).

The reference leans on external chaos tooling (chaos.yml workflows); this
wrapper makes failure drills first-class and hermetic: wrap any store
with configurable error rates, added latency, short reads, hangs (ops
that never return) and throttle responses, then run real workloads
through it and assert the recovery invariants (upload retry/backoff,
deadline abandonment, breaker trips, writeback staging replay, sync
convergence, no torn blocks). Deterministic given a seed, so failures
reproduce.

Wrap programmatically:

    store = FaultyStore(inner, error_rate=0.3, seed=7)
    ...
    store.fault_config(error_rate=0.0)   # heal mid-test
    store.counters                       # injected-fault accounting

Scripted timelines (deterministic outage → heal drills for the
deadline / breaker / half-open-probe invariants):

    store.fault_schedule([
        (0.5, dict(error_rate=1.0)),     # 0.5s of total outage...
        (None, dict(error_rate=0.0)),    # ...then healed forever
    ])
"""

from __future__ import annotations

import random
import threading
import time
from typing import Iterator, Optional, Sequence

from .interface import Obj, ObjectStorage, ThrottleError


class InjectedFault(IOError):
    """Deliberate failure from FaultyStore (distinct from real errors)."""


class InjectedThrottle(InjectedFault, ThrottleError):
    """Deliberate throttle response — classified THROTTLE by the
    resilience layer (longer backoff + concurrency shed)."""


class FaultyStore(ObjectStorage):
    """Decorator injecting failures into an inner store.

    error_rate    probability [0,1] that a mutating/reading op raises
    get_error_rate / put_error_rate   per-op overrides (None = error_rate)
    latency       seconds added to every op (simulates a slow backend)
    short_reads   probability that get() returns a truncated payload
    throttle_rate probability that an op raises InjectedThrottle
    hang_rate     probability that an op blocks for hang_seconds (a hung
                  backend call; healing releases current hangers early)
    hang_seconds  how long a hung op blocks (default: effectively forever
                  at drill scale — only deadline abandonment rescues it)
    """

    _KEEP = object()  # fault_config sentinel: leave the setting unchanged

    def __init__(self, store: ObjectStorage, error_rate: float = 0.0,
                 get_error_rate: float | None = None,
                 put_error_rate: float | None = None,
                 latency: float = 0.0, short_reads: float = 0.0,
                 throttle_rate: float = 0.0,
                 hang_rate: float = 0.0, hang_seconds: float = 300.0,
                 seed: int = 0):
        self._s = store
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self.counters = {"errors": 0, "short_reads": 0, "delayed": 0,
                         "throttles": 0, "hangs": 0}
        self.error_rate = error_rate
        self.get_error_rate = get_error_rate
        self.put_error_rate = put_error_rate
        self.latency = latency
        self.short_reads = short_reads
        self.throttle_rate = throttle_rate
        self.hang_rate = hang_rate
        self.hang_seconds = hang_seconds
        self._hang_release = threading.Event()
        self._schedule: Optional[list[tuple[Optional[float], dict]]] = None
        self._schedule_t0 = 0.0
        self._schedule_phase = -1

    def fault_config(self, error_rate=_KEEP, get_error_rate=_KEEP,
                     put_error_rate=_KEEP, latency=_KEEP,
                     short_reads=_KEEP, throttle_rate=_KEEP,
                     hang_rate=_KEEP, hang_seconds=_KEEP) -> None:
        """Reconfigure live (drills heal or worsen the store mid-run).
        Unspecified settings KEEP their current values — a partial call
        never silently resets the rest of the fault profile."""
        if error_rate is not self._KEEP:
            self.error_rate = error_rate
        if get_error_rate is not self._KEEP:
            self.get_error_rate = get_error_rate
        if put_error_rate is not self._KEEP:
            self.put_error_rate = put_error_rate
        if latency is not self._KEEP:
            self.latency = latency
        if short_reads is not self._KEEP:
            self.short_reads = short_reads
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
        """Apply a timeline of fault profiles: each (duration, config)
        phase holds for `duration` seconds; a None duration (typically the
        last phase) holds forever. Phase configs are fault_config kwargs.
        The clock starts NOW; every op evaluates the timeline before its
        fault roll, so outage→heal sequences are reproducible without a
        driver thread."""
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
            # phases only ADVANCE: a preempted thread that computed an
            # older phase must not re-apply an outage a newer thread
            # already healed (the drills' determinism depends on it)
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
                raise InjectedFault(f"injected {op} hang (released)")
        if self.throttle_rate > 0:
            with self._mu:
                throttled = self._rng.random() < self.throttle_rate
                if throttled:
                    self.counters["throttles"] += 1
            if throttled:
                raise InjectedThrottle(f"injected {op} throttle")
        r = self.error_rate if rate is None else rate
        if r > 0:
            with self._mu:
                hit = self._rng.random() < r
                if hit:
                    self.counters["errors"] += 1
            if hit:
                raise InjectedFault(f"injected {op} failure")

    # -- ObjectStorage ------------------------------------------------------
    def string(self) -> str:
        return "faulty+" + self._s.string()

    def create(self) -> None:
        self._s.create()

    def get(self, key, off=0, limit=-1):
        self._maybe_fail("GET", self.get_error_rate)
        data = self._s.get(key, off, limit)
        if self.short_reads > 0 and len(data) > 1:
            with self._mu:
                short = self._rng.random() < self.short_reads
                if short:
                    self.counters["short_reads"] += 1
                    n = self._rng.randrange(1, len(data))
            if short:
                return data[:n]
        return data

    def put(self, key, data):
        self._maybe_fail("PUT", self.put_error_rate)
        self._s.put(key, data)

    def delete(self, key):
        self._maybe_fail("DELETE", None)
        self._s.delete(key)

    def head(self, key) -> Obj:
        self._maybe_fail("HEAD", self.get_error_rate)
        return self._s.head(key)

    def copy(self, dst, src):
        self._maybe_fail("COPY", None)
        self._s.copy(dst, src)

    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        self._maybe_fail("LIST", self.get_error_rate)
        return self._s.list_all(prefix, marker)

    def list(self, prefix="", marker="", limit=1000):
        self._maybe_fail("LIST", self.get_error_rate)
        return self._s.list(prefix, marker, limit)

    def create_multipart_upload(self, key):
        self._maybe_fail("MPU-CREATE", self.put_error_rate)
        return self._s.create_multipart_upload(key)

    def upload_part(self, key, upload_id, num, data):
        self._maybe_fail("MPU-PART", self.put_error_rate)
        return self._s.upload_part(key, upload_id, num, data)

    def complete_upload(self, key, upload_id, parts):
        self._maybe_fail("MPU-COMPLETE", self.put_error_rate)
        self._s.complete_upload(key, upload_id, parts)

    def abort_upload(self, key, upload_id):
        self._s.abort_upload(key, upload_id)  # aborts never fail: cleanup

    def limits(self) -> dict:
        return self._s.limits()
