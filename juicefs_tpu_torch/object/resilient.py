"""Unified object-plane resilience layer (a copy of
juicefs_tpu/object/resilient.py).

Every storage consumer used to improvise fault handling — one blind retry
loop in the chunk store, nothing anywhere else.  This wrapper centralizes
the contract (reference cached_store.go:394-410, generalized along Dean &
Barroso "The Tail at Scale"):

  classification   PERMANENT errors (NotFound, auth/4xx analogs) are never
                   retried; TRANSIENT errors get jittered exponential
                   backoff; THROTTLE errors (429/503 analogs) back off from
                   a higher floor AND halve the concurrency shed limit.
  deadlines        a `RetryPolicy(deadline, max_attempts, base, cap,
                   jitter)` budget per op.  Attempts run on an elastic
                   daemon pool and are ABANDONED at their bound — a hung
                   backend can never pin an upload/download pool worker.
  circuit breaker  per-backend closed → open on failure rate over a
                   sliding window; half-open via background probes;
                   `juicefs_object_breaker_state` gauge + trip/reset
                   counters; consumers read `.degraded` to enter the
                   degradation ladder (chunk/cached_store.py).
  hedged GETs      when a GET outlives the live p95 of the per-backend GET
                   latency histogram, a second GET is issued and the first
                   response wins — brownout tail latency is bounded by the
                   healthy-percentile, not the sick tail.

Composes with the other decorators: resilient(metered(inner)) is the
canonical stack (per-attempt metering below, policy above), and the
fault/prefix/sharding wrappers slot below unchanged.  Wrapping is
idempotent.
"""

from __future__ import annotations

import errno as _errno
import queue
import random
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future
from concurrent.futures import TimeoutError as _FutTimeout
from concurrent.futures import wait as _fut_wait
from dataclasses import dataclass
from enum import Enum, IntEnum
from typing import Callable, Optional

from ..metric import global_registry
from ..metric.trace import global_tracer
from ..qos import context as _qctx
from ..utils import get_logger
from .interface import NotFoundError, ObjectStorage, PermanentError, ThrottleError

logger = get_logger("object.resilient")
_TR = global_tracer()
_reg = global_registry()

_RETRIES = _reg.counter(
    "juicefs_object_request_retries",
    "Object requests retried after a transient failure",
    ("method",),
)
_RETRIES_CLASS = _reg.counter(
    "juicefs_object_retries_by_class",
    "Object request retries split by error class (transient vs throttle)",
    ("class",),
)
_ABANDONED = _reg.counter(
    "juicefs_object_deadline_abandoned",
    "Object requests abandoned at their deadline (hung backend call)",
    ("method",),
)
_HEDGES = _reg.counter(
    "juicefs_object_hedged_requests",
    "Secondary GETs issued after the hedge delay",
    ("backend",),
)
_HEDGE_WINS = _reg.counter(
    "juicefs_object_hedge_wins",
    "Hedged GETs where the secondary request answered first",
    ("backend",),
)
_BREAKER_STATE = _reg.gauge(
    "juicefs_object_breaker_state",
    "Circuit breaker state per backend (0=closed, 1=open, 2=half-open)",
    ("backend",),
)
_BREAKER_TRIPS = _reg.counter(
    "juicefs_object_breaker_trips",
    "Circuit breaker transitions into the open state",
    ("backend",),
)
_BREAKER_RESETS = _reg.counter(
    "juicefs_object_breaker_resets",
    "Circuit breaker recoveries back to the closed state",
    ("backend",),
)
_SHED_LIMIT = _reg.gauge(
    "juicefs_object_shed_limit",
    "Current concurrency limit of the throttle shed per backend",
    ("backend",),
)


class ErrorClass(Enum):
    PERMANENT = "permanent"
    TRANSIENT = "transient"
    THROTTLE = "throttle"


class DeadlineExceeded(OSError):
    """An op (or attempt) outlived its deadline budget."""

    def __init__(self, msg: str):
        super().__init__(_errno.ETIMEDOUT, msg)


class BreakerOpenError(OSError):
    """Fail-fast: the backend's circuit breaker is open.  An OSError with
    EIO so cache misses surface the ladder's bottom rung to POSIX callers
    without any extra mapping."""

    def __init__(self, backend: str):
        super().__init__(_errno.EIO, f"object backend {backend}: circuit open")


# status codes a driver may attach to a generic error (`exc.status`)
_THROTTLE_STATUS = frozenset({429, 503})
_RETRYABLE_4XX = frozenset({408, 416, 429})


def classify(exc: BaseException) -> ErrorClass:
    """Map an exception to its retry class (the ladder's first rung)."""
    if isinstance(exc, (NotFoundError, PermanentError)):
        return ErrorClass.PERMANENT
    if isinstance(exc, ThrottleError):
        return ErrorClass.THROTTLE
    status = getattr(exc, "status", None)
    if isinstance(status, int):
        if status in _THROTTLE_STATUS:
            return ErrorClass.THROTTLE
        if 400 <= status < 500 and status not in _RETRYABLE_4XX:
            return ErrorClass.PERMANENT
    return ErrorClass.TRANSIENT


def record_retry(method: str, eclass: ErrorClass) -> None:
    """Shared retry accounting — used here and by the chunk layer's
    torn-response loop so every retry lands in the same counters."""
    _RETRIES.labels(method).inc()
    _RETRIES_CLASS.labels(eclass.value).inc()


@dataclass
class RetryPolicy:
    """Per-op retry/deadline budget (reference cached_store.go:394-410,
    now with a wall-clock bound).  `deadline` caps the whole op;
    `attempt_timeout` (default: remaining deadline) bounds each attempt —
    a hung call is abandoned at that bound and the budget decides whether
    to retry."""

    deadline: float = 60.0
    max_attempts: int = 10
    base: float = 0.01
    cap: float = 3.0
    jitter: float = 0.2
    throttle_base: float = 0.25  # throttled backends asked for less traffic
    throttle_cap: float = 10.0
    attempt_timeout: Optional[float] = None

    def backoff(self, attempt: int, eclass: ErrorClass,
                rng: Callable[[], float] = random.random) -> float:
        """Jittered exponential backoff; THROTTLE starts higher and caps
        higher than TRANSIENT by construction."""
        if eclass is ErrorClass.THROTTLE:
            b = min(self.throttle_cap, self.throttle_base * (2.0 ** attempt))
        else:
            b = min(self.cap, self.base * (2.0 ** attempt))
        return b * (1.0 + self.jitter * rng())


class BreakerState(IntEnum):
    CLOSED = 0
    OPEN = 1
    HALF_OPEN = 2


# live metric-label registry: two stores over the same scheme (e.g.
# `sync s3://a s3://b`) must not write the same breaker/shed series —
# the second claimant gets "s3#2" until the first releases on close()
_label_lock = threading.Lock()
_live_labels: set[str] = set()


def _claim_label(base: str) -> str:
    with _label_lock:
        label, k = base, 2
        while label in _live_labels:
            label = f"{base}#{k}"
            k += 1
        _live_labels.add(label)
        return label


def _release_label(label: str) -> None:
    with _label_lock:
        _live_labels.discard(label)


class CircuitBreaker:
    """Per-backend failure-rate breaker with half-open background probes.

    CLOSED: outcomes recorded into a sliding window; failure rate >=
    `threshold` over >= `min_samples` trips to OPEN.  OPEN: `allow()` is
    False (callers fail fast with BreakerOpenError) and a daemon probe
    thread tests the backend every `probe_interval`.  A probe success
    moves to HALF_OPEN; `half_open_successes` consecutive successes
    (probes or real traffic) close it; any failure re-trips.  Reset fires
    the `on_reset` callbacks — the chunk store replays writeback staging
    from there."""

    def __init__(self, backend: str = "store", window: float = 30.0,
                 threshold: float = 0.7, min_samples: int = 16,
                 probe_interval: float = 1.0,
                 probe: Optional[Callable[[], bool]] = None,
                 half_open_successes: int = 2):
        self.backend = _claim_label(backend)
        self.window = window
        self.threshold = threshold
        self.min_samples = min_samples
        self.probe_interval = probe_interval
        self.probe = probe
        self.half_open_successes = half_open_successes
        self._lock = threading.Lock()
        self._events: deque[tuple[float, bool]] = deque()
        self._state = BreakerState.CLOSED
        self._streak = 0  # consecutive successes while HALF_OPEN
        self._on_reset: list[Callable[[], None]] = []
        self._on_open: list[Callable[[], None]] = []
        self._closed_down = False  # owner shut us down (stop probing)
        self._probe_alive = False
        self._probe_wake = threading.Event()
        _BREAKER_STATE.labels(self.backend).set(0)

    # -- wiring ------------------------------------------------------------
    def on_reset(self, cb: Callable[[], None]) -> None:
        self._on_reset.append(cb)

    def on_open(self, cb: Callable[[], None]) -> None:
        self._on_open.append(cb)

    @property
    def state(self) -> BreakerState:
        return self._state

    def allow(self) -> bool:
        return self._state != BreakerState.OPEN

    # -- outcome recording -------------------------------------------------
    def _prune(self, now: float) -> None:
        while self._events and now - self._events[0][0] > self.window:
            self._events.popleft()

    def record_success(self) -> None:
        fire_reset = False
        with self._lock:
            now = time.monotonic()
            self._events.append((now, True))
            self._prune(now)
            if self._state == BreakerState.HALF_OPEN:
                self._streak += 1
                if self._streak >= self.half_open_successes:
                    fire_reset = self._reset_locked()
        if fire_reset:
            self._fire(self._on_reset)

    def record_failure(self) -> None:
        fire_open = False
        with self._lock:
            now = time.monotonic()
            self._events.append((now, False))
            self._prune(now)
            if self._state == BreakerState.HALF_OPEN:
                fire_open = self._trip_locked()
            elif self._state == BreakerState.CLOSED:
                total = len(self._events)
                fails = sum(1 for _, ok in self._events if not ok)
                if total >= self.min_samples and fails / total >= self.threshold:
                    fire_open = self._trip_locked()
        if fire_open:
            self._fire(self._on_open)

    # -- transitions (call with lock held; return True if callbacks due) ---
    def _trip_locked(self) -> bool:
        prior = self._state
        self._state = BreakerState.OPEN
        self._streak = 0
        _BREAKER_STATE.labels(self.backend).set(1)
        if prior != BreakerState.OPEN:
            _BREAKER_TRIPS.labels(self.backend).inc()
            logger.warning("breaker OPEN for backend %s", self.backend)
            self._start_probe_locked()
            return True
        return False

    def _reset_locked(self) -> bool:
        self._state = BreakerState.CLOSED
        self._streak = 0
        self._events.clear()  # a healed backend starts with a clean slate
        _BREAKER_STATE.labels(self.backend).set(0)
        _BREAKER_RESETS.labels(self.backend).inc()
        logger.warning("breaker CLOSED for backend %s", self.backend)
        return True

    def _fire(self, cbs: list[Callable[[], None]]) -> None:
        for cb in cbs:
            try:
                cb()
            except Exception:
                logger.exception("breaker callback failed")

    # -- half-open probing -------------------------------------------------
    def _start_probe_locked(self) -> None:
        # one prober per breaker, ever: a re-trip from HALF_OPEN must not
        # stack a second thread (k flapping cycles would otherwise probe
        # k× as often AND reach the half-open streak with simultaneous
        # probes instead of consecutive ones)
        if self.probe is None or self._probe_alive:
            return
        self._probe_alive = True
        t = threading.Thread(target=self._probe_loop, daemon=True,
                             name=f"breaker-probe-{self.backend}")
        self._probe_wake.clear()
        t.start()

    def _probe_loop(self) -> None:
        try:
            while True:
                self._probe_wake.wait(self.probe_interval)
                if self._closed_down or self._state == BreakerState.CLOSED:
                    return
                try:
                    ok = bool(self.probe())
                except Exception as e:
                    ok = False
                    logger.debug("%s: half-open probe raised: %s",
                                 self.backend, e)
                with self._lock:
                    if self._state == BreakerState.OPEN and ok:
                        self._state = BreakerState.HALF_OPEN
                        self._streak = 0
                        _BREAKER_STATE.labels(self.backend).set(2)
                        logger.info("breaker HALF_OPEN for backend %s",
                                    self.backend)
                if ok:
                    # a probe success counts toward closing (there may be
                    # no real traffic during an outage — recovery must not
                    # wait for it); record_success handles HALF_OPEN streaks
                    self.record_success()
                if self._state == BreakerState.CLOSED:
                    return
        finally:
            with self._lock:
                self._probe_alive = False
                # a re-trip may have raced our exit: cover the gap
                if (self._state == BreakerState.OPEN
                        and not self._closed_down):
                    self._start_probe_locked()

    def close(self) -> None:
        if not self._closed_down:
            self._closed_down = True
            _release_label(self.backend)
        self._probe_wake.set()

    def snapshot(self) -> dict:
        with self._lock:
            total = len(self._events)
            fails = sum(1 for _, ok in self._events if not ok)
        return {
            "state": self._state.name.lower(),
            "window_samples": total,
            "window_failure_rate": round(fails / total, 3) if total else 0.0,
            "threshold": self.threshold,
            "probe_interval": self.probe_interval,
        }


class _Shed:
    """AIMD concurrency shed: THROTTLE halves the in-flight limit, a
    success streak creeps it back up.  Backends that ask for less traffic
    get less traffic without any config."""

    def __init__(self, backend: str, max_limit: int = 64):
        self._cond = threading.Condition()
        self.backend = backend
        self.max_limit = max_limit
        self.limit = max_limit
        self.inflight = 0
        self._streak = 0
        _SHED_LIMIT.labels(backend).set(max_limit)

    def acquire(self, timeout: float) -> None:
        with self._cond:
            end = time.monotonic() + timeout
            while self.inflight >= self.limit:
                left = end - time.monotonic()
                if left <= 0:
                    raise DeadlineExceeded(
                        f"{self.backend}: shed wait exceeded deadline"
                    )
                self._cond.wait(left)
            self.inflight += 1

    def release(self) -> None:
        with self._cond:
            self.inflight -= 1
            self._cond.notify()

    def throttled(self) -> None:
        with self._cond:
            self.limit = max(1, self.limit // 2)
            self._streak = 0
            _SHED_LIMIT.labels(self.backend).set(self.limit)

    def succeeded(self) -> None:
        with self._cond:
            self._streak += 1
            if self._streak >= 10 and self.limit < self.max_limit:
                self.limit += 1
                self._streak = 0
                _SHED_LIMIT.labels(self.backend).set(self.limit)
                self._cond.notify()


_POOL_IDLE_TTL = 5.0
_STOP = object()


class _ElasticPool:
    """Daemon-thread pool whose workers may be ABANDONED mid-call.

    A bounded executor cannot abandon a hung worker — the thread is gone
    until the backend answers.  Here a hung call pins only its own daemon
    thread; the next submit spawns another worker unless one is
    GUARANTEED idle, and idle workers expire after a short TTL.  This is
    what makes the deadline contract real: `Future.result(timeout)`
    returning does not require the call to stop.

    The guarantee uses idle CREDITS (a semaphore), not a counter read:
    a worker advertises a credit before blocking on the queue, and a
    submit must consume a credit or spawn.  A bare "idle > 0" check
    would race the worker's own decrement and could strand a queued task
    behind a busy (possibly hung) worker — exactly the task (a hedge or
    retry leg) that was meant to rescue the hang."""

    def __init__(self, name: str = "objio"):
        self._name = name
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._credits = threading.Semaphore(0)  # workers parked in get()
        self._seq = 0
        self._closed = False

    def submit(self, fn: Callable[[], object]) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("resilience pool is closed")
            self._q.put((fut, fn))
            if not self._credits.acquire(blocking=False):
                # no worker is provably waiting: spawn one.  Its first
                # queue pass consumes THIS item creditlessly (see
                # _worker), keeping credits == parked workers.
                self._seq += 1
                threading.Thread(
                    target=self._worker, daemon=True, args=(True,),
                    name=f"{self._name}-{self._seq}",
                ).start()
        return fut

    def _worker(self, claimed_first: bool = False) -> None:
        while True:
            if not claimed_first:
                self._credits.release()  # advertise: parked and claimable
            claimed_first = False
            try:
                item = self._q.get(timeout=_POOL_IDLE_TTL)
            except queue.Empty:
                # retract the advertisement; if it is already consumed, a
                # submit just queued (or is queueing) a task against it —
                # this worker MUST serve it before exiting
                if self._credits.acquire(blocking=False):
                    return
                try:
                    item = self._q.get(timeout=1.0)
                except queue.Empty:  # pragma: no cover — submitter died
                    return           # between acquire and put
            if self._closed or item is _STOP:
                return
            fut, fn = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — future carries it
                fut.set_exception(e)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # wake every parked worker (each consumed _STOP pairs with the
        # credit we just drained; post-close credit drift is harmless)
        while self._credits.acquire(blocking=False):
            self._q.put(_STOP)


_HIST_NAME = "juicefs_object_request_durations_histogram_seconds"
_HEDGE_MIN_SAMPLES = 64
_HEDGE_DEFAULT = 0.25
_HEDGE_FLOOR, _HEDGE_CEIL = 0.01, 2.0
_PROBE_KEY = ".jfs-breaker-probe"


def _hist_quantile(hist, q: float) -> Optional[float]:
    """Approximate quantile from a registry histogram's bucket counts
    (upper bound of the bucket where the cumulative count crosses q)."""
    with hist._lock:
        counts = list(hist.counts)
        total = hist.total
        buckets = hist.buckets
    if total <= 0:
        return None
    target = q * total
    acc = 0
    for i, b in enumerate(buckets):
        acc += counts[i]
        if acc >= target:
            return b
    return None  # lands in +Inf: no usable bound


class ResilientStorage(ObjectStorage):
    """The resilience decorator.  Unknown attributes delegate to the
    wrapped store so driver-specific surfaces stay reachable."""

    def __init__(self, inner: ObjectStorage,
                 policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 hedge: bool = True,
                 hedge_delay: Optional[float] = None):
        self._s = inner
        backend = getattr(inner, "backend", None)
        if not backend:
            try:
                backend = inner.string().split("://", 1)[0] or type(inner).__name__
            except Exception as e:
                backend = type(inner).__name__
                logger.debug("backend label fell back to %s: %s",
                             backend, e)
        # `backend` stays scheme-shaped (it keys the metered GET histogram
        # the hedge delay reads); `metric_backend` is the breaker's CLAIMED
        # label — unique among live stores, so two same-scheme endpoints
        # never interleave one breaker/shed/hedge series
        self.backend = backend
        self.policy = policy or RetryPolicy()
        self.breaker = breaker or CircuitBreaker(backend=backend)
        self.metric_backend = self.breaker.backend
        if self.breaker.probe is None:
            self.breaker.probe = self._probe
        self.hedge_enabled = hedge
        self.hedge_delay = hedge_delay
        self._pool = _ElasticPool(f"objio-{backend}")
        self._shed = _Shed(self.metric_backend)
        self._get_hist = None  # lazily bound (metered may sit below us)

    def __getattr__(self, name):
        return getattr(self._s, name)

    # -- health / ladder hooks ---------------------------------------------
    @property
    def degraded(self) -> bool:
        """True while the breaker is open — consumers switch to the
        degradation ladder (serve cache/staging, stage writes, EIO on
        misses) instead of calling the backend."""
        return self.breaker.state == BreakerState.OPEN

    def health(self) -> dict:
        return {
            "backend": self.backend,
            "metric_backend": self.metric_backend,
            "degraded": self.degraded,
            "breaker": self.breaker.snapshot(),
            "policy": {
                "deadline": self.policy.deadline,
                "max_attempts": self.policy.max_attempts,
                "attempt_timeout": self.policy.attempt_timeout,
            },
            "hedge": {
                "enabled": self.hedge_enabled,
                "delay": self.hedge_delay if self.hedge_delay is not None
                else "auto(p95)",
            },
            "shed_limit": self._shed.limit,
        }

    def close(self) -> None:
        """Stop resilience resources only (probe thread, worker pool);
        the inner store's lifecycle belongs to its owner."""
        self.breaker.close()
        self._pool.close()

    def _probe(self) -> bool:
        """Half-open probe: any *response* (including NotFound) means the
        backend is reachable again.  Goes straight to the inner store —
        the breaker gate must not veto its own recovery check."""
        try:
            self._s.head(_PROBE_KEY)
        except NotFoundError:
            return True
        except Exception as e:
            logger.debug("probe HEAD failed (still down): %s", e)
            return False
        return True

    # -- the shared call contract ------------------------------------------
    def _gate(self) -> None:
        if not self.breaker.allow():
            raise BreakerOpenError(self.backend)

    def _call(self, method: str, fn: Callable[[], object], hedge: bool = False):
        policy = self.policy
        start = time.monotonic()
        attempt = 0
        while True:
            self._gate()
            remaining = policy.deadline - (time.monotonic() - start)
            if remaining <= 0:
                raise DeadlineExceeded(f"{method}: op deadline exhausted")
            self._shed.acquire(remaining)
            err: Optional[Exception] = None
            try:
                result = self._attempt(method, fn, remaining, hedge)
            except Exception as e:  # noqa: BLE001 — classified below
                err = e
            finally:
                # release BEFORE any backoff sleep: a throttled op holding
                # its slot through a multi-second backoff would convoy
                # every concurrent op behind the already-halved limit
                self._shed.release()
            if err is None:
                self.breaker.record_success()
                self._shed.succeeded()
                return result
            eclass = classify(err)
            if eclass is ErrorClass.PERMANENT:
                # the backend answered; a definitive no is a healthy
                # backend as far as the breaker is concerned
                self.breaker.record_success()
                raise err
            if eclass is ErrorClass.THROTTLE:
                self.breaker.record_success()
                self._shed.throttled()
            else:
                self.breaker.record_failure()
            attempt += 1
            delay = policy.backoff(attempt - 1, eclass)
            elapsed = time.monotonic() - start
            if (attempt >= policy.max_attempts
                    or elapsed + delay >= policy.deadline):
                raise err
            record_retry(method, eclass)
            logger.warning("%s %s failed (try %d, %s): %s", method,
                           self.backend, attempt, eclass.value, err)
            time.sleep(delay)

    def _attempt(self, method: str, fn: Callable[[], object],
                 remaining: float, hedge: bool):
        timeout = remaining
        if self.policy.attempt_timeout is not None:
            timeout = min(self.policy.attempt_timeout, remaining)
        if hedge and self.hedge_enabled:
            return self._hedged_attempt(method, fn, timeout)
        return self._bounded(method, fn, timeout)

    def _submit(self, fn: Callable[[], object]) -> Future:
        # span context must survive the pool crossing: the metered wrapper
        # below us opens object-layer spans from the worker thread.  The
        # ambient QoS context crosses too, so a retry or hedged duplicate
        # is charged to the same tenant/class bandwidth budget as the op
        # that spawned it (qos/limiter.py sub-bucket attribution).
        ref = _TR.current_ref()
        qos = _qctx.current()
        if ref is None and qos is None:
            return self._pool.submit(fn)
        return self._pool.submit(lambda: self._carried(ref, qos, fn))

    @staticmethod
    def _carried(ref, qos, fn):
        with _qctx.applied(qos):
            if ref is None:
                return fn()
            with _TR.carried(ref):
                return fn()

    def _bounded(self, method: str, fn: Callable[[], object], timeout: float):
        fut = self._submit(fn)
        try:
            return fut.result(timeout=max(timeout, 0.001))
        except _FutTimeout:
            fut.cancel()  # not started: dropped; started: abandoned
            _ABANDONED.labels(method).inc()
            raise DeadlineExceeded(
                f"{method} {self.backend}: abandoned after {timeout:.3f}s"
            ) from None

    def _hedge_after(self) -> float:
        if self.hedge_delay is not None:
            return self.hedge_delay
        if self._get_hist is None:
            hist = _reg._metrics.get(_HIST_NAME)
            if hist is not None:
                self._get_hist = hist.labels("GET", self.backend)
        h = self._get_hist
        if h is not None and h.total >= _HEDGE_MIN_SAMPLES:
            q = _hist_quantile(h, 0.95)
            if q is not None:
                return min(max(q, _HEDGE_FLOOR), _HEDGE_CEIL)
        return _HEDGE_DEFAULT

    def _hedged_attempt(self, method: str, fn: Callable[[], object],
                        timeout: float):
        delay = self._hedge_after()
        if delay >= timeout:
            # no room to hedge inside the attempt budget: plain bounded call
            return self._bounded(method, fn, timeout)
        t0 = time.monotonic()
        primary = self._submit(fn)
        try:
            return primary.result(timeout=delay)
        except _FutTimeout:
            pass  # primary is slow: hedge below
        # (a fast primary *failure* raises here and _call classifies it)
        _HEDGES.labels(self.metric_backend).inc()
        pending = {primary, self._submit(fn)}
        hedged = {f for f in pending if f is not primary}
        last_exc: Optional[BaseException] = None
        while pending:
            left = timeout - (time.monotonic() - t0)
            if left <= 0:
                break
            done, pending = _fut_wait(pending, timeout=left,
                                      return_when=FIRST_COMPLETED)
            if not done:
                break
            for f in done:
                try:
                    result = f.result()
                except BaseException as e:  # noqa: BLE001
                    # a DEFINITIVE answer from either leg ends the race:
                    # waiting out the other leg would misreport a NotFound
                    # (or throttle) as a deadline timeout and feed the
                    # breaker a failure for a backend that answered
                    if classify(e) is not ErrorClass.TRANSIENT:
                        for p in pending:
                            p.cancel()
                        raise
                    last_exc = e
                    continue
                if f in hedged:
                    _HEDGE_WINS.labels(self.metric_backend).inc()
                for p in pending:
                    p.cancel()
                return result
        for p in pending:
            p.cancel()
        if pending or last_exc is None:
            _ABANDONED.labels(method).inc()
            raise DeadlineExceeded(
                f"{method} {self.backend}: hedged pair abandoned after "
                f"{timeout:.3f}s"
            ) from None
        raise last_exc

    # -- ObjectStorage ------------------------------------------------------
    def string(self) -> str:
        return self._s.string()

    def create(self) -> None:
        self._s.create()

    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        return self._call("GET", lambda: self._s.get(key, off, limit),
                          hedge=True)

    def put(self, key: str, data: bytes) -> None:
        return self._call("PUT", lambda: self._s.put(key, data))

    def delete(self, key: str) -> None:
        return self._call("DELETE", lambda: self._s.delete(key))

    def head(self, key: str):
        return self._call("HEAD", lambda: self._s.head(key))

    def copy(self, dst: str, src: str) -> None:
        return self._call("COPY", lambda: self._s.copy(dst, src))

    def list_all(self, prefix: str = "", marker: str = ""):
        # streaming iterators cannot be transparently re-driven from an
        # arbitrary point; gate on the breaker, let callers own restarts
        self._gate()
        return self._s.list_all(prefix, marker)

    def list(self, prefix: str = "", marker: str = "", limit: int = 1000):
        self._gate()
        return self._s.list(prefix, marker, limit)

    def create_multipart_upload(self, key: str):
        return self._call("MPU-CREATE",
                          lambda: self._s.create_multipart_upload(key))

    def upload_part(self, key: str, upload_id: str, num: int, data: bytes):
        return self._call(
            "MPU-PART",
            lambda: self._s.upload_part(key, upload_id, num, data))

    def complete_upload(self, key: str, upload_id: str, parts) -> None:
        return self._call(
            "MPU-COMPLETE",
            lambda: self._s.complete_upload(key, upload_id, parts))

    def abort_upload(self, key: str, upload_id: str) -> None:
        self._s.abort_upload(key, upload_id)  # cleanup: best-effort anyway

    def limits(self) -> dict:
        return self._s.limits()


def resilient(store: ObjectStorage, **kw) -> ResilientStorage:
    """Idempotently wrap a store with the resilience layer."""
    if isinstance(store, ResilientStorage):
        return store
    return ResilientStorage(store, **kw)


_SNAPSHOT_COUNTERS = (
    "juicefs_object_request_retries",
    "juicefs_object_retries_by_class",
    "juicefs_object_deadline_abandoned",
    "juicefs_object_hedged_requests",
    "juicefs_object_hedge_wins",
    "juicefs_object_breaker_trips",
    "juicefs_object_breaker_resets",
)


def resilience_snapshot() -> dict:
    """Compact dump of the resilience counters/gauges for bench JSON and
    the `.status` internal file — the overhead and recovery activity of
    this layer must be visible in the perf trajectory."""
    out: dict = {}
    for name in _SNAPSHOT_COUNTERS + ("juicefs_object_breaker_state",
                                      "juicefs_object_shed_limit"):
        m = _reg._metrics.get(name)
        if m is None:
            continue
        short = name.replace("juicefs_object_", "")
        with m._lock:
            children = dict(m._children)
        if not children:
            if getattr(m, "value", 0):
                out[short] = m.value
            continue
        series = {}
        for key, child in children.items():
            v = child.value
            if v:
                series[",".join(key)] = v
        if series:
            out[short] = series
    return out
