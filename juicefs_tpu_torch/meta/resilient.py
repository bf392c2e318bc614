"""Meta-plane fault contract — the meta twin of
``object/resilient.py``.

The meta engine is the single coordination point for every client, yet
until this layer any engine stall, dropped connection, or mid-txn
failure surfaced as a raw exception on the FUSE request path.  The
:class:`MetaResilience` layer sits INSIDE :class:`BaseMeta` — between
the lease/wbatch seams and the engine ``do_*``/txn layer — and owns the
contract:

  classification   PERMANENT posix errnos (engine *answered*: ENOENT,
                   EEXIST, sqlite schema errors) pass through untouched
                   and are breaker-neutral; TRANSIENT connection
                   resets/timeouts get jittered deadline-aware retries;
                   BUSY (sqlite "database is locked", escaped optimistic
                   conflicts, injected throttles) retries from a higher
                   backoff floor; AMBIGUOUS (a commit whose outcome is
                   unknowable — redis "connection lost while committing")
                   is NEVER retried: a blind rerun of a read-modify-write
                   could double-apply.
  rerun safety     retrying a ``do_*`` wholesale re-runs its engine
                   transaction closure.  That is safe *because* txn
                   closures are rerun-pure — the txn-purity
                   analyzer + suite-wide txnwatch doubling is the
                   precondition this layer leans on (an impure closure
                   would already fail CI before it could double here).
  circuit breaker  per-engine-connection failure-rate breaker
                   (closed → open over a sliding window, half-open via a
                   background probe against the RAW engine, closed after
                   a success streak).  ``juicefs_meta_breaker_state``
                   gauge + trip/reset counters.
  degraded mode    while open: reads serve live-and-EXPIRED LeaseCache
                   entries (marked stale-served, bounded by
                   ``--meta-degraded-max-stale``); guarded read
                   transactions pass through to the replica
                   (failover — the epoch lag guard is retained); wbatch
                   queues absorb writes up to their bound then surface
                   EIO at barriers per the sticky-error contract — never
                   silently; everything else fails fast with
                   :class:`MetaUnavailableError` (EIO).
  heal             breaker reset fires the heal chain: the client
                   re-primes its replica epoch floor (a re-SYNCing
                   replica must not serve pre-outage state as fresh),
                   re-registers an expired session (same sid — inode
                   prealloc ranges are monotonic counter grants, so they
                   survive), and replays queued wbatch groups
                   byte-identically (the deferred closures are pre-bound).

Disabled (the default — ``--meta-retries`` 0) nothing is wrapped at all:
the engine ``do_*`` bound methods are untouched and the build is
byte-identical to one without this layer.
"""

from __future__ import annotations

import errno as _errno
import random
import sqlite3
import threading
import time
from collections import deque
from concurrent.futures import TimeoutError as _FutTimeout
from dataclasses import dataclass
from enum import Enum, IntEnum
from typing import Callable, Optional

from ..metric import global_registry
from ..utils import get_logger

logger = get_logger("meta.resilient")
_reg = global_registry()

_RETRIES = _reg.counter(
    "juicefs_meta_fault_retries",
    "Meta engine ops retried after a classified transient/busy failure",
    ("class",),
)
_FAILURES = _reg.counter(
    "juicefs_meta_fault_failures",
    "Meta engine ops that exhausted their retry/deadline budget "
    "(or were refused ambiguous/breaker-open)",
    ("class",),
)
_ABANDONED = _reg.counter(
    "juicefs_meta_fault_abandoned",
    "Meta engine read attempts abandoned at their attempt timeout "
    "(hung engine call; the caller retried or failed without waiting it out)",
)
_BREAKER_STATE = _reg.gauge(
    "juicefs_meta_breaker_state",
    "Meta engine circuit breaker state (0=closed, 1=open, 2=half-open)",
    ("engine",),
)
_BREAKER_TRIPS = _reg.counter(
    "juicefs_meta_breaker_trips",
    "Meta engine breaker transitions into the open state",
    ("engine",),
)
_BREAKER_RESETS = _reg.counter(
    "juicefs_meta_breaker_resets",
    "Meta engine breaker recoveries back to the closed state",
    ("engine",),
)


class MetaErrorClass(Enum):
    PERMANENT = "permanent"
    TRANSIENT = "transient"
    BUSY = "busy"
    AMBIGUOUS = "ambiguous"


class MetaUnavailableError(OSError):
    """Fail-fast EIO: the meta engine's breaker is open (or its retry
    budget is spent).  An OSError so the FUSE layer surfaces it as a
    plain EIO without any extra mapping."""

    def __init__(self, engine: str, why: str = "circuit open"):
        super().__init__(_errno.EIO, f"meta engine {engine}: {why}")


class MetaBusyError(Exception):
    """Marker base for engine 'asked for less traffic' responses
    (classified BUSY: retried from a higher backoff floor).  The fault
    injector's throttle subclasses this."""


class MetaAttemptTimeout(Exception):
    """An abandoned (hung) engine read attempt — classified TRANSIENT.
    Deliberately NOT an OSError: an errno would classify PERMANENT."""


def classify_meta(exc: BaseException) -> MetaErrorClass:
    """Map an engine exception to its retry class.  POSIX results are
    RETURN values in the meta layer, so anything classified PERMANENT
    here passes through untouched — the engine answered."""
    from .redis_kv import MetaCommitUnknownError

    if isinstance(exc, MetaCommitUnknownError):
        return MetaErrorClass.AMBIGUOUS
    if isinstance(exc, MetaBusyError):
        return MetaErrorClass.BUSY
    if isinstance(exc, MetaAttemptTimeout):
        return MetaErrorClass.TRANSIENT
    if isinstance(exc, sqlite3.OperationalError):
        msg = str(exc).lower()
        if "locked" in msg or "busy" in msg:
            return MetaErrorClass.BUSY
        return MetaErrorClass.PERMANENT  # schema/misuse: engine answered
    from .tkv_client import ConflictError

    if isinstance(exc, ConflictError):
        # an optimistic conflict that escaped the engine's own retry
        # budget: hot contention, not a dead engine
        return MetaErrorClass.BUSY
    if isinstance(exc, (ConnectionError, TimeoutError, EOFError)):
        # MetaNetworkError is a ConnectionError subclass; socket.timeout
        # is an alias of (OS)TimeoutError on modern Pythons
        return MetaErrorClass.TRANSIENT
    return MetaErrorClass.PERMANENT


@dataclass
class MetaRetryPolicy:
    """Per-op retry/deadline budget.  ``deadline`` caps the whole op
    (retries included); ``attempt_timeout`` (reads only, default off)
    bounds a single attempt — a hung engine call is ABANDONED at that
    bound instead of pinning the FUSE request thread.  Mutating ops are
    never abandoned: an abandoned write could commit later and a retry
    would double-apply."""

    deadline: float = 15.0
    max_attempts: int = 5
    base: float = 0.005
    cap: float = 1.0
    jitter: float = 0.2
    busy_base: float = 0.05  # a busy engine asked for less traffic
    busy_cap: float = 2.0
    attempt_timeout: Optional[float] = None

    def backoff(self, attempt: int, eclass: MetaErrorClass,
                rng: Callable[[], float] = random.random) -> float:
        if eclass is MetaErrorClass.BUSY:
            b = min(self.busy_cap, self.busy_base * (2.0 ** attempt))
        else:
            b = min(self.cap, self.base * (2.0 ** attempt))
        return b * (1.0 + self.jitter * rng())


class BreakerState(IntEnum):
    CLOSED = 0
    OPEN = 1
    HALF_OPEN = 2


class MetaBreaker:
    """Per-engine-connection failure-rate breaker with half-open
    background probes (the meta twin of object/resilient.CircuitBreaker;
    kept separate so the meta plane owns its own pinned metric series
    and a probe that goes to the RAW engine below the guard)."""

    def __init__(self, engine: str = "meta", window: float = 30.0,
                 threshold: float = 0.5, min_samples: int = 8,
                 probe_interval: float = 1.0,
                 probe: Optional[Callable[[], bool]] = None,
                 half_open_successes: int = 2):
        self.engine = engine
        self.window = window
        self.threshold = threshold
        self.min_samples = min_samples
        self.probe_interval = probe_interval
        self.probe = probe
        self.half_open_successes = half_open_successes
        self._lock = threading.Lock()
        self._events: deque[tuple[float, bool]] = deque()
        self._state = BreakerState.CLOSED
        self._streak = 0
        self._on_reset: list[Callable[[], None]] = []
        self._on_open: list[Callable[[], None]] = []
        self._closed_down = False
        self._probe_alive = False
        self._probe_wake = threading.Event()
        self._last_probe = 0.0  # monotonic stamp of the last probe result
        _BREAKER_STATE.labels(self.engine).set(0)

    def on_reset(self, cb: Callable[[], None]) -> None:
        self._on_reset.append(cb)

    def on_open(self, cb: Callable[[], None]) -> None:
        self._on_open.append(cb)

    @property
    def state(self) -> BreakerState:
        return self._state

    def allow(self) -> bool:
        return self._state != BreakerState.OPEN

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
                if total >= self.min_samples \
                        and fails / total >= self.threshold:
                    fire_open = self._trip_locked()
        if fire_open:
            self._fire(self._on_open)

    def _trip_locked(self) -> bool:
        prior = self._state
        self._state = BreakerState.OPEN
        self._streak = 0
        _BREAKER_STATE.labels(self.engine).set(1)
        if prior != BreakerState.OPEN:
            _BREAKER_TRIPS.labels(self.engine).inc()
            logger.warning("meta breaker OPEN for engine %s", self.engine)
            self._start_probe_locked()
            return True
        return False

    def _reset_locked(self) -> bool:
        self._state = BreakerState.CLOSED
        self._streak = 0
        self._events.clear()
        _BREAKER_STATE.labels(self.engine).set(0)
        _BREAKER_RESETS.labels(self.engine).inc()
        logger.warning("meta breaker CLOSED for engine %s", self.engine)
        return True

    def _fire(self, cbs: list[Callable[[], None]]) -> None:
        for cb in cbs:
            try:
                cb()
            except Exception:
                logger.exception("meta breaker callback failed")

    def _start_probe_locked(self) -> None:
        # one prober ever (a HALF_OPEN re-trip must not stack a second
        # thread) — same invariant as the object-plane breaker
        if self.probe is None or self._probe_alive:
            return
        self._probe_alive = True
        t = threading.Thread(target=self._probe_loop, daemon=True,
                             name=f"meta-breaker-probe-{self.engine}")
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
                                 self.engine, e)
                self._last_probe = time.monotonic()
                with self._lock:
                    if self._state == BreakerState.OPEN and ok:
                        self._state = BreakerState.HALF_OPEN
                        self._streak = 0
                        _BREAKER_STATE.labels(self.engine).set(2)
                        logger.info("meta breaker HALF_OPEN for engine %s",
                                    self.engine)
                if ok:
                    self.record_success()
                elif self._state == BreakerState.HALF_OPEN:
                    # the primary flapped: HALF_OPEN --(any failure)-->
                    # OPEN must hold for probe failures too, or a
                    # read-only mount (replica-served reads never feed
                    # the breaker, wbatch absorbs only while OPEN) sits
                    # HALF_OPEN forever — degraded stale serving off,
                    # every read burning its full retry deadline
                    self.record_failure()
                if self._state == BreakerState.CLOSED:
                    return
        finally:
            with self._lock:
                self._probe_alive = False
                if (self._state == BreakerState.OPEN
                        and not self._closed_down):
                    self._start_probe_locked()

    def close(self) -> None:
        self._closed_down = True
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
            "probe_age_seconds": (
                round(time.monotonic() - self._last_probe, 3)
                if self._last_probe else None),
        }


# engine ops fronted by the guard.  READ ops may be abandoned at the
# attempt timeout and may pass the open breaker toward a replica; WRITE
# ops are retried only on unambiguous pre-commit failures and fail fast
# while the breaker is open.
GUARDED_READS = (
    "do_load", "do_getattr", "do_lookup", "do_readdir", "do_readlink",
    "do_read_chunk", "do_read_chunks", "do_getxattr", "do_listxattr",
    "do_statfs", "do_list_sessions", "do_find_deleted_files",
    "do_list_slices", "content_resolve", "do_session_exists",
    "getlk",
)
GUARDED_WRITES = (
    "do_mknod", "do_setattr", "do_unlink", "do_rmdir", "do_rename",
    "do_link", "do_truncate", "do_fallocate", "do_write_chunk",
    "do_setxattr", "do_removexattr", "do_compact_chunk",
    "do_new_inodes", "do_new_slices",
    "do_new_session", "do_refresh_session", "do_update_session",
    "do_delete_sustained", "do_counter", "group_txn",
    "content_incref", "content_register", "content_decref",
    # POSIX/BSD lock ops are engine-level methods (not do_*) but sit on
    # the same wire: unguarded they would dial a dead primary per call
    # and raise raw network errors on the FUSE request path
    "setlk", "flock",
)


class MetaResilience:
    """The guard installed over an engine's ``do_*`` bound methods.

    Constructed INERT for every BaseMeta (``enabled`` False, ``degraded``
    False, zero overhead — nothing is wrapped); ``configure`` installs
    the wrappers.  Nested engine calls (a ``do_*`` inside ``group_txn``'s
    drain closure, a lookup inside ``do_rename``) pass straight through:
    the OUTERMOST guarded call owns the retry/deadline budget, so a
    group commit retries as one unit — which is exactly the rerun-purity
    contract the txn layer already guarantees."""

    def __init__(self, meta):
        self.meta = meta
        self.enabled = False
        self.policy = MetaRetryPolicy()
        self.breaker: Optional[MetaBreaker] = None
        self.degraded_max_stale = 0.0
        self._tl = threading.local()
        self._pool = None  # lazy: only attempt-timeout reads need it
        self._raw: dict[str, Callable] = {}

    @property
    def degraded(self) -> bool:
        b = self.breaker
        return b is not None and b.state == BreakerState.OPEN

    @property
    def max_stale(self) -> float:
        return self.degraded_max_stale

    def configure(self, max_attempts: int = 5, deadline: float = 15.0,
                  degraded_max_stale: float = 0.0,
                  attempt_timeout: Optional[float] = None,
                  breaker: Optional[MetaBreaker] = None,
                  **breaker_kw) -> None:
        """Install the guard over the meta instance's engine ops.
        Idempotent re-configure re-wraps from the RAW methods (never
        guard-over-guard)."""
        meta = self.meta
        self.policy = MetaRetryPolicy(deadline=deadline,
                                      max_attempts=max(1, int(max_attempts)),
                                      attempt_timeout=attempt_timeout)
        self.degraded_max_stale = max(0.0, float(degraded_max_stale))
        if self.breaker is not None:
            self.breaker.close()
        self.breaker = breaker or MetaBreaker(engine=meta.name(),
                                              **breaker_kw)
        if self.breaker.probe is None:
            self.breaker.probe = self._probe
        self.breaker.on_open(meta._on_breaker_open)
        self.breaker.on_reset(self._heal_async)
        for name in GUARDED_READS + GUARDED_WRITES:
            fn = self._raw.get(name) or getattr(meta, name, None)
            if fn is None:
                continue
            self._raw[name] = fn
            setattr(meta, name,
                    self._guard(name, fn, name in GUARDED_WRITES))
        self.enabled = True

    def _heal_async(self) -> None:
        """Run the heal chain on its OWN daemon thread.  The reset can
        fire from whatever thread recorded the closing success — which
        may be a wbatch drain leader holding the drain lock (its own
        group commit is the success that closed the breaker).  A
        synchronous heal would then call barrier() reentrantly and
        deadlock on the non-reentrant drain lock it already holds."""
        threading.Thread(target=self.meta._on_meta_heal, daemon=True,
                         name=f"meta-heal-{self.breaker.engine}").start()

    def raw(self, name: str) -> Optional[Callable]:
        """The unguarded engine method (probes and drills go here)."""
        return self._raw.get(name)

    def _probe(self) -> bool:
        """Half-open probe against the RAW engine: any answer (even a
        not-formatted None) means the engine is reachable again.  The
        guard's gate must not veto its own recovery check."""
        fn = self._raw.get("do_load")
        if fn is None:
            return False
        fn()
        return True

    # -- the guard ----------------------------------------------------------
    def _guard(self, name: str, fn: Callable, mutating: bool) -> Callable:
        def guarded(*a, **kw):
            if getattr(self._tl, "depth", 0):
                return fn(*a, **kw)  # nested: the outer guard owns policy
            return self._call(name, fn, mutating, a, kw)

        guarded.__name__ = f"guarded_{name}"
        guarded.__wrapped__ = fn
        return guarded

    def _gate(self, mutating: bool) -> None:
        b = self.breaker
        if b is None or b.allow():
            return
        if not mutating and self.meta.replica_available():
            # FAILOVER: guarded read transactions route to the replica
            # inside the engine (_ReadTxn prefers it; primary_down stops
            # the stale-demote path from dialing the dead primary)
            return
        _FAILURES.labels("breaker_open").inc()
        raise MetaUnavailableError(b.engine)

    def _attempt(self, fn: Callable, a, kw, mutating: bool,
                 remaining: float):
        tl = self._tl

        def run():
            tl.depth = getattr(tl, "depth", 0) + 1
            try:
                return fn(*a, **kw)
            finally:
                tl.depth -= 1

        at = self.policy.attempt_timeout
        if mutating or at is None:
            # writes run on the caller: an abandoned write could still
            # commit, and a retry after that double-applies
            return run()
        if self._pool is None:
            from ..object.resilient import _ElasticPool

            self._pool = _ElasticPool(f"metaio-{self.breaker.engine}")
        fut = self._pool.submit(run)
        try:
            return fut.result(timeout=max(0.001, min(at, remaining)))
        except _FutTimeout:
            fut.cancel()
            _ABANDONED.inc()
            raise MetaAttemptTimeout(
                f"meta attempt abandoned after {at:.3f}s") from None

    def _call(self, name: str, fn: Callable, mutating: bool, a, kw):
        policy = self.policy
        start = time.monotonic()
        attempt = 0
        while True:
            self._gate(mutating)
            remaining = policy.deadline - (time.monotonic() - start)
            if remaining <= 0:
                _FAILURES.labels("deadline").inc()
                raise MetaUnavailableError(
                    self.breaker.engine, f"{name}: deadline exhausted")
            try:
                result = self._attempt(fn, a, kw, mutating, remaining)
            except Exception as e:  # noqa: BLE001 — classified below
                err = e
            else:
                self._record(True, mutating)
                return result
            eclass = classify_meta(err)
            if eclass is MetaErrorClass.PERMANENT:
                # a definitive answer = healthy engine
                self._record(True, mutating)
                raise err
            if eclass is MetaErrorClass.AMBIGUOUS:
                # the commit may or may not have landed: NEVER retried —
                # surfacing the uncertainty loudly beats double-applying
                self._record(False, mutating)
                _FAILURES.labels(eclass.value).inc()
                raise err
            self._record(eclass is MetaErrorClass.BUSY, mutating)
            attempt += 1
            delay = policy.backoff(attempt - 1, eclass)
            elapsed = time.monotonic() - start
            if (attempt >= policy.max_attempts
                    or elapsed + delay >= policy.deadline):
                _FAILURES.labels(eclass.value).inc()
                # a spent TRANSIENT/BUSY budget surfaces as the
                # contract's uniform EIO (cause chained): the BaseMeta
                # read paths catch exactly this to enter degraded
                # serving, and FUSE maps it without a traceback.
                # PERMANENT and AMBIGUOUS errors always pass through raw.
                raise MetaUnavailableError(
                    self.breaker.engine,
                    f"{name}: {err} (budget spent)") from err
            _RETRIES.labels(eclass.value).inc()
            logger.warning("meta %s failed (try %d, %s): %s",
                           name, attempt, eclass.value, err)
            time.sleep(delay)

    def _record(self, ok: bool, mutating: bool) -> None:
        """Feed the breaker — but only from traffic that is evidence
        about the PRIMARY engine connection.  While the breaker is not
        closed, reads may be replica-served (their success says nothing
        about the primary), so recovery is driven by the probe and by
        MUTATING traffic (always primary-bound); the probe loop records
        through record_success/record_failure directly."""
        b = self.breaker
        if b is None:
            return
        if b.state != BreakerState.CLOSED and not mutating:
            return
        if ok:
            b.record_success()
        else:
            b.record_failure()

    # -- lifecycle / observability ------------------------------------------
    def close(self) -> None:
        if self.breaker is not None:
            self.breaker.close()
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def health(self) -> dict:
        if not self.enabled:
            return {"enabled": False}
        meta = self.meta
        replica = meta.replica_available()
        out = {
            "enabled": True,
            "degraded": self.degraded,
            "breaker": self.breaker.snapshot(),
            "policy": {
                "deadline": self.policy.deadline,
                "max_attempts": self.policy.max_attempts,
                "attempt_timeout": self.policy.attempt_timeout,
            },
            "degraded_max_stale": self.degraded_max_stale,
            "stale_served": meta.lease.n_stale_served,
            "replica": {
                "configured": replica,
                "role": ("failover" if replica and self.degraded
                         else "primary"),
            },
        }
        return out


def meta_resilience_snapshot() -> dict:
    """Compact counter dump for bench JSON (mirrors
    object/resilient.resilience_snapshot)."""
    out: dict = {}
    for name in ("juicefs_meta_fault_retries", "juicefs_meta_fault_failures",
                 "juicefs_meta_fault_abandoned", "juicefs_meta_breaker_trips",
                 "juicefs_meta_breaker_resets", "juicefs_meta_breaker_state",
                 "juicefs_meta_stale_served"):
        m = _reg._metrics.get(name)
        if m is None:
            continue
        short = name.replace("juicefs_meta_", "")
        with m._lock:
            children = dict(m._children)
        if not children:
            if getattr(m, "value", 0):
                out[short] = m.value
            continue
        series = {}
        for key, child in children.items():
            if child.value:
                series[",".join(key)] = child.value
        if series:
            out[short] = series
    return out
