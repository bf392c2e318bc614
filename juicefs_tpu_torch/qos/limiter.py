"""Hierarchical token-bucket bandwidth shaping (a copy of
juicefs_tpu/qos/limiter.py).

The reference hangs `--upload-limit/--download-limit` off the chunk-store
boundary (upload/download concurrency + bandwidth limits);
here the budget is split across the resilience layer so every attempt,
retry and hedged duplicate counts against the configured cap WITHOUT the
token wait ever running inside a timed attempt.  The canonical stack is

    gated(resilient(shaped(metered(storage), limiter)), limiter)

  - `gated` (ABOVE resilience) is where ops WAIT: one token gate per
    logical op, on the caller's thread, before the resilience layer
    starts its attempt clock.  A gate wait therefore never counts
    against the hedge delay, the per-attempt deadline, or the breaker —
    a saturated self-imposed cap must not look like a failing backend
    (hedge storms, DeadlineExceeded retries, a tripped breaker).
  - `shaped` (BELOW resilience) is where bytes are CHARGED: every
    attempt, retry and hedged duplicate bills the debt bucket
    unconditionally, so the budget still accounts for the full
    object-plane traffic and future gates pace admission down.
  - metering stays innermost so the latency histograms the hedge delay
    reads never include token-wait time.

Accounting model (debt bucket): `gate()` waits until the level is
positive; `charge(n)` subtracts unconditionally (the level may go
negative — an oversized burst is admitted once and then paid back, and
retry/hedge charges land as debt that slows the next admission).
Sustained throughput converges on the configured rate without knowing
response sizes in advance.

Hierarchy: a global bucket per direction, plus optional per-class
sub-buckets (`class_caps={"background": 0.5}` caps background at half the
global rate).  The class is read from the ambient QoS context
(qos/context.py), which the scheduler sets around task execution and the
resilience layer carries across its elastic pool.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..metric import global_registry
from . import context as qctx

_reg = global_registry()
_THROTTLE_WAIT = _reg.counter(
    "juicefs_qos_throttle_wait_seconds",
    "Seconds object ops spent waiting for bandwidth tokens",
    ("direction",),
)
_THROTTLED_BYTES = _reg.counter(
    "juicefs_qos_throttled_bytes",
    "Bytes charged against a bandwidth budget after a token wait",
    ("direction",),
)

# default burst: 1/8s of the configured rate (floored at 1 MiB) — small
# enough that a 2s measurement window stays within the +-10% accuracy
# contract, big enough to admit one block-sized op without chopping it up
_BURST_FRACTION = 0.125
_MIN_BURST = 1 << 20


class TokenBucket:
    """Debt-model token bucket: `acquire` waits for a positive level then
    subtracts (possibly into debt); `charge` subtracts unconditionally
    (post-paid GETs); `gate` only waits.  Refill is computed from the
    monotonic clock on every touch — no refill thread."""

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError(f"token rate must be positive: {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(
            self.rate * _BURST_FRACTION, _MIN_BURST)
        self._level = self.burst
        self._last = time.monotonic()
        self._cond = threading.Condition()

    def _refill_locked(self, now: float) -> None:
        self._level = min(self.burst,
                          self._level + (now - self._last) * self.rate)
        self._last = now

    def gate(self, timeout: Optional[float] = None) -> float:
        """Wait until the level is positive; returns seconds waited."""
        start = time.monotonic()
        with self._cond:
            while True:
                now = time.monotonic()
                self._refill_locked(now)
                if self._level > 0:
                    return now - start
                need = -self._level / self.rate
                if timeout is not None and (now - start) + need > timeout:
                    raise TimeoutError("bandwidth token wait exceeded bound")
                self._cond.wait(need + 0.001)

    def charge(self, n: float) -> float:
        """Post-paid: subtract n (may push the level into debt).
        Returns the new level."""
        with self._cond:
            self._refill_locked(time.monotonic())
            self._level -= n
            return self._level

    def acquire(self, n: float, timeout: Optional[float] = None) -> float:
        """Pre-paid: gate, then charge.  Returns seconds waited."""
        waited = self.gate(timeout)
        self.charge(n)
        return waited

    def snapshot(self) -> dict:
        with self._cond:
            self._refill_locked(time.monotonic())
            return {"rate_bps": self.rate, "burst_bytes": self.burst,
                    "level_bytes": round(self._level)}


class Limiter:
    """Per-direction global buckets + optional per-class sub-buckets."""

    UPLOAD = "upload"
    DOWNLOAD = "download"

    def __init__(self, upload_bps: float = 0.0, download_bps: float = 0.0,
                 class_caps: Optional[dict] = None,
                 burst: Optional[float] = None):
        self._global = {}
        self._sub: dict = {}
        for direction, rate in ((self.UPLOAD, upload_bps),
                                (self.DOWNLOAD, download_bps)):
            if rate and rate > 0:
                self._global[direction] = TokenBucket(rate, burst)
                for label, frac in (class_caps or {}).items():
                    self._sub[(direction, label)] = TokenBucket(
                        rate * float(frac), burst)

    def _buckets(self, direction: str):
        out = []
        g = self._global.get(direction)
        if g is None:
            return out
        ctx = qctx.current()
        if ctx is not None and ctx.cls is not None:
            sub = self._sub.get((direction, ctx.cls.label))
            if sub is not None:
                out.append(sub)  # sub-bucket first: the tighter budget
        out.append(g)
        return out

    def enabled(self, direction: str) -> bool:
        return direction in self._global

    def gate(self, direction: str) -> float:
        waited = 0.0
        for b in self._buckets(direction):
            waited += b.gate()
        if waited > 0:
            _THROTTLE_WAIT.labels(direction).inc(waited)
        return waited

    def charge(self, direction: str, n: int, waited: float = 0.0) -> None:
        saturated = False
        for b in self._buckets(direction):
            if b.charge(n) < 0:
                saturated = True
        # throttled_bytes counts bytes billed while the budget was the
        # binding constraint: either the op waited for tokens, or the
        # charge left a bucket in debt (charge-only attempts below the
        # resilience layer never wait — saturation is their signal)
        if waited > 0 or saturated:
            _THROTTLED_BYTES.labels(direction).inc(n)

    def acquire(self, direction: str, n: int) -> float:
        """Pre-paid (PUT-side): gate on every bucket in the hierarchy,
        then charge them all."""
        waited = self.gate(direction)
        self.charge(direction, n, waited)
        return waited

    def snapshot(self) -> dict:
        out: dict = {}
        for direction, b in self._global.items():
            out[direction] = b.snapshot()
        for (direction, label), b in self._sub.items():
            out.setdefault("class_caps", {})[f"{direction}/{label}"] = \
                b.snapshot()
        return out


class ShapedStorage:
    """Charge-only half of the budget, at the object boundary.  Sits
    BELOW the resilience layer, so each retry and hedged duplicate is
    billed individually (into debt if need be), and ABOVE metering, so
    the per-backend latency histograms (which the hedge delay reads its
    p95 from) see only backend time.  It NEVER waits — a token wait
    inside a timed attempt would count against the hedge delay, the
    attempt deadline and the breaker, turning a saturated self-imposed
    cap into hedge storms and spurious trips.  Waiting happens once per
    logical op in `GatedStorage`, above the resilience layer."""

    def __init__(self, inner, limiter: Limiter):
        self._s = inner
        self.limiter = limiter

    def __getattr__(self, name):
        return getattr(self._s, name)

    # -- charged ops -------------------------------------------------------
    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        data = self._s.get(key, off, limit)
        self.limiter.charge(Limiter.DOWNLOAD, len(data))
        return data

    def put(self, key: str, data) -> None:
        self.limiter.charge(Limiter.UPLOAD, len(data))
        return self._s.put(key, data)

    def upload_part(self, key: str, upload_id: str, num: int, data):
        self.limiter.charge(Limiter.UPLOAD, len(data))
        return self._s.upload_part(key, upload_id, num, data)


class GatedStorage:
    """Gate-only half of the budget: one token wait per LOGICAL op, on
    the caller's thread, BEFORE the resilience layer starts its attempt
    clock.  Pairs with `ShapedStorage` below resilience (which bills the
    bytes); see the module docstring for the full stack."""

    def __init__(self, inner, limiter: Limiter):
        self._s = inner
        self.limiter = limiter

    def __getattr__(self, name):
        return getattr(self._s, name)

    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        self.limiter.gate(Limiter.DOWNLOAD)
        return self._s.get(key, off, limit)

    def put(self, key: str, data) -> None:
        self.limiter.gate(Limiter.UPLOAD)
        return self._s.put(key, data)

    def upload_part(self, key: str, upload_id: str, num: int, data):
        self.limiter.gate(Limiter.UPLOAD)
        return self._s.upload_part(key, upload_id, num, data)


def shaped(store, limiter: Optional[Limiter]):
    """Wrap `store` with the charge-only half (no-op without a limiter)."""
    if limiter is None or isinstance(store, ShapedStorage):
        return store
    return ShapedStorage(store, limiter)


def gated(store, limiter: Optional[Limiter]):
    """Wrap `store` with the gate-only half (no-op without a limiter)."""
    if limiter is None or isinstance(store, GatedStorage):
        return store
    return GatedStorage(store, limiter)
