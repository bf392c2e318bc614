"""Ordered, bounded-window parallel fetch stage (a copy of
juicefs_tpu/chunk/parallel.py).

`fetch_ordered` keeps up to `window` calls in flight on a caller-owned
executor and yields results **in input order**, so the hash pipeline
downstream stays deterministic while storage I/O overlaps device compute.

Bounds, by construction:
  - at most `window` futures exist at any moment, so no more than `window`
    concurrent GETs and no more than `window` completed blocks buffered
    (window x block_size bytes);
  - yielding blocks on the *oldest* future, so a slow head stalls the
    output but never grows the buffer.

The worker callable must never submit-and-wait on the same bounded pool it
runs on.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Iterable, Iterator, Optional, TypeVar

from ..metric import global_registry
from ..metric.trace import global_tracer, stage_hist
from ..object.interface import NotFoundError
from ..object.resilient import BreakerOpenError
from ..utils import get_logger

logger = get_logger("chunk.parallel")

T = TypeVar("T")
R = TypeVar("R")

# Gauge (not counter): in-flight GETs of every live fetch stage — the
# direct observable for "is storage I/O actually overlapping compute".
_INFLIGHT = global_registry().gauge(
    "juicefs_torch_fetch_inflight",
    "Block fetches currently in flight in ordered parallel-fetch stages",
)
_TR = global_tracer()
# the consumer blocked on the oldest fetch: the time the stage downstream
# (the hash pipeline, for gc --dedup) waited for a block
_H_WAIT = stage_hist("chunk", "fetch", "wait")


class FetchStats:
    """Wall vs aggregate time of one fetch stage.

    `seconds` sums per-call durations across worker threads (aggregate
    thread time); `wall` is BUSY wall — time during which at least one
    call was in flight.  Busy, not first-start-to-last-end: a
    consumer-paced stage (one GET issued per block the hash pipeline
    drains) would otherwise count its idle gaps as GET time and report a
    hash-bound scan as GET-bound.  With a window of W and the stage
    saturated, seconds/wall ~= W — the overlap factor.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.seconds = 0.0  # aggregate per-thread GET seconds
        self.items = 0
        self.errors = 0
        self._active = 0
        self._busy = 0.0
        self._active_since: Optional[float] = None

    @property
    def wall(self) -> float:
        with self._lock:
            busy = self._busy
            if self._active_since is not None:
                busy += time.perf_counter() - self._active_since
        return busy

    def _begin(self, start: float) -> None:
        with self._lock:
            if self._active == 0:
                self._active_since = start
            self._active += 1

    def _record(self, start: float, end: float) -> None:
        with self._lock:
            self.seconds += end - start
            self.items += 1
            self._active -= 1
            if self._active == 0 and self._active_since is not None:
                self._busy += end - self._active_since
                self._active_since = None

    def _record_error(self) -> None:
        with self._lock:
            self.errors += 1


def fetch_ordered(
    items: Iterable[T],
    fn: Callable[[T], R],
    pool,
    window: int,
    on_error: str = "raise",
    stats: Optional[FetchStats] = None,
) -> Iterator[tuple[T, R]]:
    """Run `fn(item)` over `items` on `pool`, up to `window` in flight,
    yielding `(item, result)` strictly in input order.

    on_error="raise": the first failing item re-raises (in input order) and
    the stage cancels everything still queued — for paths where a missing
    block is corruption (compact).
    on_error="skip": failing items are logged and dropped from the output —
    for scans that must cover everything else (gc --dedup).  A
    NotFoundError under "skip" is logged at debug only: bulk scans racing
    deletions are expected.

    A BreakerOpenError re-raises even under "skip": an open circuit is not
    a per-item failure — every remaining item would fast-fail identically,
    so the stage aborts instead of burning the whole input on EIO churn.
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error: {on_error!r}")
    window = max(1, int(window))

    def timed(item: T) -> R:
        _INFLIGHT.inc()
        start = time.perf_counter()
        if stats is not None:
            stats._begin(start)
        try:
            out = fn(item)
        except BaseException:
            if stats is not None:
                stats._record_error()
            raise
        finally:
            end = time.perf_counter()
            _INFLIGHT.dec()
            if stats is not None:
                stats._record(start, end)
        return out

    inflight: deque[tuple[T, Future]] = deque()
    it = iter(items)

    def drain_one() -> Iterator[tuple[T, R]]:
        item, fut = inflight.popleft()
        try:
            with _TR.span("chunk", "fetch", stage="wait", hist=_H_WAIT):
                out = fut.result()
        except Exception as e:
            if on_error == "raise" or isinstance(e, BreakerOpenError):
                raise
            if isinstance(e, NotFoundError):
                logger.debug("fetch %s: %s", item, e)
            else:
                logger.warning("fetch %s: %s", item, e)
        else:
            yield item, out

    try:
        for item in it:
            inflight.append((item, pool.submit(timed, item)))
            if len(inflight) >= window:
                yield from drain_one()
        while inflight:
            yield from drain_one()
    finally:
        # error or abandoned generator: don't leave queued work behind
        for _, fut in inflight:
            fut.cancel()
