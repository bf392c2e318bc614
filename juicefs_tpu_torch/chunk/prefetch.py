"""Prefetcher: speculative block warming (a copy of
juicefs_tpu/chunk/prefetch.py; reference pkg/chunk/prefetch.go:21-66).

The prefetcher owns no worker threads: fetches submit to the
unified I/O scheduler at PREFETCH class (qos/scheduler.py), which ranks
them below foreground reads — a readahead burst can no longer displace the
read it was meant to accelerate — and SHEDS them on a full class queue
(the cheap outcome of an overdriven window is a later cache miss, not
backpressure on the read path).

Effectiveness accounting: every accepted fetch counts as *issued*; a
fetch that actually loaded a block (not already cached, object present)
counts as *warmed*; when a later cache hit consumes a block this
prefetcher warmed (the store calls `consumed()` on its hit paths), it
counts as *used*.  The counters are ALSO kept per
instance and fed back into readahead sizing: `FileReader` reads
`counters()` deltas and stops growing (or shrinks) a window whose
used/issued ratio shows the speculation is being wasted — the window
doubler no longer grows blind.
"""

from __future__ import annotations

import threading
from typing import Callable, Hashable, Optional

from ..metric import global_registry
from ..metric.trace import global_tracer, stage_hist
from ..utils import get_logger

logger = get_logger("chunk.prefetch")

_reg = global_registry()
_ISSUED = _reg.counter(
    "juicefs_prefetch_issued", "Prefetch requests accepted onto the queue"
)
_DUP = _reg.counter(
    "juicefs_prefetch_duplicates", "Prefetch requests already pending (skipped)"
)
_DROPPED = _reg.counter(
    "juicefs_prefetch_dropped", "Prefetch requests dropped on a full queue"
)
_USED = _reg.counter(
    "juicefs_prefetch_used", "Prefetched blocks later served from cache"
)
_WARMED = _reg.counter(
    "juicefs_prefetch_warmed",
    "Prefetch fetches that actually loaded a block (not already cached)",
)
_TR = global_tracer()
_H_FETCH = stage_hist("chunk", "prefetch", "fetch")

_WARMED_CAP = 4096  # bounded issued-block memory for used-accounting


class Prefetcher:
    def __init__(self, fetch: Callable[[Hashable], None], workers: int = 2,
                 depth: int = 64, executor=None):
        """`executor` is a PREFETCH-class ClassExecutor; without one the
        process-global scheduler's download lane is used (widened to at
        least `workers`).  `depth` bounds this prefetcher's outstanding
        fetches on top of the scheduler's own PREFETCH queue bound.
        `workers=0` disables readahead entirely (`ChunkConfig.prefetch`'s
        off switch — concurrency above zero is scheduler-governed now,
        but OFF must still mean zero speculative GETs)."""
        self._enabled = workers != 0
        if executor is None and self._enabled:
            from ..qos import IOClass, global_scheduler

            executor = global_scheduler().executor(
                "download", IOClass.PREFETCH, width=max(2, workers))
        self._ex = executor
        self._fetch = fetch
        self._depth = max(1, depth)
        self._pending: set[Hashable] = set()
        self._warmed: dict[Hashable, None] = {}  # insertion-ordered FIFO
        self._lock = threading.Lock()
        # instance counters (the window-feedback signal): the
        # process-global metrics aggregate every store; a FileReader
        # sizing ITS window needs the owning store's ratio
        self._n_issued = 0
        self._n_warmed = 0
        self._n_used = 0
        self._n_dropped = 0

    @property
    def depth(self) -> int:
        """Outstanding-fetch bound: the natural ceiling for a streaming
        readahead window in blocks (enqueueing past it only sheds)."""
        return self._depth

    @property
    def outstanding(self) -> int:
        """Fetches issued but not yet finished (bench/test settling)."""
        with self._lock:
            return len(self._pending)

    def counters(self) -> tuple[int, int, int, int]:
        """(issued, warmed, used, dropped) cumulative for THIS instance.
        Callers compute deltas between snapshots for a live ratio."""
        with self._lock:
            return (self._n_issued, self._n_warmed, self._n_used,
                    self._n_dropped)

    def fetch(self, key: Hashable) -> None:
        if not self._enabled:
            return  # readahead off: not a shed, just no warming
        with self._lock:
            if key in self._pending:
                _DUP.inc()
                return
            if len(self._pending) >= self._depth:
                _DROPPED.inc()
                self._n_dropped += 1
                return
            self._pending.add(key)
        fut = None
        try:
            fut = self._ex.submit(self._run_one, key)
        except Exception as e:
            # RuntimeError: racing close() — the owner no longer wants
            # warming.  TimeoutError: scheduler backpressure leaked out of
            # a demoted submit.  Anything else is equally a shed:
            # speculative warming must never stall or fail the caller,
            # and the key must leave _pending on EVERY failure or it is
            # deduplicated forever and never fetched again
            # (claim-rollback: the reservation must not leak)
            logger.debug("prefetch submit shed %s: %s", key, e)
            with self._lock:
                self._pending.discard(key)
        if fut is None:
            # scheduler shed it (full PREFETCH queue -> submit returned
            # None), racing close, or the submit raised above (the
            # re-discard is an idempotent no-op then)
            _DROPPED.inc()
            with self._lock:
                self._pending.discard(key)
                self._n_dropped += 1
        else:
            _ISSUED.inc()
            with self._lock:
                self._n_issued += 1

    def consumed(self, key: Hashable) -> None:
        """A cache hit consumed this block; count it as prefetch-used if
        this prefetcher warmed it (pops so each warm counts once)."""
        if not self._warmed:  # unlocked fast-out: hot hit path, no
            return            # prefetch outstanding (races only under-count)
        with self._lock:
            if self._warmed.pop(key, 0) is None:
                _USED.inc()
                self._n_used += 1

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Stop warming: queued fetches are cancelled, in-flight ones are
        waited out (bounded) — close means the owner no longer wants the
        cache warmed, and a backlog against a slow backend must not stall
        teardown."""
        if self._ex is not None:
            self._ex.shutdown(wait=True, cancel_futures=True,
                              timeout=timeout)

    def _run_one(self, key: Hashable) -> None:
        try:
            # (the store's fetch callable skips outright while its
            # backend breaker is open — warming a dead backend would
            # only queue EIO fast-fails; see CachedStore._prefetch_block)
            with _TR.span("chunk", "prefetch", stage="fetch",
                          hist=_H_FETCH) as sp:
                if sp.active:
                    sp.set(key=str(key))
                did = self._fetch(key)
            # only fetches that actually warmed something earn used-
            # credit: a truthy return from the fetch callable; no-ops
            # (already cached, object missing) must not inflate
            # juicefs_prefetch_used
            if did:
                _WARMED.inc()
                with self._lock:
                    self._n_warmed += 1
                    self._warmed[key] = None
                    while len(self._warmed) > _WARMED_CAP:
                        self._warmed.pop(next(iter(self._warmed)))
        except Exception as e:
            # speculative load failed (backend hiccup past the breaker
            # guard): the cost is a later demand miss, but it must be
            # visible — a silently failing prefetch plane looks exactly
            # like a working one from the read path
            logger.debug("prefetch of %s degraded: %s", key, e)
        finally:
            with self._lock:
                self._pending.discard(key)
