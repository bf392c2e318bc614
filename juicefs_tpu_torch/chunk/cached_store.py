"""Cached chunk store (a copy of juicefs_tpu/chunk/cached_store.py; reference
pkg/chunk/cached_store.go).

Write path (reference cached_store.go:282-516): slice data accumulates in
per-block buffers; full blocks upload asynchronously on a worker pool
(optionally staged to disk first for writeback mode); `finish` is the
commit barrier that waits for every block. `ChunkConfig.buffer_size`
(mount `--buffer-size`) bounds the bytes handed to the upload and not yet
durable, store-wide: a writer waits in `WSlice._upload_block` while a
block would take them past it (upstream waits in pkg/vfs/writer.go
`fileWriter.Write` on `usedBufferSize`); staged writeback blocks, acked
from disk, are not counted.

Read path (reference cached_store.go:96-204,673-749): cache lookup →
singleflight load (ranged GET, or full-block GET when compressed) →
populate cache → prefetch the next block.

Block object key (reference cached_store.go:73-78), byte-identical to the
JAX package's so either package reads a volume the other wrote:
    chunks/{id//1e6}/{id//1e3}/{id}_{indx}_{bsize}

Changes from the reference: `ChunkConfig.compress_backend` defaults to
`cuda` (the compress plane's estimator on the card), and
`ChunkConfig.device` names the store's one device: the compress plane
checks it at construction (None: the process-wide sharding plane over
every card, which must exist) and an
`IngestPipeline` attached to the store hashes there unless it is given a
device of its own. The estimate itself is computed by the hash of the
shared pack, where it was uploaded, so the two can never disagree into a
second upload.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..compress import new_compressor
from ..gpu.compress_batch import CompressBatchConfig, CompressPlane
from ..metric import global_registry
from ..metric.trace import global_tracer, stage_hist
from ..object.interface import NotFoundError, ObjectStorage
from ..object.metered import metered
from ..object.resilient import (
    BreakerOpenError,
    CircuitBreaker,
    ErrorClass,
    RetryPolicy,
    record_retry,
    resilient,
)
from ..qos import IOClass, Limiter, gated, global_scheduler, shaped
from ..utils import get_logger
from .disk_cache import CacheManager, DiskCache
from .mem_cache import MemCache
from .parallel import fetch_ordered
from .prefetch import Prefetcher
from .singleflight import SingleFlight

logger = get_logger("chunk.store")

_TR = global_tracer()
_H_READ = stage_hist("chunk", "read", "total")
_H_FETCH = stage_hist("chunk", "load", "fetch")
_H_UPLOAD = stage_hist("chunk", "upload", "put")
_H_STAGE = stage_hist("chunk", "upload", "stage")
_H_PACK = stage_hist("chunk", "upload", "pack")
_H_COMPRESS = stage_hist("chunk", "upload", "compress")
_H_BUFFER_WAIT = stage_hist("chunk", "write", "buffer_wait")
_H_FINISH = stage_hist("chunk", "write", "finish")
# elided-block memo bound: ~150 B an entry, so ~10 MiB at the cap
_CANONICALS_MAX = 1 << 16

# staging backlog gauges (reference juicefs_staging_blocks/bytes) aggregate
# over every live store — weak refs so a gauge closure never pins a
# discarded store (gc/fsck builds then drops one) and multiple mounts sum
_LIVE_STORES: "weakref.WeakSet[CachedStore]" = weakref.WeakSet()


def _sum_staging(fn) -> float:
    total = 0
    try:
        for s in list(_LIVE_STORES):
            total += fn(s)
    except Exception as e:
        # racing a store teardown must never break a scrape
        logger.debug("staging gauge raced a teardown: %s", e)
    return total


class _SpilledStaged:
    """A staged block whose raw bytes were evicted from RAM past the
    `staged_mem_bytes` cap: only the staging-file path is pinned; replay
    and staged reads re-read the file (a long
    brownout must not grow `_pending_staged` without bound)."""

    __slots__ = ("path", "size")

    def __init__(self, path: str, size: int):
        self.path = path
        self.size = size


def _staged_len(v) -> int:
    return v.size if isinstance(v, _SpilledStaged) else len(v)


global_registry().gauge(
    "juicefs_staging_blocks", "Blocks staged for writeback upload"
).set_function(lambda: _sum_staging(lambda s: len(s._pending_staged)))
global_registry().gauge(
    "juicefs_staging_bytes", "Bytes staged for writeback upload"
).set_function(lambda: _sum_staging(
    lambda s: sum(_staged_len(v) for v in list(s._pending_staged.values()))
))
global_registry().gauge(
    "juicefs_staging_mem_bytes",
    "Staged raw bytes currently pinned in RAM (the rest spilled to "
    "staging files)",
).set_function(lambda: _sum_staging(lambda s: s._staged_mem))

# shared zero source for block padding: extending a bytearray still copies,
# but the pad SOURCE is allocated once instead of a fresh ~4 MiB zeros
# object per short block
_ZERO_CHUNK = bytes(1 << 20)


def _zero_pad(buf: bytearray, n: int) -> None:
    mv = memoryview(_ZERO_CHUNK)
    while n > 0:
        step = min(n, len(_ZERO_CHUNK))
        buf += mv[:step]
        n -= step


def block_key(sid: int, indx: int, bsize: int) -> str:
    return f"chunks/{sid // 1_000_000}/{sid // 1_000}/{sid}_{indx}_{bsize}"


def parse_block_key(key: str) -> Optional[tuple[int, int, int]]:
    """chunks/a/b/{id}_{indx}_{bsize} -> (id, indx, bsize)"""
    if not key.startswith("chunks/"):
        return None
    base = key.rsplit("/", 1)[-1]
    parts = base.split("_")
    if len(parts) != 3:
        return None
    try:
        return int(parts[0]), int(parts[1]), int(parts[2])
    except ValueError:
        return None


@dataclass
class ChunkConfig:
    block_size: int = 4 << 20
    compress: str = ""
    cache_dirs: tuple[str, ...] = ("memory",)
    cache_size: int = 1 << 30
    writeback: bool = False
    max_upload: int = 4
    max_download: int = 8
    max_retries: int = 10
    prefetch: int = 2  # 0 disables readahead; >0 concurrency is
    #                    scheduler-governed (PREFETCH class)
    # object-plane resilience (object/resilient.py): per-op wall budget,
    # per-attempt abandonment bound, hedged GETs.  retry_policy/breaker
    # override the scalar knobs wholesale (tests, tuned deployments).
    op_deadline: float = 60.0
    attempt_timeout: Optional[float] = None
    hedge: bool = True
    hedge_delay: Optional[float] = None  # None = auto from live p95
    retry_policy: Optional["RetryPolicy"] = None
    breaker: Optional["CircuitBreaker"] = None
    # hook for the fingerprint plane: called with (key, raw_block)
    # on every upload; None disables
    fingerprint: Optional[Callable[[str, bytes], None]] = None
    # cap on staged raw bytes pinned in RAM; entries past it spill to
    # their staging files and are re-read at replay
    staged_mem_bytes: int = 128 << 20
    # QoS: bandwidth caps in BYTES/s charged at the object
    # boundary (0 = unshaped); `limiter` overrides both (shared budget
    # across stores, per-class sub-buckets).  `scheduler` overrides the
    # process-global unified scheduler (isolated tests).
    upload_limit: float = 0.0
    download_limit: float = 0.0
    limiter: Optional["Limiter"] = None
    scheduler: Optional[object] = None
    # batched compression plane: backend registry cuda|cpu (a
    # reference volume's xla maps to cuda) and encode-lane width on the
    # qos slice lane (0 = host cores)
    compress_backend: str = "cuda"
    compress_lanes: int = 0
    # the store's device, for the cuda compress plane and (by default) an
    # attached IngestPipeline: None = the sharding plane over every card
    # (gpu/sharding.py get_plane; raises without one);
    # "cpu" = the plain torch path (tests)
    device: Optional[object] = None
    # adaptive elision bypass (chunk/bypass.py) on --inline-dedup mounts:
    # sample the live dup density and skip hash+lookup when it is low
    dedup_bypass: bool = True
    # write buffer bound in bytes (mount --buffer-size, reference
    # pkg/vfs/writer.go usedBufferSize): a writer waits before handing a
    # block to the upload while the store's handed-off, not yet durable
    # bytes would pass it; 0 = unbounded
    buffer_size: int = 0


class TornDataError(IOError):
    """The backend 'succeeded' but returned the wrong number of bytes
    (truncated transfer, flaky proxy).  Retried by the chunk layer's own
    loop — the resilience wrapper below only sees clean responses."""


class CachedStore:
    """reference cached_store.go:636 cachedStore / NewCachedStore:751"""

    def __init__(self, storage: ObjectStorage, config: ChunkConfig | None = None):
        self.conf = config or ChunkConfig()
        # canonical wrapper stack (both idempotent): resilience above
        # metering — each attempt/hedge is individually metered, and the
        # hedge delay reads the live per-backend GET histogram
        policy = self.conf.retry_policy or RetryPolicy(
            deadline=self.conf.op_deadline,
            max_attempts=max(1, self.conf.max_retries),
            attempt_timeout=self.conf.attempt_timeout,
        )
        # bandwidth shaping, split across resilience: `gated`
        # ABOVE it waits for tokens once per logical op (a gate wait must
        # never count against the hedge delay, the attempt deadline or
        # the breaker — a saturated cap is not a failing backend), while
        # `shaped` BELOW it bills every retry/hedge attempt against the
        # debt bucket; metering stays innermost so the latency
        # histograms the hedge delay reads stay token-wait-free
        self.limiter = self.conf.limiter
        if self.limiter is None and (self.conf.upload_limit
                                     or self.conf.download_limit):
            self.limiter = Limiter(upload_bps=self.conf.upload_limit,
                                   download_bps=self.conf.download_limit)
        self.storage = gated(resilient(
            shaped(metered(storage), self.limiter),
            policy=policy, breaker=self.conf.breaker,
            hedge=self.conf.hedge, hedge_delay=self.conf.hedge_delay,
        ), self.limiter)
        # degradation ladder, recovery rung: when the breaker resets,
        # replay every block that degraded writes parked in staging
        self.storage.breaker.on_reset(self._replay_staged)
        self.compressor = new_compressor(self.conf.compress)
        if self.conf.cache_dirs == ("memory",):
            self.cache = MemCache(self.conf.cache_size)
            self.cache_tier = "mem"
        else:
            self.cache = CacheManager(list(self.conf.cache_dirs), self.conf.cache_size)
            self.cache_tier = "disk"
        # unified I/O scheduler: every pool this store used to
        # own is now a (lane, class) slice of the shared scheduler —
        # foreground reads/writes outrank prefetch/ingest outrank bulk
        # background work, with per-tenant DRR fairness inside a class.
        # The executors own only this store's submissions: close() drains
        # them without stopping workers other stores share.
        sched = self.conf.scheduler or global_scheduler()
        self.scheduler = sched
        # batched compression plane: the write path's only
        # compress seam — `_put_block` encodes through it, the ingest
        # finalizer feeds it whole MISS batches (slice-lane fan-out)
        self.compress_plane = CompressPlane(
            self.compressor,
            CompressBatchConfig(backend=self.conf.compress_backend,
                                lanes=self.conf.compress_lanes),
            scheduler=sched,
            device=self.conf.device,
        )
        self._pool = sched.executor(
            "upload", IOClass.FOREGROUND, width=self.conf.max_upload)
        # ingest-stage canonical PUTs (chunk/ingest.py leader uploads)
        self._ingest_pool = sched.executor(
            "upload", IOClass.INGEST, width=self.conf.max_upload)
        # staged-backlog replay + crash recovery re-uploads (the ladder
        # contract: degraded-mode staging stays foreground on the
        # caller thread, REPLAY is background)
        self._replay_pool = sched.executor("upload", IOClass.BACKGROUND)
        # per-read block fan-out (reference reader.go:160 async slice
        # workers)
        self._rpool = sched.executor(
            "download", IOClass.FOREGROUND, width=self.conf.max_download)
        # bulk block paths (fill_cache/warmup, slice removal sweeps)
        self._bulk_pool = sched.executor("download", IOClass.BACKGROUND)
        self._group = SingleFlight()
        self._fetcher = Prefetcher(
            self._prefetch_block,
            executor=sched.executor("download", IOClass.PREFETCH),
            workers=self.conf.prefetch,
        )
        self._pending_lock = threading.Lock()
        # writeback backlog: key -> raw bytes, or _SpilledStaged past the
        # staged_mem_bytes RAM cap (re-read from the staging file)
        self._pending_staged: dict[str, object] = {}
        self._staged_mem = 0  # raw bytes currently pinned in RAM
        # write buffer account (conf.buffer_size): bytes of blocks handed
        # to the ingest stage or the upload pool whose futures are not
        # done; writers wait on the condition, done-callbacks signal it
        self._handed_off = 0
        self._handoff_cond = threading.Condition(threading.Lock())
        # content indexer (chunk/indexer.py), attached by cmd.build_store
        # when the volume has a hash_backend
        self.indexer = None
        # content-ref plane (chunk/ingest.py ContentRefs), attached by
        # build_store whenever a meta engine is available: resolves read
        # misses through aliases and decrefs deletes. `ingest` is the
        # inline-dedup stage itself (--inline-dedup mounts only).
        self.content_refs = None
        self.ingest = None
        # elided block key -> its canonical's key, as resolved. An elided
        # block's bytes are cached, fetched and asked of peers under the
        # canonical's key only; an alias's canonical does not change while
        # the alias lives, so the memo needs no invalidation but a delete's
        self._canonicals: OrderedDict[str, str] = OrderedDict()
        self._canonicals_lock = threading.Lock()
        # cache group (cache/group.py), attached by cmd/mount or tests:
        # the peer rung between the local cache and the object store
        self.cache_group = None
        _LIVE_STORES.add(self)
        if self.conf.writeback:
            self._recover_staging()

    # -- helpers -----------------------------------------------------------
    def _retry_torn(self, op: str, fn: Callable[[], object]):
        """Retry torn responses (TornDataError only).  Storage-level
        faults are classified and retried INSIDE the resilience wrapper
        (object/resilient.py); this loop covers the one failure the
        wrapper cannot see — a response that arrived whole-looking but
        fails the chunk layer's length validation."""
        policy = self.storage.policy
        attempts = max(1, self.conf.max_retries)
        for attempt in range(attempts):
            try:
                return fn()
            except TornDataError as e:
                if attempt + 1 >= attempts:
                    raise
                record_retry(op.split(" ", 1)[0], ErrorClass.TRANSIENT)
                logger.warning("%s torn (try %d): %s", op, attempt + 1, e)
                time.sleep(policy.backoff(attempt, ErrorClass.TRANSIENT))
        raise AssertionError("unreachable")  # pragma: no cover

    @property
    def degraded(self) -> bool:
        """True while the object backend's breaker is open (the store is
        running on the degradation ladder)."""
        return bool(getattr(self.storage, "degraded", False))

    def _put_block(self, key: str, raw: bytes, parent=None,
                   fingerprint: bool = True,
                   data: Optional[bytes] = None) -> None:
        """Compress (+fingerprint) and PUT one block
        (reference cached_store.go:371-413 upload). `parent` is the span
        ref captured before the upload-pool crossing. The ingest stage
        passes fingerprint=False — it already hashed the block and wrote
        the index row itself — and may carry `data`, the pre-compressed
        bytes from the finalizer's batched compress stage, so
        the PUT worker ships immediately instead of encoding inline."""
        with _TR.span("chunk", "upload", stage="put", hist=_H_UPLOAD,
                      parent=parent) as sp:
            if sp.active:
                sp.set(key=key, bytes=len(raw))
            if fingerprint and self.conf.fingerprint is not None:
                self.conf.fingerprint(key, raw)
            if data is None:
                with _TR.span("chunk", "upload", stage="compress",
                              hist=_H_COMPRESS) as csp:
                    if csp.active:
                        csp.set(key=key, bytes=len(raw))
                    data = self.compress_plane.compress_one(raw)
            self.storage.put(key, data)

    def _note_cache_hit(self, key: str, bsize: int) -> None:
        """Prefetch effectiveness: credit the prefetcher when a hit
        consumed a block it warmed."""
        self._fetcher.consumed((key, bsize))

    def _count_miss(self) -> None:
        """Record a block-cache miss on a path that bypasses _load_block
        (the ranged-GET shortcut fetches without an authoritative probe)."""
        from .mem_cache import _MISS

        _MISS.labels(self.cache_tier).inc()

    def _load_block(self, key: str, bsize: int, cache_after: bool = True,
                    parent=None, resolved: bool = False) -> bytes:
        """Singleflight full-block load (reference cached_store.go:673-749).
        An elided block loads as its canonical, under the canonical's key;
        `resolved` says `key` is already the key its bytes live under."""
        block = key
        key = self._cached_as(key)

        def do() -> bytes:
            cached = self.cache.load(key)
            if cached is not None:
                self._note_cache_hit(block, bsize)
                return cached
            staged = self._staged_lookup(key)
            if staged is not None:
                return staged

            # inline dedup: an elided block has no object of its own.
            # Resolve the alias before the peer and backend rungs and load
            # the canonical through the cache and the single-flight group
            # under ITS key, so a block and its aliases cost one GET of the
            # stored object (the reference GETs the block's own key first
            # and resolves on the NotFound). One content_resolve per cold
            # block the memo lacks; a store without the plane pays nothing.
            if not resolved:
                canonical = self._canonical_key(key)
                if canonical != key:
                    return self._load_block(canonical, bsize, cache_after,
                                            parent, resolved=True)

            # peer rung: the ring owner's cache, tried BEFORE
            # the backend and regardless of the backend breaker's state —
            # peer reads must keep serving through a backend outage.  A
            # dead/slow peer degrades (falls through) here; it never
            # fails the read.
            group = self.cache_group
            if group is not None:
                peer_data = group.fetch(key, bsize, parent=parent)
                if peer_data is not None:
                    if cache_after:
                        self.cache.cache(key, peer_data)
                    return peer_data

            def fetch() -> bytes:
                data = self.storage.get(key)
                raw = self.compressor.decompress(data, bsize)
                if len(raw) != bsize:
                    # short/over-long response (flaky backend, truncated
                    # transfer): retryable, NOT a permanent failure
                    raise TornDataError(
                        f"block {key}: expect {bsize} bytes, got {len(raw)}"
                    )
                return raw

            with _TR.span("chunk", "load", stage="fetch", hist=_H_FETCH,
                          parent=parent) as sp:
                if sp.active:
                    sp.set(key=key, bytes=bsize)
                # breaker open + cache miss: storage.get fails fast with
                # BreakerOpenError (EIO) — the ladder's bottom rung
                raw = self._retry_torn(f"GET {key}", fetch)
            if cache_after:
                self.cache.cache(key, raw)
            return raw

        return self._group.do(key, do)

    def _resolve_alias(self, key: str) -> Optional[str]:
        """Canonical block key for an elided (aliased) block, or None when
        the block is its own canonical, is untracked by the content-ref
        plane, or the store has no plane."""
        refs = self.content_refs
        if refs is None:
            return None
        try:
            return refs.resolve(key)
        except Exception as e:  # meta hiccup: surface the original miss
            logger.warning("alias resolve %s: %s", key, e)
            return None

    def _cached_as(self, key: str) -> str:
        """The key a block's bytes are cached and fetched under: its
        canonical's for an elided block already resolved, else its own.
        Reads the memo only, never meta."""
        return self._canonicals.get(key, key)

    def _canonical_key(self, key: str) -> str:
        """As _cached_as, resolving a block the memo lacks through the
        content-ref plane (one content_resolve; none without the plane)."""
        canonical = self._canonicals.get(key)
        if canonical is not None:
            return canonical
        canonical = self._resolve_alias(key)
        if canonical is None:
            return key
        with self._canonicals_lock:
            self._canonicals[key] = canonical
            if len(self._canonicals) > _CANONICALS_MAX:
                self._canonicals.popitem(last=False)
        return canonical

    @property
    def prefetcher(self) -> Prefetcher:
        """The speculative-warming stage (vfs readahead feedback reads
        its counters; benches settle on its outstanding count)."""
        return self._fetcher

    def _prefetch_block(self, key_size) -> bool:
        """Returns True only when this call actually warmed the block
        (Prefetcher credits juicefs_prefetch_used from that)."""
        key, bsize = key_size
        group = self.cache_group
        if self.degraded and group is None:
            # outage: warming would only burn EIO fast-fails (with a cache
            # group the peer rung may still warm us, so keep trying)
            return False
        # an elided block warms as its canonical, on the canonical's owner
        key = self._canonical_key(key)
        if self.cache.load(key, count_miss=False) is not None:
            return False
        if group is not None and not group.owns(key):
            # ring-aware warm placement: a block another member
            # owns warms THERE, not here — a local object GET would put a
            # second copy of the same bytes in the group and pay the
            # backend twice for it.  The hint enqueues on the owner's own
            # PREFETCH stage (bounded, sheddable); this member's later
            # demand read takes the peer rung in _load_block.
            group.warm(key)
            return False
        try:
            self._load_block(key, bsize, resolved=True)
            return True
        except (NotFoundError, BreakerOpenError):
            pass
        return False

    # -- public API (reference chunk.go:37-46 ChunkStore) ------------------
    def _block_range(self, sid: int, length: int, off: int = 0, size: int | None = None):
        """Yield (key, bsize) for every block of slice `sid` covering
        [off, off+size) (default: the whole slice). Zero-length slices yield
        their single empty block."""
        bs = self.conf.block_size
        if length <= 0:
            yield block_key(sid, 0, 0), 0
            return
        end = length if size is None else min(length, off + size)
        for indx in range(off // bs, (end + bs - 1) // bs):
            bsize = min(bs, length - indx * bs)
            if bsize > 0:
                yield block_key(sid, indx, bsize), bsize

    def prefetch(self, sid: int, length: int, off: int = 0, size: int | None = None) -> None:
        """Warm the blocks of slice `sid` covering [off, off+size) via the
        prefetch pool (used by the VFS readahead; reference prefetch.go).
        Already-cached blocks are skipped HERE (an index probe, no bytes
        read even on the disk tier): issuing them would churn the queue
        and dilute the used/issued ratio the readahead window feedback
        steers by."""
        for key, bsize in self._block_range(sid, length, off, size):
            if bsize > 0 and not self.cache.contains(self._cached_as(key)):
                self._fetcher.fetch((key, bsize))

    def new_writer(self, sid: int) -> "WSlice":
        return WSlice(self, sid)

    def new_reader(self, sid: int, length: int) -> "RSlice":
        return RSlice(self, sid, length)

    def remove(self, sid: int, length: int) -> int:
        """Delete every block of a slice; DELETEs run in parallel on the
        download pool.  A NotFoundError is idempotent success (the block
        was already gone — retries, crashed removals, racing gc), so only
        real backend failures are logged and counted.  Returns the number
        of real failures.

        With a content-ref plane attached (inline dedup), every
        block is decref'd in one meta transaction first: a block whose
        content other blocks still reference keeps its canonical object
        alive ("released" — zero backend calls); the FINAL reference
        deletes the canonical, which may be a different key when an alias
        outlived its canonical's own slice."""
        keys = [key for key, _ in self._block_range(sid, length)]
        # per-key physical delete target: own key (untracked/dangling),
        # the canonical key (last ref), or None (refs remain)
        targets: dict[str, Optional[str]] = {k: k for k in keys}
        refs = self.content_refs
        if refs is not None:
            try:
                released = refs.release(keys)
            except Exception as e:
                # meta down: fall back to name-based deletes — aliased
                # blocks' objects don't exist (idempotent NotFound) and a
                # canonical deleted early is caught by gc reconciliation
                logger.warning("content decref slice %d: %s", sid, e)
                released = [("untracked", None)] * len(keys)
            for key, (disp, canonical) in zip(keys, released):
                if disp == "released":
                    targets[key] = None
                elif disp == "last":
                    targets[key] = canonical

        def drop(key: str) -> int:
            self.cache.remove(key)
            with self._canonicals_lock:
                self._canonicals.pop(key, None)
            self._unpark_staged(key)
            target = targets.get(key, key)
            if target is None:
                return 0  # content still referenced: PUT-elided delete
            try:
                self.storage.delete(target)
            except NotFoundError:
                pass
            except Exception as e:
                logger.warning("remove %s: %s", target, e)
                return 1
            return 0

        return sum(failed for _, failed in fetch_ordered(
            keys, drop, self._bulk_pool, self.conf.max_download,
        ))

    def fill_cache(self, sid: int, length: int, only=None) -> None:
        """Warm every block of a slice (reference vfs/fill.go FillCache);
        loads overlap on the download pool, failures propagate.  `only`
        filters by the key a block's bytes live under — distributed warmup
        fills just the objects this member owns on the cache-group ring
        (cmd/warmup.py). An elided block belongs to its canonical's
        owner, so a fleet-wide warmup fetches each stored object once
        (the reference filters by the block's own key)."""

        def load(kb) -> None:
            key, bsize = kb
            if only is not None:
                key = self._canonical_key(key)
                if not only(key):
                    return
            self._load_block(key, bsize, resolved=only is not None)

        if length > 0:
            for _ in fetch_ordered(
                list(self._block_range(sid, length)), load,
                self._bulk_pool, self.conf.max_download,
            ):
                pass

    def check_cache(self, sid: int, length: int) -> int:
        """Number of cached blocks for a slice."""
        if length <= 0:
            return 0
        return sum(1 for key, _ in self._block_range(sid, length)
                   if any(self.cache.load(k, count_miss=False) is not None
                          for k in self._cache_keys(key)))

    def evict_cache(self, sid: int, length: int) -> None:
        if length > 0:
            for key, _ in self._block_range(sid, length):
                for k in self._cache_keys(key):
                    self.cache.remove(k)

    def _cache_keys(self, key: str):
        """The keys a block's bytes may be cached under: its own (a written
        block), then its canonical's when it is elided."""
        yield key
        canonical = self._canonical_key(key)
        if canonical != key:
            yield canonical

    @property
    def handed_off_bytes(self) -> int:
        """Bytes of blocks handed to the ingest stage or the upload pool
        whose uploads are not yet done (the write buffer account)."""
        return self._handed_off

    def _hand_off(self, nbytes: int) -> Callable[..., None]:
        """Enter `nbytes` into the write buffer account, first waiting
        while that would take it past `conf.buffer_size` (upstream's
        writer slow-down, woken by releases instead of fixed sleeps). A
        block larger than the bound goes once nothing else is in flight.
        Returns the release, a done-callback that acts once."""
        bound = self.conf.buffer_size
        cond = self._handoff_cond
        with cond:
            if bound > 0 and self._handed_off and self._handed_off + nbytes > bound:
                with _TR.span("chunk", "write", stage="buffer_wait",
                              hist=_H_BUFFER_WAIT) as sp:
                    if sp.active:
                        sp.set(bytes=nbytes, level=self._handed_off)
                    while self._handed_off and self._handed_off + nbytes > bound:
                        cond.wait()
            self._handed_off += nbytes
        held = [nbytes]

        def release(_fut=None) -> None:
            with cond:
                if held[0]:
                    self._handed_off -= held[0]
                    held[0] = 0
                    cond.notify_all()

        return release

    def flush_all(self, timeout: float = 60.0) -> None:
        """Drain pending writeback uploads (used by fsync paths and tests)."""
        deadline = time.time() + timeout
        if self.ingest is not None:
            # the ingest stage feeds the upload pool; drain it first so
            # its uploads land in _pending_staged accounting below
            self.ingest.flush(timeout)
        while time.time() < deadline:
            with self._pending_lock:
                drained = not self._pending_staged
            if drained:
                # outside the lock: draining the hash backlog may take a
                # while and must not stall stagers/readers on _pending_lock
                if self.indexer is not None:
                    self.indexer.flush(max(0.1, deadline - time.time()))
                return
            time.sleep(0.01)
        raise TimeoutError("writeback uploads did not drain")

    def release_cache_locks(self) -> None:
        """Release per-dir cache locks so a successor process can adopt
        the cache directories (seamless upgrade hands them over while the
        predecessor is still tearing down)."""
        close = getattr(self.cache, "close", None)
        if close is not None:
            close()

    def close(self) -> None:
        """Orderly shutdown: drain THIS store's scheduled work, free dir
        locks.  The executors own only this store's submissions, so
        closing them never stops unified-scheduler workers another live
        store shares."""
        if self.ingest is not None:
            try:
                self.ingest.close()  # stops feeding the pool before shutdown
            except Exception as e:
                logger.warning("ingest stage close failed: %s", e)
        self._pool.shutdown(wait=True)
        self._ingest_pool.shutdown(wait=True)
        self._replay_pool.shutdown(wait=True, timeout=60.0)
        self._fetcher.close()  # stop issuing new loads before teardown
        self._rpool.shutdown(wait=True, cancel_futures=True)
        self._bulk_pool.shutdown(wait=True, cancel_futures=True)
        self.compress_plane.close()
        if self.indexer is not None:
            try:
                self.indexer.close()
            except Exception as e:
                logger.warning("indexer close failed: %s", e)
        if self.cache_group is not None:
            try:
                self.cache_group.close()  # stop peer breaker probes
            except Exception as e:
                logger.warning("cache-group close failed: %s", e)
        try:  # resilience resources (probe thread, abandon pool) only —
            self.storage.close()  # the inner store belongs to its owner
        except Exception as e:
            logger.warning("storage close failed: %s", e)
        self.release_cache_locks()

    # -- staged-block bookkeeping (bounded RAM) ---------
    def _park_staged(self, key: str, raw: bytes, path: Optional[str]):
        """Track a staged block for replay. Raw bytes stay pinned in RAM
        up to `staged_mem_bytes`; past the cap (a long brownout piling up
        degraded writes) entries with a staging file keep only the path
        and are re-read at replay. Returns the parked value."""
        with self._pending_lock:
            if (path is not None
                    and self._staged_mem + len(raw) > self.conf.staged_mem_bytes):
                parked: object = _SpilledStaged(path, len(raw))
            else:
                parked = raw
                self._staged_mem += len(raw)
            prev = self._pending_staged.get(key)
            if prev is not None and not isinstance(prev, _SpilledStaged):
                self._staged_mem -= len(prev)  # overwrite: same key re-staged
            self._pending_staged[key] = parked
        return parked

    def _unpark_staged(self, key: str) -> None:
        with self._pending_lock:
            prev = self._pending_staged.pop(key, None)
            if prev is not None and not isinstance(prev, _SpilledStaged):
                self._staged_mem -= len(prev)

    def _staged_lookup(self, key: str) -> Optional[bytes]:
        """Raw bytes of a staged block (reads during writeback/outage);
        spilled entries re-read their staging file."""
        with self._pending_lock:
            v = self._pending_staged.get(key)
        return self._materialize_staged(key, v)

    def _materialize_staged(self, key: str, v) -> Optional[bytes]:
        import errno as _errno

        if v is None or not isinstance(v, _SpilledStaged):
            return v
        try:
            with open(v.path, "rb") as f:
                raw = f.read(v.size)  # uploaded() may trailer the file later
        except OSError as e:
            if e.errno == _errno.ENOENT:
                # staging file truly gone (cache dir cleaned): the entry
                # is unrecoverable — drop it so replay/flush don't spin
                logger.warning("spilled staged block %s lost (%s)",
                               key, v.path)
                self._unpark_staged(key)
            else:
                # transient read failure (EMFILE/EINTR/EIO): the file is
                # still there — KEEP the entry for a later replay; the
                # data was acked and must never be silently dropped
                logger.warning("spilled staged block %s unreadable (%s); "
                               "keeping for replay", key, e)
            return None
        if len(raw) != v.size:
            logger.warning("spilled staged block %s truncated", key)
            self._unpark_staged(key)
            return None
        return raw

    # -- writeback recovery ------------------------------------------------
    def _recover_staging(self) -> None:
        """Re-upload blocks staged before a crash
        (reference disk_cache.go:870 scanStaging + uploadStaging)."""
        for key, path in self.cache.scan_staging().items():
            try:
                with open(path, "rb") as f:
                    raw = f.read()
            except OSError:
                continue
            parsed = parse_block_key(key)
            if parsed is not None and len(raw) > parsed[2] > 0:
                # older versions trailered staging files in place during
                # uploaded(); a crash in that window left payload plus a
                # complete or partial trailer
                raw = DiskCache.strip_stale_trailer(raw, parsed[2])
                # rewrite the staged copy too, so uploaded() (which re-reads
                # the file) never enshrines the stale bytes in the cache
                self.cache.stage(key, raw)
            logger.warning("found staged block %s, uploading", key)
            parked = self._park_staged(key, raw, path)
            self._replay_pool.submit(self._upload_staged, key, parked)

    def _upload_staged(self, key: str, staged, parent=None) -> None:
        raw = self._materialize_staged(key, staged)
        if raw is None:
            return  # spilled entry lost its file; already dropped
        try:
            self._put_block(key, raw, parent)
            self.cache.uploaded(key, len(raw))
        except BreakerOpenError:
            # outage ladder: keep the block parked in staging — the
            # breaker-reset replay re-submits it (popping here would lose
            # the in-process copy and force a restart-scan to recover)
            logger.warning("upload %s deferred: breaker open", key)
            return
        except Exception:
            self._unpark_staged(key)
            raise
        self._unpark_staged(key)

    def _stage_degraded(self, key: str, raw: bytes) -> None:
        """Ladder rung 2: park an already-acked block in staging for the
        breaker-reset replay instead of failing it back to the caller."""
        path = self.cache.stage(key, raw)
        self._park_staged(key, raw, path)
        logger.warning("degraded write: %s staged for replay", key)

    def _put_or_stage(self, key: str, raw: bytes, parent=None) -> None:
        """Async upload worker for the non-writeback path: a breaker that
        opened mid-flight degrades the write to staging (ladder rung 2)
        instead of failing an already-acked buffer back to the caller."""
        try:
            self._put_block(key, raw, parent)
        except BreakerOpenError:
            self._stage_degraded(key, raw)

    def _replay_staged(self) -> None:
        """Breaker-reset hook: re-upload every block degraded writes (or
        a mid-outage writeback backlog) parked in `_pending_staged` —
        recovery must not wait for new traffic."""
        with self._pending_lock:
            items = list(self._pending_staged.items())
        if not items:
            return
        logger.warning("breaker reset: replaying %d staged blocks", len(items))
        for key, staged in items:
            try:
                # replay is BACKGROUND: healing the backlog must
                # not contend with the foreground traffic that resumed the
                # moment the breaker closed
                self._replay_pool.submit(self._upload_staged, key, staged)
            except RuntimeError:
                return  # pool already shut down: restart recovery owns it


class WSlice:
    """Writer for one slice (reference cached_store.go:262 wSlice)."""

    def __init__(self, store: CachedStore, sid: int):
        self.store = store
        self.id = sid
        self.bs = store.conf.block_size
        self._blocks: dict[int, bytearray] = {}
        self._length = 0
        self._futures: list[Future] = []
        self._releases: list[Callable[..., None]] = []  # write buffer account
        self._uploaded: set[int] = set()
        self._closed = False

    def write_at(self, data: bytes, off: int) -> int:
        """Copy into per-block page buffers (reference cached_store.go:282-325).

        Zero-copy fast path: a block-aligned write of exactly
        one full block from an immutable bytes object is ALIASED, not
        copied — on a 4 MiB block that memcpy costs as much CPU as the
        hash, and bytes can never be mutated under us. A later partial
        overwrite of the same block falls back by converting to a
        bytearray."""
        if self._closed:
            raise IOError("write after finish/abort")
        if (isinstance(data, bytes) and len(data) == self.bs
                and off % self.bs == 0):
            indx = off // self.bs
            if indx not in self._blocks and indx not in self._uploaded:
                self._blocks[indx] = data
                self._length = max(self._length, off + self.bs)
                return self.bs
        pos = off
        mv = memoryview(data)
        while mv:
            indx = pos // self.bs
            boff = pos % self.bs
            if indx in self._uploaded:
                raise IOError(f"block {indx} already uploaded (non-sequential flush)")
            buf = self._blocks.get(indx)
            if buf is None:
                buf = bytearray()
                self._blocks[indx] = buf
            elif isinstance(buf, bytes):
                # partial overwrite of a zero-copy aliased block: it
                # needs mutability now, so pay the copy here
                buf = bytearray(buf)
                self._blocks[indx] = buf
            n = min(len(mv), self.bs - boff)
            if boff == len(buf):
                # sequential append (the dominant shape): one copy, no
                # zero-fill pass
                buf += mv[:n]
            else:
                if boff + n > len(buf):
                    buf.extend(bytes(boff + n - len(buf)))
                buf[boff : boff + n] = mv[:n]
            mv = mv[n:]
            pos += n
        self._length = max(self._length, pos)
        return pos - off

    def flush_to(self, off: int) -> None:
        """Upload all blocks fully below `off` (reference FlushTo:482)."""
        for indx in sorted(self._blocks):
            if (indx + 1) * self.bs <= off and indx not in self._uploaded:
                self._upload_block(indx, self.bs)

    def _upload_block(self, indx: int, bsize: int) -> None:
        # keep the bytearray (or zero-copy aliased bytes): a bytes() copy
        # of every 4 MiB block would cost real bandwidth, and nothing
        # mutates it after the pop
        raw = self._blocks.pop(indx)
        if len(raw) < bsize:
            # pad from the shared zero source (no fresh multi-MiB zeros
            # object per short block); the pack span makes the cost of
            # short-block padding visible next to compress/put
            with _TR.span("chunk", "upload", stage="pack", hist=_H_PACK) as sp:
                if sp.active:
                    sp.set(sid=self.id, indx=indx, pad=bsize - len(raw))
                _zero_pad(raw, bsize - len(raw))
        self._uploaded.add(indx)
        key = block_key(self.id, indx, bsize)
        ref = _TR.current_ref()  # link pool-side upload spans to this write
        degraded = self.store.degraded
        if self.store.conf.writeback or degraded:
            # stage to disk, ack immediately, upload in background
            # (reference cached_store.go:415-472 writeback branch).  With
            # the breaker OPEN this branch is FORCED even without
            # --writeback: the write degrades to staging with zero backend
            # calls and the breaker-reset replay uploads it (the
            # degradation ladder).
            with _TR.span("chunk", "upload", stage="stage", hist=_H_STAGE) as sp:
                if sp.active:
                    sp.set(key=key, bytes=len(raw))
                path = self.store.cache.stage(key, raw)
            parked = self.store._park_staged(key, raw, path)
            if degraded:
                logger.warning("degraded write: %s staged for replay", key)
            elif path is not None:
                self.store._pool.submit(self.store._upload_staged, key, parked, ref)
            else:  # staging failed: fall back to sync-ish upload
                self._futures.append(
                    self.store._pool.submit(self.store._upload_staged, key, parked, ref)
                )
        else:
            # the write buffer bound: wait here, holding no lock of the
            # store's, until the store's handed-off bytes leave room
            release = self.store._hand_off(len(raw))
            # inline-dedup seam: with an ingest stage attached,
            # the block flows hash -> content-ref lookup -> elide-or-PUT;
            # without one it goes straight to the upload pool as before
            try:
                ingest = self.store.ingest
                if ingest is not None:
                    fut = ingest.submit(key, raw, ref)
                else:
                    fut = self.store._pool.submit(self.store._put_or_stage, key, raw, ref)
            except BaseException:
                release()
                raise
            self._releases.append(release)
            fut.add_done_callback(release)
            fut.add_done_callback(
                lambda f, k=key, r=raw: self.store.cache.cache(k, r) if not f.exception() else None
            )
            self._futures.append(fut)

    def finish(self, length: int) -> None:
        """Commit barrier: upload remaining blocks, wait for all
        (reference Finish:506)."""
        if length > 0:
            n_blocks = (length + self.bs - 1) // self.bs
            last_size = length - (n_blocks - 1) * self.bs
            for indx in range(n_blocks):
                if indx in self._uploaded:
                    continue
                if indx not in self._blocks:
                    self._blocks[indx] = bytearray()  # hole: zero-filled block
                self._upload_block(indx, last_size if indx == n_blocks - 1 else self.bs)
        errs = []
        # the commit barrier's wait on its blocks: hash, lookup, elision or
        # compress + PUT, whichever each block takes
        with _TR.span("chunk", "write", stage="finish", hist=_H_FINISH) as sp:
            if sp.active:
                sp.set(blocks=len(self._futures))
            if self.store.ingest is not None:
                # hash whatever the ingest stage buffered NOW instead of
                # waiting out its flush timeout
                self.store.ingest.kick()
            for fut in self._futures:
                e = fut.exception()
                if e is not None:
                    errs.append(e)
        # a done future's callbacks may still be running on its setter's
        # thread: release here too, so the account holds none of this
        # slice's blocks once finish returns
        for release in self._releases:
            release()
        self._closed = True
        if errs:
            raise errs[0]

    def abort(self) -> None:
        self._closed = True
        self._blocks.clear()
        for fut in self._futures:
            fut.cancel()
        self.store.remove(self.id, (max(self._uploaded, default=-1) + 1) * self.bs)


class RSlice:
    """Reader for one slice (reference cached_store.go:84 rSlice)."""

    def __init__(self, store: CachedStore, sid: int, length: int):
        self.store = store
        self.id = sid
        self.length = length
        self.bs = store.conf.block_size

    def _block_size(self, indx: int) -> int:
        return min(self.bs, self.length - indx * self.bs)

    def read(self, off: int, size: int, parent=None) -> bytes:
        """Ranged read within the slice (reference ReadAt:96-204).

        Multi-block spans fan the missed block loads out over the store's
        download pool and assemble in order (reference reader.go:160 async
        slice workers); singleflight dedups overlapping fetches. `parent`
        carries the span ref across the vfs slice fan-out pool.
        """
        with _TR.span("chunk", "read", hist=_H_READ, parent=parent) as sp:
            out = self._read(off, size, sp)
        return out

    def _read(self, off: int, size: int, sp) -> bytes:
        if off >= self.length or size <= 0:
            return b""
        size = min(size, self.length - off)
        indx, boff = divmod(off, self.bs)
        if boff + size <= self._block_size(indx):
            # fast path: one block, cache hit — return a zero-copy view
            # into the cached buffer (blocks are immutable once stored)
            bsize = self._block_size(indx)
            key = block_key(self.id, indx, bsize)
            # speculative probe: a miss here falls through to _load_block,
            # which re-probes and counts the miss exactly once
            cached = self.store.cache.load(self.store._cached_as(key),
                                           count_miss=False)
            if cached is not None:
                self.store._note_cache_hit(key, bsize)
                if sp.active:
                    sp.set(sid=self.id, bytes=size,
                           tier=self.store.cache_tier)
                return memoryview(cached)[boff : boff + size]
        if sp.active:
            sp.set(sid=self.id, bytes=size)
        # plan the block segments covering [off, off+size)
        segs: list[tuple[int, int, int, int]] = []  # (indx, bsize, boff, n)
        pos = off
        end = off + size
        while pos < end:
            indx = pos // self.bs
            boff = pos % self.bs
            bsize = self._block_size(indx)
            n = min(end - pos, bsize - boff)
            segs.append((indx, bsize, boff, n))
            pos += n

        loads: dict[int, Future] = {}
        warm: dict[int, bytes] = {}
        if len(segs) > 1:
            # dispatch every uncached block load up front, in parallel
            # (keeping probe hits so warm blocks are read exactly once);
            # the span ref crosses the download pool explicitly
            ref = _TR.current_ref()
            for indx, bsize, _boff, _n in segs:
                key = block_key(self.id, indx, bsize)
                cached = self.store.cache.load(self.store._cached_as(key),
                                               count_miss=False)
                if cached is not None:
                    self.store._note_cache_hit(key, bsize)
                    warm[indx] = cached
                else:
                    loads[indx] = self.store._rpool.submit(
                        self.store._load_block, key, bsize, True, ref
                    )
            if loads:
                # sequential readahead: warm the block after the last
                # segment, mirroring the single-segment miss branch (large
                # streaming reads are exactly the case that wants it)
                nindx = segs[-1][0] + 1
                if nindx * self.bs < self.length:
                    nsize = self._block_size(nindx)
                    self.store._fetcher.fetch((block_key(self.id, nindx, nsize), nsize))

        out = bytearray()
        for indx, bsize, boff, n in segs:
            fut = loads.get(indx)
            if fut is not None:
                out += fut.result()[boff : boff + n]
                continue
            key = block_key(self.id, indx, bsize)
            # single-segment reads already probed the cache on the fast
            # path above, so a miss here is definitive — no re-probe
            cached = warm.get(indx)
            if cached is not None:
                out += cached[boff : boff + n]
            else:
                small = n < bsize // 4 and self.store.compressor.name == ""
                if small:
                    # partial GET without caching (reference: range read path)
                    staged = self.store._staged_lookup(key)
                    if staged is not None:
                        out += staged[boff : boff + n]
                    else:
                        # this shortcut skips _load_block, so the miss the
                        # speculative probe above suppressed lands here
                        self.store._count_miss()
                        def ranged(k=key, o=boff, ln=n) -> bytes:
                            target = self.store._cached_as(k)
                            try:
                                data = self.store.storage.get(target, o, ln)
                            except NotFoundError:
                                # elided block seen first here: ranged-read
                                # its canonical. GET first, so a block that
                                # is its own object pays no meta read
                                canonical = self.store._canonical_key(k)
                                if canonical == target:
                                    raise
                                data = self.store.storage.get(canonical, o, ln)
                            if len(data) != ln:
                                # short read: retry, never return torn data
                                raise TornDataError(
                                    f"ranged GET {k}[{o}:{o+ln}]: got "
                                    f"{len(data)} bytes"
                                )
                            return data

                        out += self.store._retry_torn(
                            f"GET {key}[{boff}:{boff+n}]", ranged
                        )
                else:
                    raw = self.store._load_block(key, bsize)
                    out += raw[boff : boff + n]
                # prefetch the next block of this slice
                if (indx + 1) * self.bs < self.length:
                    nsize = self._block_size(indx + 1)
                    self.store._fetcher.fetch((block_key(self.id, indx + 1, nsize), nsize))
        return bytes(out)
