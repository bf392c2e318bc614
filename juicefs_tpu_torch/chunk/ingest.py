"""Inline ingest dedup: PUT elision on the write path, hashed on the card (a
copy of juicefs_tpu/chunk/ingest.py).

The stage between `WSlice._upload_block` and the upload pool. Outgoing
blocks are batched through the JTH-256 hash plane (gpu/pipeline.py
HashBatcher: device-sized batches with a flush timeout so a lone block's
commit barrier never waits out a batch window), then the digest is looked
up in the meta engine's content-ref plane:

  hit  -> the store already holds these bytes under a canonical block.
          One transaction increfs the ref row and records an alias for
          this block; compress + PUT are SKIPPED entirely (zero backend
          calls for the duplicate — Venti's content-addressed write
          elision, Quinlan & Dorward FAST '02, grafted onto slice-id
          block naming via the alias plane).
  miss -> compress + PUT exactly as before, then register the digest so
          later duplicates elide against this block. A register that
          finds the row already present lost a cross-client race: it
          increfs instead, the redundant object is deleted best-effort,
          and the block becomes an alias of the winner.

Overload contract (same as chunk/indexer.py, per Zhu et al. FAST '08:
inline fingerprinting must never throttle ingest): `submit` NEVER blocks.
A full hash queue, a hash failure, or a meta failure all degrade the
block to the plain upload path (counted as passthrough/errors) — elision
is an optimization, durability never waits for it.

Changes from the reference: the default backend is `cuda`, and `device=`
is where it runs (None: the store's `ChunkConfig.device`, and where that
is None too, the process-wide sharding plane over every card; without one
construction raises instead of falling back to the CPU; `plane=` gives a
plane of its own). Backend names go through `pipeline_backend`, so a
reference mount's `xla` hashes on `cuda`. One packed placement per hash
batch (`shard_packed`, through the sharding plane) feeds both the
row-chain kernel and the compress plane's estimate, on the worker
thread's stream: the sharding plane hashes and estimates the batch where
it lies (`hash_packed(..., advise=True)`), and the compress plane records
the advisories (`estimate_packed`). A failed upload, hash or estimate
still degrades instead of failing a write, but it is logged at WARNING
and counted: the batch's blocks in `errors` and `passthrough`, the
estimate in the compress plane's `degraded`, after which the plane stops
estimating.

Crash windows (repaired offline by `gc --dedup`, cmd/gc.py):
  - elide committed (incref txn) but the slice never commits to meta:
    the alias row is orphaned; reconciliation decrefs it.
  - PUT succeeded but register never ran: the content is simply not
    elidable yet; gc's backfill registers existing blocks.
"""

from __future__ import annotations

import threading
import weakref
from concurrent.futures import Future, InvalidStateError
from typing import Optional

from ..metric import global_registry
from ..metric.trace import global_tracer, stage_hist
from ..object.resilient import BreakerOpenError
from ..utils import get_logger
from .bypass import ElisionGovernor
from .cached_store import block_key, parse_block_key

logger = get_logger("chunk.ingest")

_TR = global_tracer()
_H_HASH = stage_hist("chunk", "ingest", "hash")
_H_LOOKUP = stage_hist("chunk", "ingest", "lookup")
_H_REGISTER = stage_hist("chunk", "ingest", "register")
# host packing plus the one shared upload of a hash batch
_H_PACK = stage_hist("chunk", "ingest", "pack")
# inside it, the host pack alone: the same stage as the gc scan's pack
_H_HOST_PACK = stage_hist("gpu", "hash", "pack")
# the worker's busy time per batch, the record of the advisories its hash
# computed, and the wait on an earlier batch's in-flight register of the
# same content
_H_PROCESS = stage_hist("chunk", "ingest", "process")
_H_ESTIMATE = stage_hist("chunk", "ingest", "estimate")
_H_AWAIT = stage_hist("chunk", "ingest", "await")
# the finalizer-side batched encode reports under the same stage as the
# per-block compress in `_put_block`: either way it is write-path
# compression wall (bench stage breakdowns compare across rounds)
_H_COMPRESS = stage_hist("chunk", "upload", "compress")

_reg = global_registry()
_BLOCKS = _reg.counter(
    "juicefs_ingest_blocks", "Blocks entering the inline-dedup ingest stage"
)
_BYTES = _reg.counter(
    "juicefs_ingest_bytes", "Raw bytes entering the ingest stage"
)
_ELIDED = _reg.counter(
    "juicefs_ingest_put_elided",
    "Duplicate blocks whose compress+PUT was skipped (alias recorded)",
)
_ELIDED_BYTES = _reg.counter(
    "juicefs_ingest_put_elided_bytes", "Raw bytes of elided duplicate PUTs"
)
_UPLOADED = _reg.counter(
    "juicefs_ingest_uploaded", "Blocks uploaded as new canonical content"
)
_PASSTHROUGH = _reg.counter(
    "juicefs_ingest_passthrough",
    "Blocks bypassing dedup (hash plane saturated or degraded) and "
    "uploaded directly",
)
_RACE_COLLAPSED = _reg.counter(
    "juicefs_ingest_race_collapsed",
    "Concurrent-writer races collapsed: our upload found the digest "
    "already registered and became an alias",
)
_ERRORS = _reg.counter(
    "juicefs_ingest_errors",
    "Hash/meta failures degraded to the plain upload path",
)

# queue-depth gauge aggregates over live pipelines via weak refs (same
# pattern as chunk/indexer.py: closures must not pin discarded stages)
_LIVE_PIPELINES: "weakref.WeakSet[IngestPipeline]" = weakref.WeakSet()


def _queued_blocks() -> int:
    total = 0
    try:
        for p in list(_LIVE_PIPELINES):
            total += p._batcher.qsize()
    except Exception as e:
        logger.debug("ingest queue gauge raced a teardown: %s", e)
    return total


_reg.gauge(
    "juicefs_ingest_queue_blocks", "Blocks queued for ingest hashing"
).set_function(_queued_blocks)


def _settle_future(fut: Future, exc=None) -> None:
    """Resolve a block future exactly once. With early ack a
    leader future can be resolved from the PUT done-callback while a
    finalizer/worker error path is still iterating the batch — losing
    that race must be a no-op, not an InvalidStateError that kills the
    thread."""
    try:
        if exc is None:
            fut.set_result(None)
        else:
            fut.set_exception(exc)
    except InvalidStateError:
        pass  # already resolved by the racing path: first writer wins


def alias_map(meta) -> dict[str, str]:
    """Snapshot {alias block key -> canonical block key} for offline
    consumers (gc leaked/missing diff, fsck existence checks): an elided
    block has no object of its own, so name-based sweeps must translate
    through the content-ref plane."""
    refs = {
        digest: block_key(*canonical)
        for digest, canonical, _refs in meta.scan_content_refs()
    }
    out: dict[str, str] = {}
    for (sid, indx), digest, bsize, _ts in meta.scan_content_aliases():
        canonical = refs.get(digest)
        key = block_key(sid, indx, bsize)
        if canonical is not None and canonical != key:
            out[key] = canonical
    return out


class HotContentCache:
    """LRU of recently seen block CONTENT -> digest.

    Duplicate-heavy streams re-present the same few hot blocks
    (dataloader epochs, VM images, build trees). Proving identity by
    sampled fingerprint + full memcmp against the pinned copy costs
    ~10x less than re-hashing 4 MiB through JTH-256, and stays EXACT:
    byte equality implies digest equality, so an elision through the
    cache is indistinguishable from one through a fresh hash. A sampled
    fingerprint can collide (same head/tail/len, different middle), so
    the memcmp is the authority — a mismatch is just a miss.

    Doubles as the bypass governor's density probe (chunk/bypass.py):
    `probe()` is called from writer threads for shadow samples, so the
    map is lock-protected; probe misses park a DIGESTLESS entry
    (fp -> (None, raw)) — a recurrence of never-hashed content still
    registers as a density hit, which is what re-engages dedup after a
    long bypass."""

    def __init__(self, cap_bytes: int = 64 << 20):
        from collections import OrderedDict

        self._cap = max(1, cap_bytes)
        self._map: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _fp(raw) -> bytes:
        from .. import native

        n = len(raw)
        if n <= 16384:
            sample = bytes(raw)
        else:
            sample = bytes(raw[:8192]) + bytes(raw[-8192:])
        return native.jth256(sample + n.to_bytes(8, "little"))

    def _match(self, fp: bytes, raw, need_digest: bool):
        """Entry tuple iff the cached bytes equal `raw`. The multi-MiB
        memcmp runs OUTSIDE the lock (entries are immutable tuples;
        callers re-validate identity under the lock before mutating),
        so concurrent writer-thread probes and the batch worker never
        convoy behind each other's compares."""
        with self._lock:
            ent = self._map.get(fp)
        if (ent is None or (need_digest and ent[0] is None)
                or len(ent[1]) != len(raw)):
            return None
        return ent if ent[1] == raw else None

    def lookup(self, raw):
        """(digest or None, fp). The fp is returned so a following
        insert() after the full hash needn't recompute it. An entry
        whose bytes match but whose digest is None (parked by a probe)
        counts as a miss here — the caller hashes and insert() upgrades
        it."""
        fp = self._fp(raw)
        ent = self._match(fp, raw, need_digest=True)
        with self._lock:
            if ent is not None and self._map.get(fp) is ent:
                self._map.move_to_end(fp)
                self.hits += 1
                return ent[0], fp
            self.misses += 1
            return None, fp

    def probe(self, raw) -> bool:
        """Density shadow-sample (bypass governor): True iff these bytes
        match a cached entry — digest or not, recurrence is the signal.
        A miss parks a digestless entry so future recurrences hit."""
        fp = self._fp(raw)
        ent = self._match(fp, raw, need_digest=False)
        with self._lock:
            if ent is not None and self._map.get(fp) is ent:
                self._map.move_to_end(fp)
                self.hits += 1
                return True
            self.misses += 1
            self._insert_locked(fp, None, raw)
            return False

    def insert(self, fp: bytes, digest: bytes, raw) -> None:
        with self._lock:
            self._insert_locked(fp, digest, raw)

    def _insert_locked(self, fp: bytes, digest, raw) -> None:
        old = self._map.pop(fp, None)
        if old is not None:
            self._bytes -= len(old[1])
        self._map[fp] = (digest, raw)
        self._bytes += len(raw)
        while self._bytes > self._cap and self._map:
            _fp, (_d, r) = self._map.popitem(last=False)
            self._bytes -= len(r)

    def export(self, limit: int = 4096) -> list[tuple[bytes, bytes]]:
        """MRU-first (fp, digest) rows for persistence:
        digestless probe parkings are skipped — only proven content is
        worth re-priming a mount with."""
        with self._lock:
            out = []
            for fp, (digest, _raw) in reversed(self._map.items()):
                if digest is None:
                    continue
                out.append((fp, digest))
                if len(out) >= limit:
                    break
            return out

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._map), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses}


class ContentRefs:
    """Adapter between block keys and the meta content-ref plane
    (meta/base.py content_* contract). Used by the ingest stage (incref/
    register), the read path (resolve on NotFound) and the delete path
    (release), so the store never touches digest rows directly."""

    def __init__(self, meta):
        self.meta = meta

    def incref(self, entries: list) -> list:
        return self.meta.content_incref(entries)

    def register(self, entries: list) -> list:
        return self.meta.content_register(entries)

    def resolve(self, key: str) -> Optional[str]:
        """Canonical block key serving `key`'s bytes (None = untracked)."""
        parsed = parse_block_key(key)
        if parsed is None:
            return None
        canonical = self.meta.content_resolve(parsed[0], parsed[1])
        if canonical is None:
            return None
        ck = block_key(*canonical)
        return None if ck == key else ck

    def release(self, keys: list[str]) -> list[tuple[str, Optional[str]]]:
        """Decref every tracked key being deleted. Per key returns
        (disposition, canonical_key): "untracked" -> delete the object as
        usual; "released" -> refs remain, do NOT delete the canonical
        object; "last" -> delete the canonical object (which may differ
        from `key` when an alias outlives its canonical's own slice)."""
        parsed = [parse_block_key(k) for k in keys]
        pairs = [(p[0], p[1]) for p in parsed if p is not None]
        if not pairs:
            return [("untracked", None)] * len(keys)
        results = iter(self.meta.content_decref(pairs))
        out: list[tuple[str, Optional[str]]] = []
        for p in parsed:
            if p is None:
                out.append(("untracked", None))
                continue
            disp, canonical = next(results)
            out.append(
                (disp, block_key(*canonical) if canonical is not None else None)
            )
        return out


def _hash_packed(pipe, plane, packed, n: int):
    """A placed batch's digests, and its advisories while the compress
    plane is estimating, else None. A failure of the estimating hash costs
    only the estimate: logged and counted by the plane, which stops
    estimating, and the batch is hashed again alone."""
    if plane is None or not plane.estimating:
        return pipe.hash_packed(*packed, n=n), None
    try:
        return pipe.hash_packed(*packed, n=n, advise=True)
    except Exception as e:
        plane.estimate_failed(e)
        return pipe.hash_packed(*packed, n=n), None


class IngestPipeline:
    """Batched hash -> content-ref lookup -> elide-or-upload stage.

    `submit(key, raw, parent)` is the WSlice seam: non-blocking, returns a
    Future resolved when the block is durable (elided, uploaded, or staged
    by the degradation ladder) — the WSlice commit barrier waits on it
    exactly as it waits on plain upload-pool futures.
    """

    def __init__(
        self,
        store,
        refs: ContentRefs,
        backend: str = "cuda",
        batch_blocks: int = 32,
        queue_blocks: int = 64,
        flush_timeout: float = 0.005,
        bypass: bool = True,
        governor: Optional[ElisionGovernor] = None,
        hot_bytes: int = 64 << 20,
        device=None,
        plane=None,
    ):
        from ..gpu.pipeline import HashBatcher, HashPipeline, PipelineConfig
        from .indexer import pipeline_backend

        backend = pipeline_backend(backend)
        if device is None:
            device = getattr(store.conf, "device", None)
        self.store = store
        self.refs = refs
        self.backend = backend
        # adaptive elision bypass: skip hash+lookup entirely
        # while the sampled dup density stays below the low-water mark
        self.governor = governor if governor is not None else (
            ElisionGovernor() if bypass else None)
        # hot-content digest cache: memcmp beats re-hashing
        # for the duplicate-heavy streams dedup exists for (0 disables)
        self._hot = HotContentCache(hot_bytes) if hot_bytes > 0 else None
        # the queue holds every block the store's write buffer bound
        # admits, and a flush marker: a writer under the bound never
        # finds it full
        bound = store.conf.buffer_size
        if bound > 0:
            queue_blocks = max(queue_blocks, -(-bound // store.conf.block_size) + 1)
        self._batcher = HashBatcher(
            HashPipeline(
                PipelineConfig(
                    backend=backend,
                    batch_blocks=batch_blocks,
                    pad_lanes=max(1, store.conf.block_size // 65536),
                ),
                device=device,
                plane=plane,
            ),
            queue_blocks=queue_blocks,
            flush_timeout=flush_timeout,
        )
        self._lock = threading.Lock()
        self._outstanding: set[Future] = set()
        self._closed = False
        # miss groups flow worker -> upload pool (PUT) -> finalizer, which
        # waits the PUTs and commits ONE register txn + ONE follower
        # incref txn per hash batch (per-upload txns cost ~10x the
        # lookup cost on sqlite); hashing of batch k+1 overlaps both
        import queue as _queue

        self._finalq: "_queue.Queue" = _queue.Queue()
        self._empty = _queue.Empty
        # register batches still queued/served by the finalizer: leaders
        # ack at PUT (early ack), so flush() must separately drain this
        # before promising "every submitted block is fully processed" —
        # a dedup lookup right after flush must see the registrations
        self._final_pending = 0
        # digests whose canonical PUT/register is in flight (early ack
        # means "registered" lags "durable"): a later batch holding the
        # same content waits for the event instead of racing the
        # register — its MISS becomes a clean HIT
        self._inflight_reg: dict = {}
        # stats mirror of the global counters, per pipeline (bench/tests)
        self.blocks = 0
        self.elided = 0
        self.elided_bytes = 0
        self.uploaded = 0
        self.passthrough = 0
        self.race_collapsed = 0
        self.errors = 0
        # hot-content persistence accounting
        self.hot_loaded = 0
        self.hot_persisted = 0
        _LIVE_PIPELINES.add(self)
        self._thread = threading.Thread(
            target=self._loop, name="ingest-dedup", daemon=True
        )
        self._thread.start()
        self._finalizer = threading.Thread(
            target=self._finalize_loop, name="ingest-finalize", daemon=True
        )
        self._finalizer.start()

    # -- producer side (WSlice upload seam) --------------------------------
    def submit(self, key: str, raw, parent=None) -> Future:
        fut: Future = Future()
        with self._lock:
            closed = self._closed
            self._outstanding.add(fut)
        fut.add_done_callback(self._done)
        parsed = parse_block_key(key)
        if parsed is None:
            return self._passthrough(key, raw, parent, fut, count=False)
        _BLOCKS.inc()
        _BYTES.inc(len(raw))
        self.blocks += 1
        route = "dedup"
        try:
            gov = self.governor
            if not closed and gov is not None:
                verdict = gov.admit()
                if verdict == ElisionGovernor.PROBE and self._hot is not None:
                    # free density probe: sampled-fp + memcmp on the writer
                    # thread (~µs), upload proceeds untouched below
                    gov.record(self._hot.probe(raw))
                elif verdict == ElisionGovernor.PROBE:
                    verdict = ElisionGovernor.DEDUP  # no hot cache: real probe
                if verdict != ElisionGovernor.DEDUP:
                    # bypass: sampled dup density is low — this block skips
                    # hash/lookup and rides the plain FOREGROUND upload
                    # pool, exactly the no-dedup write path (counted by the
                    # governor, not as a degrade)
                    route = "bypass"
            if route == "dedup" and (
                    closed
                    or not self._batcher.submit((key, raw, parent, fut,
                                                 parsed))):
                # hash plane saturated (or a racing close()): the write must
                # not wait for dedup — and an item enqueued behind the CLOSE
                # sentinel would never resolve its future
                route = "degrade"
        except Exception as e:
            # dedup is advisory end to end: a broken governor/hot-cache/
            # batcher must degrade THIS block to the plain upload, never
            # fail the writer's submit (degrade-not-raise seam)
            _ERRORS.inc()
            self.errors += 1
            logger.warning("ingest submit degraded to passthrough: %s", e)
            route = "degrade"
        if route == "bypass":
            return self._passthrough(key, raw, parent, fut, count=False)
        if route == "degrade":
            return self._passthrough(key, raw, parent, fut)
        return fut

    def kick(self) -> None:
        """Commit barrier hint (WSlice.finish): flush the partial batch
        now instead of waiting out the flush timeout."""
        self._batcher.kick()

    def _done(self, fut: Future) -> None:
        with self._lock:
            self._outstanding.discard(fut)

    def _passthrough(self, key, raw, parent, fut: Future, count=True,
                     pool=None) -> Future:
        """Plain upload (no dedup): chain the caller-visible future onto
        an upload-pool task, preserving exception propagation. count=True
        (every dedup-degrade path: overload, racing close, meta-failure
        fallbacks) records the block as a passthrough; count=False is the
        foreign-key path, which was never dedup-eligible.

        `pool` defaults to the store's FOREGROUND upload pool (submit-time
        degrades happen on the writer's own thread — they ARE the
        foreground write); paths initiated from the ingest stage's daemon
        threads pass `_ingest_pool` so fallback re-uploads classify as
        INGEST per the class table (docs/ARCHITECTURE.md)."""
        if count:
            _PASSTHROUGH.inc()
            self.passthrough += 1
        try:
            pool_fut = (pool or self.store._pool).submit(
                self.store._put_or_stage, key, raw, parent
            )
        except Exception as e:
            # pool shut down mid-teardown (RuntimeError), qos backpressure
            # timed out (TimeoutError), or anything else: the block's fate
            # must reach the caller, not kill the worker
            _settle_future(fut, e)
            return fut

        def chain(pf, fut=fut):
            e = pf.exception()
            if e is not None:
                fut.set_exception(e)
            else:
                fut.set_result(None)

        pool_fut.add_done_callback(chain)
        return fut

    # -- worker ------------------------------------------------------------
    def _loop(self) -> None:
        try:
            # warm the hot-content cache from the persisted snapshot:
            # on the worker thread, before the first batch —
            # mount never blocks on it, and no extra thread to leak
            self._load_hot()
        except Exception as e:
            logger.warning("hot-content cache load skipped: %s", e)
        for batch in self._batcher.batches():
            try:
                with _TR.span("chunk", "ingest", stage="process",
                              hist=_H_PROCESS):
                    self._process(batch)
            except Exception as e:
                # dedup is advisory: a broken batch degrades, never fails
                _ERRORS.inc(len(batch))
                self.errors += len(batch)
                logger.warning("ingest batch of %d degraded: %s", len(batch), e)
                for key, raw, parent, fut, _p in batch:
                    if not fut.done():
                        self._passthrough(key, raw, parent, fut,
                                          pool=self.store._ingest_pool)

    def _process(self, batch: list) -> None:
        pipe = self._batcher.pipe
        plane = getattr(self.store, "compress_plane", None)
        # hot-content cache: blocks whose bytes match a recently seen
        # block (sampled fp + full memcmp) take its digest without
        # re-hashing; only the remainder goes through the hash plane
        hot = self._hot
        digests: list = [None] * len(batch)
        fps: list = [None] * len(batch)
        unknown = list(range(len(batch)))
        if hot is not None:
            unknown = []
            for i, (_k, raw, _p, _f, _parsed) in enumerate(batch):
                d, fp = hot.lookup(raw)
                digests[i], fps[i] = d, fp
                if d is None:
                    unknown.append(i)
        raws = [batch[i][1] for i in unknown]
        packed = None
        if raws and pipe.device_backend:
            # shared upload: ONE upload, packed to the batch's own longest
            # block (`pack_batch`), feeds the hash digests AND the compress
            # plane's estimate. `shard_packed`
            # places the batch on the plane once; a failure here degrades
            # the whole batch in `_loop` (logged and counted) rather than
            # letting both consumers upload host arrays again
            with _TR.span("chunk", "ingest", stage="pack", hist=_H_PACK) as sp:
                if sp.active:
                    sp.set(blocks=len(raws))
                with _TR.span("gpu", "hash", stage="pack", hist=_H_HOST_PACK):
                    host = pipe.pack_batch(raws)
                packed = pipe.shard_packed(host)
        advisories = None
        if raws:
            with _TR.span("chunk", "ingest", stage="hash",
                          hist=_H_HASH) as sp:
                if sp.active:
                    sp.set(blocks=len(raws), backend=self.backend,
                           hot_hits=len(batch) - len(raws))
                if packed is not None:
                    hashed, advisories = _hash_packed(pipe, plane, packed, len(raws))
                else:
                    hashed = pipe.hash_blocks(raws)
            for j, i in enumerate(unknown):
                digests[i] = hashed[j]
                if hot is not None:
                    hot.insert(fps[i], hashed[j], batch[i][1])
        if advisories is not None:  # computed by the hash of the shared pack
            with _TR.span("chunk", "ingest", stage="estimate", hist=_H_ESTIMATE):
                plane.estimate_packed(advisories)
        with _TR.span("chunk", "ingest", stage="await", hist=_H_AWAIT):
            self._await_inflight(digests)
        # advisory content-index rows for gc/fsck: elided blocks never
        # reach the _put_block fingerprint hook, and we hold every digest
        # right here. Written by the FINALIZER (one batched txn off the
        # worker critical path — a meta txn on this thread would stall
        # the next batch's hash behind the GIL/meta convoy)
        index_rows = None
        if getattr(self.refs.meta, "set_block_digests", None) is not None:
            index_rows = [
                (sid, indx, bsize, digests[i])
                for i, (_, _, _, _, (sid, indx, bsize)) in enumerate(batch)
            ]

        # one lookup txn for the whole batch; same-digest groups resolve
        # together (all hit, or all miss with one leader upload)
        with _TR.span("chunk", "ingest", stage="lookup", hist=_H_LOOKUP) as sp:
            if sp.active:
                sp.set(blocks=len(batch))
            results = self.refs.incref(
                [
                    (digests[i], sid, indx, bsize)
                    for i, (_, _, _, _, (sid, indx, bsize)) in enumerate(batch)
                ]
            )

        groups: dict[bytes, list] = {}
        gov = self.governor
        for i, item in enumerate(batch):
            key, raw, parent, fut, parsed = item
            if results[i] is not None:
                # duplicate: alias recorded, refcount bumped — NO backend
                # call for this block, ever
                _ELIDED.inc()
                _ELIDED_BYTES.inc(len(raw))
                self.elided += 1
                self.elided_bytes += len(raw)
                if gov is not None:
                    gov.record(True)
                fut.set_result(None)
            else:
                members = groups.setdefault(digests[i], [])
                if gov is not None:
                    # a same-batch follower IS a duplicate for density
                    # purposes, even though its elision lands at register
                    gov.record(bool(members))
                members.append(item)

        # batched compress of the MISS leaders: one
        # slice-lane fan-out per batch instead of a serial encode inside
        # each PUT worker; the PUTs below then ship pre-compressed bytes
        # back-to-back (pipelined with the NEXT batch's hashing)
        datas = None
        if groups and plane is not None:
            leaders = [members[0] for members in groups.values()]
            try:
                with _TR.span("chunk", "upload", stage="compress",
                              hist=_H_COMPRESS) as sp:
                    if sp.active:
                        sp.set(blocks=len(leaders),
                               backend=plane.backend)
                    datas = plane.compress_blocks([m[1] for m in leaders])
            except Exception as e:
                # advisory: a broken plane degrades this batch to the
                # per-block encode inside _put_block (byte-identical)
                logger.warning("batch compress degraded: %s", e)
                datas = None

        # claim the finalizer work BEFORE any PUT is submitted: fast
        # PUTs early-ack their futures, and a flush() polling between
        # those acks and a late _final_pending increment would otherwise
        # report drained with the index/register txns never queued
        claimed = bool(groups or index_rows)
        if claimed:
            with self._lock:
                self._final_pending += 1
        jobs = []
        try:
            jobs = self._submit_groups(groups, datas)
        except BaseException:
            # a submit blew past the per-group handling (e.g. qos
            # backpressure TimeoutError): release the finalizer claim or
            # flush()/close() would wait on it forever, then let _loop
            # degrade the unresolved futures to passthrough
            if claimed:
                with self._lock:
                    self._final_pending -= 1
            raise
        if jobs or index_rows:
            with self._lock:
                for digest, _m, _pf in jobs:
                    self._inflight_reg.setdefault(digest, threading.Event())
            self._finalq.put((index_rows, jobs))
        elif claimed:
            with self._lock:  # every submit bounced: nothing to finalize
                self._final_pending -= 1

    def _submit_groups(self, groups: dict, datas) -> list:
        jobs = []
        for gi, (digest, members) in enumerate(groups.items()):
            leader = members[0]
            try:
                # INGEST class: canonical PUTs rank below
                # foreground reads/writes but above background bulk work
                pf = self.store._ingest_pool.submit(
                    self.store._put_block, leader[0], leader[1], leader[2],
                    False,  # fingerprint=False: digest already recorded
                    datas[gi] if datas is not None else None,
                )
            except (RuntimeError, TimeoutError) as e:
                for m in members:
                    _settle_future(m[3], e)
                continue
            # early ack: the leader is durable the
            # moment its own PUT lands — ack from the PUT completion
            # itself, NOT from the finalizer (whose queue may be parked
            # inside an earlier batch's register txn). Registration only
            # affects later elidability; PUT-without-register is an
            # existing crash window gc --dedup backfills.
            pf.add_done_callback(
                lambda f, fut=leader[3]: (
                    _settle_future(fut)
                    if f.exception() is None else None
                )
            )
            jobs.append((digest, members, pf))
        return jobs

    def _await_inflight(self, digests: list) -> None:
        """Block (bounded) on any digest whose register is in flight from
        an earlier batch. Without this, early-acked content re-uploads on
        the next batch and collapses at register — correct but wasted
        PUTs; with it, sequential same-content writes elide exactly as
        they did when the commit barrier covered the register txn. A
        wedged finalizer only degrades back to the race-collapse path."""
        evs = []
        with self._lock:
            for d in dict.fromkeys(digests):
                ev = self._inflight_reg.get(d)
                if ev is not None:
                    evs.append(ev)
        for ev in evs:
            ev.wait(10.0)

    def _settle_inflight(self, digests: list) -> None:
        with self._lock:
            for d in digests:
                ev = self._inflight_reg.pop(d, None)
                if ev is not None:
                    ev.set()

    def _finalize_loop(self) -> None:
        """Wait each batch's canonical PUTs, then commit ONE register txn
        for the new content and ONE incref txn for same-batch followers —
        amortizing meta commits over the batch while batch k+1 hashes."""
        while True:
            item = self._finalq.get()
            if item is None:
                return
            # coalesce everything already queued: under load the
            # finalizer self-batches, so ONE index txn and ONE register
            # txn cover several hash batches — every meta txn fights the
            # encode lanes for the GIL, so txn count is latency
            items = [item]
            while True:
                try:
                    nxt = self._finalq.get_nowait()
                except self._empty:
                    break
                if nxt is None:
                    self._finalq.put(None)  # re-arm the close sentinel
                    break
                items.append(nxt)
            index_rows = [r for rows, _j in items if rows for r in rows]
            jobs = [j for _r, js in items for j in js]
            if index_rows:
                try:
                    self.refs.meta.set_block_digests(index_rows)
                except Exception as e:  # advisory: gc backfills the index
                    logger.warning("content-index batch failed: %s", e)
            try:
                self._finalize(jobs)
            except Exception as e:
                logger.warning("ingest finalize degraded: %s", e)
                for _digest, members, _pf in jobs:
                    for m in members:
                        # races the early-ack PUT callback: first wins
                        _settle_future(m[3], e)
            finally:
                self._settle_inflight([d for d, _m, _pf in jobs])
                with self._lock:
                    self._final_pending -= len(items)

    def _finalize(self, jobs: list) -> None:
        ok: list = []  # (digest, members) whose canonical PUT landed
        for digest, members, pf in jobs:
            try:
                pf.result()
            except BreakerOpenError:
                # mid-flight outage: the whole group degrades to staging
                # (ladder rung 2) and stays un-registered — replay uploads
                # raw bytes per key, no aliasing during an outage
                for m in members:
                    self.store._stage_degraded(m[0], m[1])
                    m[3].set_result(None)
                continue
            except Exception as e:
                for m in members:
                    m[3].set_exception(e)
                continue
            _UPLOADED.inc()
            self.uploaded += 1
            # leader already early-acked by the PUT done-callback
            # (_process); followers wait register+incref below — their
            # ack must imply a reachable alias row
            ok.append((digest, members))
        if not ok:
            return
        try:
            with _TR.span("chunk", "ingest", stage="register",
                          hist=_H_REGISTER) as sp:
                if sp.active:
                    sp.set(groups=len(ok))
                results = self.refs.register(
                    [(digest, *members[0][4]) for digest, members in ok]
                )
        except Exception as e:
            # meta hiccup AFTER the PUTs: blocks are durable, just not
            # elidable yet (gc --dedup backfills registration); followers
            # below fall back to their own uploads
            _ERRORS.inc(len(ok))
            self.errors += len(ok)
            logger.warning("register batch failed: %s", e)
            results = None
        followers: list = []  # flattened (digest, member) across groups
        for i, (digest, members) in enumerate(ok):
            leader = members[0]
            existing = results[i] if results is not None else None
            if existing is not None and existing != leader[4]:
                # cross-client race: someone registered this content first
                # and our register collapsed to an incref — our object is
                # redundant
                _RACE_COLLAPSED.inc()
                self.race_collapsed += 1
                try:
                    self.store.storage.delete(leader[0])
                except Exception as e:
                    # a leaked duplicate object; gc --dedup collects it
                    logger.warning("race-collapsed object %s not "
                                   "deleted: %s", leader[0], e)
            if results is not None:
                followers.extend((digest, m) for m in members[1:])
            else:
                # unregistered content: same-batch duplicates upload too
                for m in members[1:]:
                    self._fallback_upload(m)
        if not followers:
            return
        try:
            res = self.refs.incref(
                [(digest, *m[4]) for digest, m in followers]
            )
        except Exception as e:
            logger.warning("follower incref failed: %s", e)
            res = [None] * len(followers)
        for (_digest, m), r in zip(followers, res):
            if r is not None:
                _ELIDED.inc()
                _ELIDED_BYTES.inc(len(m[1]))
                self.elided += 1
                self.elided_bytes += len(m[1])
                m[3].set_result(None)
            else:
                # the row vanished between register and incref (decref-to-
                # zero race) or meta failed: upload this copy directly
                self._fallback_upload(m)

    def _fallback_upload(self, m) -> None:
        # pool-side upload chained to the member's future: the finalizer
        # thread must not serialize compress+PUT inline during a meta
        # brownout (the pool keeps follower fallbacks parallel)
        self._passthrough(m[0], m[1], m[2], m[3],
                          pool=self.store._ingest_pool)

    # -- hot-content persistence --------------------------------
    def _load_hot(self) -> None:
        """Re-prime the hot cache from the meta snapshot written by the
        previous mount's close(). Every row is re-verified before use:
        the digest must still resolve to a live canonical via the
        content-ref plane, the bytes come back through the store's own
        read path, and the recomputed sampled fingerprint must match —
        a stale snapshot costs nothing but this loader's time."""
        hot = self._hot
        meta = getattr(self.refs, "meta", None)
        loader = getattr(meta, "load_hot_fingerprints", None)
        if hot is None or loader is None:
            return
        rows = loader()
        if not rows:
            return
        from .cached_store import block_key

        canon = {}
        for digest, (sid, indx, bsize), refs in meta.scan_content_refs():
            if refs > 0:
                canon[digest] = (sid, indx, bsize)
        budget = hot._cap
        for fp, digest in rows:
            if budget <= 0 or self._closed:
                break
            loc = canon.get(digest)
            if loc is None:
                continue
            sid, indx, bsize = loc
            try:
                raw = self.store._load_block(
                    block_key(sid, indx, bsize), bsize, cache_after=False)
            except Exception as e:
                # canonical unreadable: skip the row — the snapshot is
                # advisory, but say so (a storage fault burst here should
                # be visible, not silent)
                logger.debug("hot-cache reprime skipped %s_%s: %s",
                             sid, indx, e)
                continue
            if raw is None or hot._fp(raw) != fp:
                continue
            hot.insert(fp, digest, bytes(raw))
            budget -= len(raw)
            self.hot_loaded += 1

    def _persist_hot(self) -> None:
        """Snapshot the hot cache's proven (fp, digest) rows to meta so
        the next mount starts warm. Advisory end to end: an engine
        without the API, or a failed txn, only loses the warm start."""
        hot = self._hot
        meta = getattr(self.refs, "meta", None)
        saver = getattr(meta, "set_hot_fingerprints", None)
        if hot is None or saver is None:
            return
        rows = hot.export()
        saver(rows)
        self.hot_persisted = len(rows)

    # -- lifecycle ---------------------------------------------------------
    def flush(self, timeout: float = 60.0) -> None:
        """Block until every submitted block is durable (elided, uploaded
        or staged). Every accepted block's future sits in `_outstanding`
        from submit() until it resolves, so an empty set == drained."""
        import time as _time

        self.kick()
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            with self._lock:
                if not self._outstanding and self._final_pending == 0:
                    return
            _time.sleep(0.005)
        raise TimeoutError("ingest pipeline did not drain")

    def close(self, timeout: float = 60.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self.flush(timeout)
        finally:
            self._batcher.close()
            self._thread.join(timeout)
            self._finalq.put(None)
            self._finalizer.join(timeout)
            try:
                self._persist_hot()  # after drain: snapshot is complete
            except Exception as e:
                logger.warning("hot-content cache persist skipped: %s", e)

    def stats(self) -> dict:
        out = {
            "backend": self.backend,
            "blocks": self.blocks,
            "put_elided": self.elided,
            "put_elided_bytes": self.elided_bytes,
            "uploaded": self.uploaded,
            "passthrough": self.passthrough,
            "race_collapsed": self.race_collapsed,
            "errors": self.errors,
        }
        if self.governor is not None:
            out["bypass"] = self.governor.stats()
        if self._hot is not None:
            out["hot_content"] = dict(
                self._hot.stats(),
                loaded=self.hot_loaded,
                persisted=self.hot_persisted,
            )
        plane = getattr(self.store, "compress_plane", None)
        if plane is not None:
            out["compress"] = plane.stats()
        return out
