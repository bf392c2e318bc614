"""Write-path content indexer on the card (a copy of
juicefs_tpu/chunk/indexer.py), and the hash-backend names of a volume's
format mapped onto the port's pipeline.

Every uploaded block is fingerprinted with JTH-256 *off* the write path
and persisted in the meta engine under `B{sliceid}{indx} -> bsize+digest`,
so `gc --dedup` and `fsck` consume an O(blocks) index instead of
re-reading and re-hashing the whole volume. Hashing wants large batches
(32 blocks = 128 MiB per kernel launch) while uploads complete one block
at a time, so each upload copies its block into a row of a pinned
staging slot (one batch), one background worker hashes each full slot
(`HashPipeline.hash_slot`: one row-chain launch per batch), and a second
thread records the digests in meta, one transaction for every batch
hashed since its last.

Overload policy: with every staging slot full the block is DROPPED
instead of blocking the upload worker. The index is advisory and `gc
--dedup` backfills missing rows, so a slow hash backend never throttles
foreground writes. Drops are counted in stats()["dropped"], failed
batches in stats()["errors"] (and logged at WARNING). Tracing also
stamps each block's copy into its slot (`chunk.index.pack`).

Tracing: the registry counts blocks and bytes indexed, blocks dropped and
blocks of failed batches (`juicefs_index_blocks`, `_bytes`, `_dropped`,
`_errors`); the stage rollup times the worker's whole batch
(`chunk.index.process`) and its hash call (`gpu.index.batch`), the
recorder's index transactions (`chunk.index.register`), and stamps each
block's wait from `submit` to its batch's processing (`chunk.index.wait`).

Changes from the reference: the default backend is `cuda`, and `device=`
is where it runs (None: the process-wide sharding plane over every card;
without one construction raises instead of falling back to the CPU).
`device="cpu"` is the explicit request for the plain torch path,
`backend="cpu"` for the host hash. The reference queues a copy of each
block, and packs, hashes and records each batch on its one worker; the
port packs each block on the submitting thread and records on a thread
of its own (`BlockIndexer`).

A volume formatted by the JAX package stores `hash_backend` as one of
"" | cpu | tpu | xla | pallas. The port reads such a volume as it stands:
every device name maps to the CUDA backend, "" (no content indexing) and
"cpu" to the host backend. No reference name is rejected.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref

from ..metric import global_registry
from ..metric.trace import global_tracer, stage_hist
from ..utils import get_logger
from .cached_store import parse_block_key

logger = get_logger("chunk.indexer")

_TR = global_tracer()
# the hash call of a batch (tests and chip_smoke.py count batches by it)
_H_BATCH = stage_hist("gpu", "index", "batch")
# the worker's whole batch: the hash call and the index transaction
_H_PROCESS = stage_hist("chunk", "index", "process")
# the batch's set_block_digests transaction
_H_REGISTER = stage_hist("chunk", "index", "register")
# a block's time from submit() queueing it to its batch being processed
_H_WAIT = stage_hist("chunk", "index", "wait")
# a block's copy into its batch's staging slot, on the submitting thread
_H_PACK = stage_hist("chunk", "index", "pack")

_reg = global_registry()
_BLOCKS = _reg.counter(
    "juicefs_index_blocks", "Blocks hashed and recorded by the content indexer"
)
_BYTES = _reg.counter(
    "juicefs_index_bytes", "Raw bytes hashed and recorded by the content indexer"
)
_DROPPED = _reg.counter(
    "juicefs_index_dropped",
    "Blocks the content indexer dropped with its queue full "
    "(advisory index; gc --dedup backfills)",
)
_ERRORS = _reg.counter(
    "juicefs_index_errors", "Blocks of content-index batches that failed"
)

_BACKENDS = {"": "cpu", "cpu": "cpu", "tpu": "cuda", "xla": "cuda",
             "pallas": "cuda", "cuda": "cuda"}

# queue-depth gauge aggregates over live indexers via weak refs (a gauge
# closure must neither pin a discarded indexer nor report only the newest)
_LIVE_INDEXERS: "weakref.WeakSet[BlockIndexer]" = weakref.WeakSet()


def _queued_blocks() -> int:
    total = 0
    try:
        for ix in list(_LIVE_INDEXERS):
            total += ix._queued
    except Exception as e:
        logger.debug("index queue gauge raced a teardown: %s", e)
    return total


global_registry().gauge(
    "juicefs_index_queue_blocks",
    "Blocks queued for content-index hashing",
).set_function(_queued_blocks)

_STOP = object()
# a batch still filling is hashed once no block has joined it for this long
_IDLE_S = 0.05


def pipeline_backend(hash_backend: str) -> str:
    """Map a Format.hash_backend value to a port HashPipeline backend."""
    try:
        return _BACKENDS[hash_backend]
    except KeyError:
        raise ValueError(
            f"unknown hash backend {hash_backend!r} "
            f"(want one of {sorted(_BACKENDS)})") from None


class _Batch:
    """A staging slot (`HashPipeline.staging_slot`) that the submitting
    threads fill: row i holds the block of items[i]. `reserved` rows are
    handed out, `written` of them copied; a sealed batch takes no more,
    and goes to the worker once every reserved row is written."""

    __slots__ = ("slot", "items", "reserved", "written", "sealed", "last")

    def __init__(self, slot, size: int):
        self.slot = slot
        self.items: list = [None] * size
        self.reset()

    def reset(self) -> None:
        self.reserved = self.written = 0
        self.sealed = False
        self.last = 0.0  # when the latest row was reserved


class BlockIndexer:
    """Async batched block fingerprinting + persistent content index.

    meta=None keeps digests in memory only (measurement mode): `digests`
    maps (sid, indx) to the 32-byte digest. The reference's docstring
    promises this but drops them; the port keeps them, so `objbench
    --hash-backend` can be checked against the numpy spec.

    The queue is a ring of staging slots, each one hash batch: `submit`
    copies its block straight into the next free row of the slot being
    filled (the pack, on the submitting thread, in place of the copy the
    reference's queue keeps), the worker hashes whole slots, and the
    recorder writes their rows. So the worker neither copies nor waits on
    the meta engine: on an H100 host under four writers the pack took ~190
    ms and the transaction ~280 ms of its ~560 ms a 32-block batch, and
    it dropped over half the blocks. Room for `queue_blocks` blocks waits
    beside the batch being hashed; a block that finds none is dropped.
    """

    def __init__(
        self,
        meta=None,
        backend: str = "cuda",
        block_size: int = 4 << 20,
        batch_blocks: int = 32,
        queue_blocks: int = 64,
        device=None,
    ):
        from ..gpu.pipeline import HashPipeline, PipelineConfig

        self.meta = meta
        self.digests: dict[tuple[int, int], bytes] = {}
        self.backend = pipeline_backend(backend)
        self._pipe = HashPipeline(
            PipelineConfig(
                backend=self.backend,
                batch_blocks=batch_blocks,
                pad_lanes=max(1, block_size // 65536),
            ),
            device=device,
        )
        self._batch_blocks = batch_blocks
        n_slots = -(-max(1, queue_blocks) // batch_blocks) + 1
        self._free = [_Batch(self._pipe.staging_slot(), batch_blocks)
                      for _ in range(n_slots)]
        self._filling: _Batch | None = None
        self._ready: queue.Queue = queue.Queue()  # sealed, written batches
        # each hashed batch's [((stamp, sid, indx, bsize), digest)], to record
        self._rows: queue.Queue = queue.Queue()
        self._cond = threading.Condition()
        self._pending = 0  # blocks taken in and not yet recorded or failed
        self._queued = 0  # blocks taken in and not yet handed to the worker
        # stats (stats(); chip_smoke.py gates on them)
        self.blocks = 0
        self.bytes = 0
        self.busy_seconds = 0.0
        self.errors = 0
        self.dropped = 0  # blocks skipped under overload (gc backfills)
        _LIVE_INDEXERS.add(self)
        self._thread = threading.Thread(
            target=self._loop, name="block-indexer", daemon=True
        )
        self._thread.start()
        self._recorder = threading.Thread(
            target=self._record_loop, name="block-indexer-record", daemon=True
        )
        self._recorder.start()

    # -- producer side (upload pool threads) -------------------------------
    def submit(self, key: str, raw: bytes) -> None:
        """ChunkConfig.fingerprint hook: called per uploaded block."""
        parsed = parse_block_key(key)
        if parsed is None:
            return
        sid, indx, _bsize = parsed
        self.submit_raw(sid, indx, len(raw), raw)

    def submit_raw(self, sid: int, indx: int, bsize: int, raw: bytes) -> None:
        """Copy the block into a row of the batch being filled; never
        blocks on the worker. With no row free it drops the block."""
        if _TR.active:
            # instantaneous marker linking the upload span tree into the
            # gpu layer (the batch itself hashes on the worker thread)
            with _TR.span("gpu", "enqueue") as sp:
                sp.set(sid=sid, indx=indx, bytes=bsize)
        stamp = time.perf_counter()
        with self._cond:
            b = self._filling
            if b is None and self._free:
                b = self._filling = self._free.pop()
            if b is not None:
                row = b.reserved
                b.reserved += 1
                b.last = stamp
                if b.reserved == self._batch_blocks:
                    b.sealed = True
                    self._filling = None
                self._pending += 1
                self._queued += 1
            else:
                # hashing is behind by every staging slot: drop to
                # backfill rather than stall the upload worker — foreground
                # write throughput must not be coupled to the hash backend
                # (counted under the lock: several upload workers can find
                # no room at once and a bare += would lose increments)
                self.dropped += 1
                dropped = self.dropped
        if b is None:
            _DROPPED.inc()
            if dropped in (1, 10, 100) or dropped % 1000 == 0:
                logger.warning(
                    "hash backend '%s' overloaded: %d blocks skipped "
                    "(gc --dedup will backfill their digests)",
                    self.backend, dropped,
                )
            return
        item = None
        try:
            with _TR.span("chunk", "index", stage="pack", hist=_H_PACK):
                b.slot.pack_row(row, raw)
            item = (stamp, sid, indx, bsize)
        except Exception as e:  # counted when its batch is processed
            logger.warning("index pack of slice %d block %d failed: %s", sid, indx, e)
        with self._cond:
            b.items[row] = item
            b.written += 1
            ready = b.sealed and b.written == b.reserved
        if ready:
            self._ready.put(b)

    # -- worker ------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            try:
                b = self._ready.get(timeout=_IDLE_S)
            except queue.Empty:
                b = self._seal_idle()
            if b is _STOP:
                self._rows.put(_STOP)
                return
            if b is not None:
                t0 = time.perf_counter()
                with _TR.span("chunk", "index", stage="process", hist=_H_PROCESS):
                    self._process(b)
                self._settle(0, 0, time.perf_counter() - t0)

    def _seal_idle(self):
        """The batch being filled, sealed, once no block has joined it for
        `_IDLE_S`; None while it is still filling, or while a row is still
        being copied (its copier hands it over)."""
        with self._cond:
            b = self._filling
            if b is None or time.perf_counter() - b.last < _IDLE_S:
                return None
            b.sealed = True
            self._filling = None
            return b if b.written == b.reserved else None

    def _process(self, b: _Batch) -> None:
        """Hash one written batch and hand its rows to the recorder."""
        n = b.reserved
        items = b.items[:n]
        t0 = time.perf_counter()
        for item in items:
            if item is not None:
                _H_WAIT.observe(t0 - item[0])
        good = [i for i, item in enumerate(items) if item is not None]
        try:
            with _TR.span("gpu", "index", stage="batch", hist=_H_BATCH) as sp:
                if sp.active:
                    sp.set(blocks=n, backend=self.backend)
                digests = self._pipe.hash_slot(b.slot, n)
            rows = [(items[i], digests[i]) for i in good]  # raises before any is kept
            failed = n - len(good)
        except Exception as e:
            # The index is advisory (gc backfills missing rows); never let
            # an indexing failure poison the write path.
            rows, failed = [], n
            logger.warning("index batch of %d failed: %s", n, e)
        finally:
            b.reset()
            with self._cond:
                self._queued -= n
                self._free.append(b)
        if rows:
            self._rows.put(rows)
        if failed:
            self._settle(0, failed)

    # -- recorder ----------------------------------------------------------
    def _record_loop(self) -> None:
        """Record every batch's rows hashed since the last transaction in
        one: off the worker, whose next batch need not wait for the meta
        engine's write lock (shared with the writers' slice commits)."""
        while True:
            taken = [self._rows.get()]
            while True:
                try:
                    taken.append(self._rows.get_nowait())
                except queue.Empty:
                    break
            rows = [row for batch in taken if batch is not _STOP for row in batch]
            if rows:
                t0 = time.perf_counter()
                indexed = self._record(rows)
                self._settle(indexed, len(rows) - indexed, time.perf_counter() - t0,
                             sum(bsize for (_t, _s, _i, bsize), _d in rows) if indexed else 0)
            if _STOP in taken:
                return

    def _record(self, rows: list) -> int:
        """Write the rows; the number recorded (all or none)."""
        try:
            if self.meta is not None:
                with _TR.span("chunk", "index", stage="register", hist=_H_REGISTER):
                    self.meta.set_block_digests(
                        [(sid, indx, bsize, d) for (_t, sid, indx, bsize), d in rows])
            else:
                for (_t, sid, indx, _b), d in rows:
                    self.digests[(sid, indx)] = bytes(d)
            return len(rows)
        except Exception as e:
            logger.warning("index batch of %d failed: %s", len(rows), e)
            return 0

    def _settle(self, indexed: int, failed: int, seconds: float = 0.0,
                nbytes: int = 0) -> None:
        _BLOCKS.inc(indexed)
        _BYTES.inc(nbytes)
        _ERRORS.inc(failed)
        with self._cond:
            self.blocks += indexed
            self.bytes += nbytes
            self.errors += failed
            self.busy_seconds += seconds
            self._pending -= indexed + failed
            self._cond.notify_all()

    # -- lifecycle ---------------------------------------------------------
    def flush(self, timeout: float = 60.0) -> None:
        """Block until every submitted block has been hashed + persisted."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._pending == 0, timeout):
                raise TimeoutError("block indexer did not drain")

    def close(self, timeout: float = 60.0) -> None:
        self.flush(timeout)
        self._ready.put(_STOP)  # the worker passes it on to the recorder
        self._thread.join(timeout)
        self._recorder.join(timeout)

    def stats(self) -> dict:
        return {
            "backend": self._pipe.config.backend,
            "blocks": self.blocks,
            "bytes": self.bytes,
            "busy_seconds": round(self.busy_seconds, 3),
            "hash_mib_s": round(
                self.bytes / (1 << 20) / self.busy_seconds, 1
            ) if self.busy_seconds > 0 else 0.0,
            "errors": self.errors,
            "dropped": self.dropped,
        }
