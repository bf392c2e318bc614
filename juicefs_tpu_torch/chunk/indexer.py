"""Write-path content indexer on the card (a copy of
juicefs_tpu/chunk/indexer.py), and the hash-backend names of a volume's
format mapped onto the port's pipeline.

Every uploaded block is fingerprinted with JTH-256 *off* the write path
and persisted in the meta engine under `B{sliceid}{indx} -> bsize+digest`,
so `gc --dedup` and `fsck` consume an O(blocks) index instead of
re-reading and re-hashing the whole volume. Hashing wants large batches
(32 blocks = 128 MiB per kernel launch) while uploads complete one block
at a time, so a bounded queue and one background worker batch, hash
(`HashPipeline.hash_blocks`: packed into pinned slots, one row-chain
launch per batch) and write the digests to meta in one transaction per
batch.

Overload policy: a full queue DROPS the block instead of blocking the
upload worker. The index is advisory and `gc --dedup` backfills missing
rows, so a slow hash backend never throttles foreground writes. Drops
are counted in stats()["dropped"], failed batches in stats()["errors"]
(and logged at WARNING).

Changes from the reference: the default backend is `cuda`, and `device=`
is where it runs (None: the process-wide sharding plane over every card;
without one construction raises instead of falling back to the CPU).
`device="cpu"` is the explicit request for the plain torch path,
`backend="cpu"` for the host hash.

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
_H_BATCH = stage_hist("gpu", "index", "batch")

_BACKENDS = {"": "cpu", "cpu": "cpu", "tpu": "cuda", "xla": "cuda",
             "pallas": "cuda", "cuda": "cuda"}

# queue-depth gauge aggregates over live indexers via weak refs (a gauge
# closure must neither pin a discarded indexer nor report only the newest)
_LIVE_INDEXERS: "weakref.WeakSet[BlockIndexer]" = weakref.WeakSet()


def _queued_blocks() -> int:
    total = 0
    try:
        for ix in list(_LIVE_INDEXERS):
            total += ix._q.qsize()
    except Exception as e:
        logger.debug("index queue gauge raced a teardown: %s", e)
    return total


global_registry().gauge(
    "juicefs_index_queue_blocks",
    "Blocks queued for content-index hashing",
).set_function(_queued_blocks)

_STOP = object()


def pipeline_backend(hash_backend: str) -> str:
    """Map a Format.hash_backend value to a port HashPipeline backend."""
    try:
        return _BACKENDS[hash_backend]
    except KeyError:
        raise ValueError(
            f"unknown hash backend {hash_backend!r} "
            f"(want one of {sorted(_BACKENDS)})") from None


class BlockIndexer:
    """Async batched block fingerprinting + persistent content index.

    meta=None keeps digests in memory only (measurement mode): `digests`
    maps (sid, indx) to the 32-byte digest. The reference's docstring
    promises this but drops them; the port keeps them, so `objbench
    --hash-backend` can be checked against the numpy spec.
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
        self._q: queue.Queue = queue.Queue(maxsize=queue_blocks)
        self._cond = threading.Condition()
        self._pending = 0
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

    # -- producer side (upload pool threads) -------------------------------
    def submit(self, key: str, raw: bytes) -> None:
        """ChunkConfig.fingerprint hook: called per uploaded block."""
        parsed = parse_block_key(key)
        if parsed is None:
            return
        sid, indx, _bsize = parsed
        self.submit_raw(sid, indx, len(raw), bytes(raw))

    def submit_raw(self, sid: int, indx: int, bsize: int, raw: bytes) -> None:
        if _TR.active:
            # instantaneous marker linking the upload span tree into the
            # gpu layer (the batch itself hashes on the worker thread)
            with _TR.span("gpu", "enqueue") as sp:
                sp.set(sid=sid, indx=indx, bytes=bsize)
        with self._cond:
            self._pending += 1
        try:
            self._q.put_nowait((sid, indx, bsize, raw))
        except queue.Full:
            # hashing is behind by a full queue (queue_blocks × block_size
            # of buffered raw bytes): drop to backfill rather than stall
            # the upload worker — foreground write throughput must not be
            # coupled to the hash backend
            with self._cond:
                self._pending -= 1
                # counted under the lock: several upload workers can hit
                # queue.Full at once and a bare += would lose increments
                self.dropped += 1
                self._cond.notify_all()
            if self.dropped in (1, 10, 100) or self.dropped % 1000 == 0:
                logger.warning(
                    "hash backend '%s' overloaded: %d blocks skipped "
                    "(gc --dedup will backfill their digests)",
                    self.backend, self.dropped,
                )

    # -- worker ------------------------------------------------------------
    def _loop(self) -> None:
        batch: list = []
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                item = None
            if item is _STOP:
                self._process(batch)
                return
            if item is not None:
                batch.append(item)
            if batch and (len(batch) >= self._batch_blocks or item is None):
                self._process(batch)
                batch = []

    def _process(self, batch: list) -> None:
        if not batch:
            return
        t0 = time.perf_counter()
        try:
            with _TR.span("gpu", "index", stage="batch", hist=_H_BATCH) as sp:
                if sp.active:
                    sp.set(blocks=len(batch), backend=self.backend)
                digests = self._pipe.hash_blocks([raw for _, _, _, raw in batch])
            if self.meta is not None:
                self.meta.set_block_digests(
                    [
                        (sid, indx, bsize, digests[i])
                        for i, (sid, indx, bsize, _) in enumerate(batch)
                    ]
                )
            else:
                for i, (sid, indx, _, _) in enumerate(batch):
                    self.digests[(sid, indx)] = bytes(digests[i])
            self.blocks += len(batch)
            self.bytes += sum(bsize for _, _, bsize, _ in batch)
        except Exception as e:
            # The index is advisory (gc backfills missing rows); never let
            # an indexing failure poison the write path.
            self.errors += len(batch)
            logger.warning("index batch of %d failed: %s", len(batch), e)
        finally:
            self.busy_seconds += time.perf_counter() - t0
            with self._cond:
                self._pending -= len(batch)
                self._cond.notify_all()

    # -- lifecycle ---------------------------------------------------------
    def flush(self, timeout: float = 60.0) -> None:
        """Block until every submitted block has been hashed + persisted."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._pending == 0, timeout):
                raise TimeoutError("block indexer did not drain")

    def close(self, timeout: float = 60.0) -> None:
        self.flush(timeout)
        self._q.put(_STOP)
        self._thread.join(timeout)

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
