"""Streaming host->device hash pipeline: the counterpart of
juicefs_tpu/tpu/pipeline.py.

Feeds block bytes from the chunk/object layer to the card in fixed-shape
batches and returns (key, digest) pairs. Torch launches are asynchronous,
so the pipeline keeps up to `max_inflight_batches` batches in flight:
each batch is packed straight into a pinned host staging slot, uploaded
with `non_blocking=True`, hashed, and its digests copied back into a
pinned result buffer, all queued on the current stream; the host then
packs batch k+1 while the card works on batch k, and blocks only on the
oldest batch's completion event. A staging slot is packed again only
after the event recorded behind its upload has completed, so a reused
buffer is never overwritten while its copy is still in flight.

Backends: "cpu" (the host: `native.jth256_batch`, the C++ library with
the numpy spec as its fallback, as the reference hashes on its cpu
backend) and "cuda" (the row chain kernel plus torch fold ops). The
"cuda" backend rides the sharding plane (gpu/sharding.py): every upload
is one counted placement and every batch runs the plane's hash program.
`device=None` takes the process-wide plane over every local card (one
card: the one-device path, the same pinned upload, one launch and fold
as without a plane); an explicit `device` a one-device plane over it;
`plane=` a given plane (the CPU tests pass `ShardPlane([cpu] * n)`). The
port has one device backend, so "cuda" stands for both the reference's
"xla" (on the plane) and its "pallas" (one device).
Unlike the reference, which logs and degrades to the CPU when its device
backend is unavailable, the "cuda" backend raises: a digest computed on
the CPU must never be reported as a device run. `device="cpu"` is the
explicit request for the plain torch path that the CPU tests make.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..metric import global_registry
from ..metric.trace import global_tracer, stage_hist
from .sharding import ShardedTensor, plane_for
from .jth256 import (
    BLOCK_BYTES,
    COLS,
    LANE_BYTES,
    ROWS,
    digests_to_bytes,
    hash_packed_np,
    pack_blocks,
    pack_into,
)

_reg = global_registry()
_BLOCKS_HASHED = _reg.counter(
    "juicefs_torch_blocks_hashed", "Blocks hashed by the torch pipeline"
)
_HASH_BYTES = _reg.counter(
    "juicefs_torch_hash_bytes", "Raw bytes hashed by the torch pipeline"
)
_H2D_BYTES = _reg.counter(
    "juicefs_torch_h2d_bytes",
    "Host-to-device bytes shipped as packed hash batches",
)
_BATCH_BLOCKS = _reg.histogram(
    "juicefs_torch_batch_blocks", "Blocks per dispatched hash batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
_TR = global_tracer()
_H_DISPATCH = stage_hist("gpu", "hash", "dispatch")
_H_DRAIN = stage_hist("gpu", "hash", "drain")
# the parts of a device dispatch, each on the thread that feeds the card:
# waiting for a staging slot's last upload, the host pack, the HtoD
# enqueue, and the hash launch with its DtoH enqueue
_H_SLOT_WAIT = stage_hist("gpu", "hash", "slot_wait")
_H_PACK = stage_hist("gpu", "hash", "pack")
_H_UPLOAD = stage_hist("gpu", "hash", "upload")
_H_LAUNCH = stage_hist("gpu", "hash", "launch")
# a block's time in HashBatcher's queue, from submit() to its batch
_H_BATCHER_WAIT = stage_hist("gpu", "batcher", "wait")

BACKENDS = ("cpu", "cuda")


@dataclass
class PipelineConfig:
    backend: str = "cuda"  # cpu | cuda
    batch_blocks: int = 32
    # Pad every batch to this many lanes (4 MiB default block = 64 lanes)
    pad_lanes: int = BLOCK_BYTES // LANE_BYTES
    # Dispatched-but-undrained batches allowed before hash_stream blocks on
    # the oldest result. 2 = classic double buffering.
    max_inflight_batches: int = 2


class _Slot:
    """One host staging buffer (pinned on a CUDA device) and the event
    recorded behind the upload that last read it."""

    def __init__(self, cfg: PipelineConfig, pinned: bool):
        shape = (cfg.batch_blocks, cfg.pad_lanes, ROWS, COLS)
        self.words = torch.empty(shape, dtype=torch.int32, pin_memory=pinned)
        self.counts = torch.empty((cfg.batch_blocks,), dtype=torch.int64,
                                  pin_memory=pinned)
        self.lengths = torch.empty((cfg.batch_blocks,), dtype=torch.int64,
                                   pin_memory=pinned)
        self.uploaded: list = []  # CUDA events behind the last upload

    def pack_row(self, i: int, block) -> None:
        """Pack one block into row i, zero-padded, with its lane count and
        length. The copy is a memoryview assignment, which holds the
        interpreter lock through its memcpy, as a `bytes()` copy does: a
        numpy copy would drop the lock and take it back, and with busy
        threads about each retake waits up to the switch interval."""
        row = self.words.numpy()[i].reshape(-1).view(np.uint8)
        n = len(block)
        if n > row.size:
            raise ValueError(f"block of {n} bytes larger than the slot's "
                             f"{row.size}-byte rows")
        counts, lengths = self.counts.numpy(), self.lengths.numpy()
        counts[i], lengths[i] = 1, 0  # an empty row until the copy is whole
        memoryview(row)[:n] = memoryview(block).cast("B")
        row[n:] = 0
        counts[i], lengths[i] = max(1, -(-n // LANE_BYTES)), n


class HashPipeline:
    """hash_stream(iter[(key, bytes)]) -> iter[(key, 32-byte digest)]."""

    def __init__(self, config: Optional[PipelineConfig] = None, device=None,
                 plane=None):
        self.config = config or PipelineConfig()
        if self.config.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.config.backend!r} (want cpu|cuda)")
        self.plane = None
        self.device: Optional[torch.device] = None
        if self.config.backend == "cuda":
            self.plane = plane if plane is not None else plane_for(device)
            self.device = self.plane.home
        self._slots: list[_Slot] = []
        self._next_slot = 0

    @property
    def device_backend(self) -> bool:
        """True when digests come off the torch device path."""
        return self.device is not None

    def _slot(self) -> _Slot:
        cfg = self.config
        if not self._slots:
            pinned = self.device.type == "cuda"
            self._slots = [_Slot(cfg, pinned)
                           for _ in range(max(1, cfg.max_inflight_batches) + 1)]
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        with _TR.span("gpu", "hash", stage="slot_wait", hist=_H_SLOT_WAIT):
            for ev in slot.uploaded:
                ev.synchronize()
        slot.uploaded = []
        return slot

    def staging_slot(self) -> _Slot:
        """A staging slot of this pipeline's batch shape (pinned on a card)
        of the caller's own, who packs its rows (`_Slot.pack_row`) and
        hashes them with `hash_slot`."""
        return _Slot(self.config, self.device is not None and self.device.type == "cuda")

    def hash_slot(self, slot: _Slot, n: int) -> list[bytes]:
        """The digests of the first n rows of a staging slot the caller
        packed, waited for: on a device backend one placement and one
        launch, as a batch of `hash_stream`; on the host backend the host
        hash of the rows."""
        lengths = slot.lengths.numpy()[:n]
        nbytes = int(lengths.sum())
        with _TR.span("gpu", "hash", stage="dispatch", hist=_H_DISPATCH) as sp:
            if sp.active:
                sp.set(batch=n, bytes=nbytes, backend=self.config.backend)
            if self.device is not None:
                out = self._dispatch_slot(slot, n)
            else:
                from .. import native

                words = slot.words.numpy()[:n]
                if native.available():
                    rows = words.reshape(n, -1).view(np.uint8)
                    out = native.jth256_batch([rows[i, :int(lengths[i])] for i in range(n)])
                else:
                    out = digests_to_bytes(hash_packed_np(
                        words.view(np.uint32), slot.counts.numpy()[:n], lengths))
        _BATCH_BLOCKS.observe(n)
        _BLOCKS_HASHED.inc(n)
        _HASH_BYTES.inc(nbytes)
        return self._digests(out, n)

    def _digests(self, out, n: int) -> list[bytes]:
        """The first n digests of a dispatched batch: a host hash's list
        as it is, a device batch's after the blocking wait for its copy
        back, where the device latency lands."""
        if isinstance(out, list):
            return out[:n]
        with _TR.span("gpu", "hash", stage="drain", hist=_H_DRAIN) as sp:
            if sp.active:
                sp.set(batch=n, backend=self.config.backend)
            host, done = out
            if done is not None:
                done.synchronize()
            return digests_to_bytes(host.numpy().astype(np.uint32))[:n]

    def _dispatch_device(self, blocks: list[bytes]):
        """Pack into a staging slot and dispatch it (`_dispatch_slot`)."""
        n = len(blocks)
        slot = self._slot()
        with _TR.span("gpu", "hash", stage="pack", hist=_H_PACK):
            counts, lengths = pack_into(slot.words.numpy(), blocks)
            slot.counts.numpy()[:n] = counts
            slot.lengths.numpy()[:n] = lengths
        return self._dispatch_slot(slot, n)

    def _dispatch_slot(self, slot: _Slot, n: int):
        """Place the first n packed rows of a staging slot through the
        plane (one placement), hash; returns the pending (host digests
        tensor, completion event or None)."""
        cuda = self.device.type == "cuda"
        with _TR.span("gpu", "hash", stage="upload", hist=_H_UPLOAD):
            packed = self.plane.put_packed(slot.words[:n], slot.counts[:n],
                                           slot.lengths[:n])
            if cuda:
                slot.uploaded = self.plane.record_events()
        _H2D_BYTES.inc(slot.words[:n].numel() * 4)
        with _TR.span("gpu", "hash", stage="launch", hist=_H_LAUNCH):
            h = self.plane.hash_async(*packed)
            if not cuda:
                return h, None
            out = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
            out.copy_(h, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(h.device))
        return out, done

    def hash_stream(
        self, items: Iterable[tuple[str, bytes]]
    ) -> Iterator[tuple[str, bytes]]:
        cfg = self.config
        pending: list[tuple[list[str], object]] = []
        keys: list[str] = []
        blocks: list[bytes] = []

        def dispatch():
            nonlocal keys, blocks
            if not blocks:
                return
            nbytes = sum(len(b) for b in blocks)
            with _TR.span("gpu", "hash", stage="dispatch",
                          hist=_H_DISPATCH) as sp:
                if sp.active:
                    sp.set(batch=len(blocks), bytes=nbytes,
                           backend=cfg.backend)
                if self.device is None:
                    # host path: hash raw bytes directly (native C++ batch
                    # with numpy fallback), no packing, no transfer (h2d
                    # counter untouched)
                    from .. import native

                    pending.append((keys, native.jth256_batch(blocks)))
                else:
                    pending.append((keys, self._dispatch_device(blocks)))
            _BATCH_BLOCKS.observe(len(blocks))
            _BLOCKS_HASHED.inc(len(blocks))
            _HASH_BYTES.inc(nbytes)
            keys, blocks = [], []

        def drain(batch) -> Iterator[tuple[str, bytes]]:
            bkeys, out = batch
            return zip(bkeys, self._digests(out, len(bkeys)))

        for key, data in items:
            if len(data) > cfg.pad_lanes * LANE_BYTES:
                raise ValueError(f"block {key} larger than pipeline pad size")
            keys.append(key)
            blocks.append(data)
            if len(blocks) >= cfg.batch_blocks:
                dispatch()
                depth = max(1, cfg.max_inflight_batches)
                while len(pending) >= depth:
                    yield from drain(pending.pop(0))
        dispatch()
        while pending:
            yield from drain(pending.pop(0))

    def hash_blocks(self, blocks: Iterable[bytes]) -> list[bytes]:
        return [d for _, d in self.hash_stream((str(i), b) for i, b in enumerate(blocks))]

    def pack_batch(self, blocks):
        """Pack a batch for `shard_packed` to its own longest block: its
        lanes rounded up to the plane's lane-axis extent, so that a
        lane-split mesh still splits it, with the configured pad as the
        ceiling. Padding never enters a digest or an advisory (lane_counts
        masks it out), so a 128 KiB block ships and chains 2 lanes, not a
        4 MiB block size's 64."""
        return pack_blocks(blocks, pad_lanes=self.config.pad_lanes,
                           multiple=self.plane.n_lane if self.plane is not None else 1)

    def shard_packed(self, packed):
        """Place a packed (words, counts, lengths) triple on the plane once,
        so several consumers share one placement (`ShardPlane.put_packed`:
        a `ShardedPack` whose `batch` is the size before padding). The cpu
        backend returns the host arrays unchanged."""
        if self.plane is None:
            return packed
        _H2D_BYTES.inc(int(np.prod(packed[0].shape)) * 4)
        with _TR.span("gpu", "hash", stage="upload", hist=_H_UPLOAD):
            return self.plane.put_packed(*packed)

    def shard_snapshot(self) -> dict:
        """Sharding-plane stats (gc --dedup output)."""
        if self.plane is not None:
            return self.plane.snapshot()
        return {
            "devices": 0,
            "mesh": None,
            "degraded": False,
            "reason": f"{self.config.backend} backend",
        }

    def hash_packed(self, words, counts, lengths, n: int | None = None,
                    advise: bool = False):
        """Digest a pre-packed batch (host arrays, or the placed tensors of
        `shard_packed`); `n` slices the outputs back to the original batch
        size when the input was padded.

        With `advise` it returns (digests, advisories): the plane hashes
        the batch and estimates it for the compress plane where it lies
        (`ShardPlane.advised`), its advisories a float32 host tensor of n;
        advisories are None only where the plane's hash appended none."""
        if n is None:
            n = int(words.shape[0])
        if isinstance(lengths, (torch.Tensor, ShardedTensor)):
            lens = lengths.cpu().numpy()
        else:
            lens = np.asarray(lengths)
        nbytes = int(lens[:n].astype(np.int64).sum())
        advisories = None
        with _TR.span("gpu", "hash", stage="dispatch",
                      hist=_H_DISPATCH) as sp:
            if sp.active:
                sp.set(batch=n, bytes=nbytes, backend=self.config.backend)
            if self.plane is None:
                out = hash_packed_np(np.asarray(words), np.asarray(counts),
                                     np.asarray(lengths))
            else:
                if isinstance(words, np.ndarray):
                    _H2D_BYTES.inc(words.nbytes)
                with self.plane.advised() if advise else contextlib.nullcontext() as advice:
                    out = self.plane.hash_packed(words, counts, lengths, n=n)
                if advice:
                    advisories = advice[0][:n].cpu()
        _BATCH_BLOCKS.observe(n)
        _BLOCKS_HASHED.inc(n)
        _HASH_BYTES.inc(nbytes)
        digests = digests_to_bytes(out)[:n]
        return (digests, advisories) if advise else digests


_FLUSH = object()  # kick(): hash whatever is buffered NOW (commit barrier)
_CLOSE = object()


class HashBatcher:
    """Bounded-queue accumulator in front of a HashPipeline (a copy of the
    reference's flush-timeout batcher).

    Producers `submit()` without ever blocking (a full queue returns False:
    overload is the caller's degrade signal), and the consumer pulls
    batches flushed by whichever comes first:

      - the batch filled (`batch_blocks`),
      - `flush_timeout` expired since the batch's first block, or
      - `kick()`: a commit barrier is waiting; hash what we have NOW.

    Each item's time from `submit()` to its batch is observed under
    `gpu.batcher.wait` as the batch is handed out.
    """

    def __init__(self, pipe: HashPipeline, queue_blocks: int = 64,
                 flush_timeout: float = 0.005):
        import queue as _queue

        self.pipe = pipe
        self.flush_timeout = flush_timeout
        self._q: "_queue.Queue" = _queue.Queue(maxsize=max(1, queue_blocks))
        self._empty = _queue.Empty
        self._full = _queue.Full
        self._closed = False

    def submit(self, item) -> bool:
        """Producer side; False when the queue is full or the batcher is
        closed. Never blocks."""
        if self._closed:
            return False
        try:
            self._q.put_nowait((time.perf_counter(), item))
            return True
        except self._full:
            return False

    def kick(self) -> None:
        """Flush the current partial batch now. Non-blocking: on a full
        queue the marker is dropped (the batch flushes on size or timeout)."""
        try:
            self._q.put_nowait(_FLUSH)
        except self._full:
            pass

    def close(self) -> None:
        """Non-blocking: the closed flag is authoritative; the sentinel is
        only a wake-up fast path, dropped when there is no room."""
        self._closed = True
        try:
            self._q.put_nowait(_CLOSE)
        except self._full:
            pass

    def qsize(self) -> int:
        return self._q.qsize()

    def batches(self) -> Iterator[list]:
        """Consumer side: yield non-empty item batches until close(). A
        close() that could not enqueue its sentinel still ends the loop
        once every accepted item was yielded."""
        batch_blocks = max(1, self.pipe.config.batch_blocks)
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except self._empty:
                if self._closed:
                    return
                continue
            if item is _CLOSE:
                return
            if item is _FLUSH:
                continue
            batch = [item]
            deadline = time.monotonic() + self.flush_timeout
            while len(batch) < batch_blocks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except self._empty:
                    break
                if nxt is _CLOSE:
                    yield _unstamp(batch)
                    return
                if nxt is _FLUSH:
                    break
                batch.append(nxt)
            yield _unstamp(batch)


def _unstamp(batch: list) -> list:
    """The items of a batch of (submit time, item), each item's wait
    observed once."""
    now = time.perf_counter()
    for t, _item in batch:
        _H_BATCHER_WAIT.observe(now - t)
    return [item for _t, item in batch]
