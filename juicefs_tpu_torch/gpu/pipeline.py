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

Backends: "cpu" (the numpy spec, `hash_packed_np`) and "cuda" (the row
chain kernel plus torch fold ops on `device`; None means the card).
Unlike the reference, which logs and degrades to the CPU when its device
backend is unavailable, the "cuda" backend raises: a digest computed on
the CPU must never be reported as a device run. `device="cpu"` is the
explicit request for the plain torch path that the CPU tests make.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..metric import global_registry
from ..metric.trace import global_tracer, stage_hist
from .hash_torch import (
    _as_int64,
    _as_words,
    hash_device,
    hash_packed as _hash_packed_device,
    resolve_device,
)
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
        self.uploaded = None  # torch.cuda.Event of the last upload


class HashPipeline:
    """hash_stream(iter[(key, bytes)]) -> iter[(key, 32-byte digest)]."""

    def __init__(self, config: Optional[PipelineConfig] = None, device=None):
        self.config = config or PipelineConfig()
        if self.config.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.config.backend!r} (want cpu|cuda)")
        self.device: Optional[torch.device] = None
        if self.config.backend == "cuda":
            self.device = resolve_device(device)
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
        if slot.uploaded is not None:
            slot.uploaded.synchronize()
            slot.uploaded = None
        return slot

    def _dispatch_device(self, blocks: list[bytes]):
        """Pack into a staging slot, upload, hash; returns the pending
        (host digests tensor, completion event or None)."""
        n = len(blocks)
        slot = self._slot()
        counts, lengths = pack_into(slot.words.numpy(), blocks)
        slot.counts.numpy()[:n] = counts
        slot.lengths.numpy()[:n] = lengths
        cuda = self.device.type == "cuda"
        words = slot.words[:n].to(self.device, non_blocking=True)
        dcounts = slot.counts[:n].to(self.device, non_blocking=True)
        dlengths = slot.lengths[:n].to(self.device, non_blocking=True)
        if cuda:
            slot.uploaded = torch.cuda.Event()
            slot.uploaded.record()
        _H2D_BYTES.inc(words.numel() * 4)
        h = hash_device(words, dcounts, dlengths)
        if not cuda:
            return h, None
        out = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
        out.copy_(h, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
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
                    # numpy spec on the host: no padding past the batch's
                    # widest block, no transfer (h2d counter untouched)
                    digests = digests_to_bytes(hash_packed_np(*pack_blocks(blocks)))
                    pending.append((keys, digests))
                else:
                    pending.append((keys, self._dispatch_device(blocks)))
            _BATCH_BLOCKS.observe(len(blocks))
            _BLOCKS_HASHED.inc(len(blocks))
            _HASH_BYTES.inc(nbytes)
            keys, blocks = [], []

        def drain(batch) -> Iterator[tuple[str, bytes]]:
            bkeys, out = batch
            if isinstance(out, list):
                digests = out
            else:
                # blocking device sync: where the device latency lands
                with _TR.span("gpu", "hash", stage="drain",
                              hist=_H_DRAIN) as sp:
                    if sp.active:
                        sp.set(batch=len(bkeys), backend=cfg.backend)
                    host, done = out
                    if done is not None:
                        done.synchronize()
                    digests = digests_to_bytes(host.numpy().astype(np.uint32))
            return zip(bkeys, digests[: len(bkeys)])

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

    def shard_packed(self, packed):
        """Place a packed (words, counts, lengths) triple on the device once,
        so several consumers share one upload. Single device: no mesh. The
        cpu backend returns the host arrays unchanged."""
        if self.device is None:
            return packed
        words, counts, lengths = packed
        dwords = _as_words(words, self.device)
        _H2D_BYTES.inc(dwords.numel() * 4)
        return (dwords, _as_int64(counts, self.device),
                _as_int64(lengths, self.device))

    def shard_snapshot(self) -> dict:
        """Placement stats (gc --dedup output): one device, no mesh."""
        return {
            "devices": 1 if self.device is not None else 0,
            "mesh": None,
            "degraded": False,
            "reason": f"{self.config.backend} backend",
        }

    def hash_packed(self, words, counts, lengths,
                    n: int | None = None) -> list[bytes]:
        """Digest a pre-packed batch (host arrays, or tensors from
        `shard_packed`); `n` slices the outputs back to the original batch
        size when the input was padded."""
        if n is None:
            n = int(words.shape[0])
        lens = lengths.cpu().numpy() if isinstance(lengths, torch.Tensor) else np.asarray(lengths)
        nbytes = int(lens[:n].astype(np.int64).sum())
        with _TR.span("gpu", "hash", stage="dispatch",
                      hist=_H_DISPATCH) as sp:
            if sp.active:
                sp.set(batch=n, bytes=nbytes, backend=self.config.backend)
            if self.device is None:
                out = hash_packed_np(np.asarray(words), np.asarray(counts),
                                     np.asarray(lengths))
            else:
                if not isinstance(words, torch.Tensor):
                    _H2D_BYTES.inc(np.asarray(words).nbytes)
                out = _hash_packed_device(words, counts, lengths, device=self.device)
        _BATCH_BLOCKS.observe(n)
        _BLOCKS_HASHED.inc(n)
        _HASH_BYTES.inc(nbytes)
        return digests_to_bytes(out)[:n]


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
            self._q.put_nowait(item)
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
                    yield batch
                    return
                if nxt is _FLUSH:
                    break
                batch.append(nxt)
            yield batch
