"""Batched compression plane: the counterpart of
juicefs_tpu/tpu/compress_batch.py.

`CompressPlane` mirrors the `HashPipeline` backend contract (`cpu | cuda`,
gpu/pipeline.py):

  cpu   batched encode: the batch fans out across a qos "slice"-lane
        executor sized to the host cores, one zero-copy liblz4 call per
        block (ctypes releases the GIL, so lanes compress in parallel).
  cuda  the same CPU lane encode (output stays byte-identical to the
        serial ctypes path), plus the per-block entropy predictions of
        the SAME packed device tensors the ingest stage uploaded for
        hashing (`HashPipeline.shard_packed`): one upload feeds the hash
        digests AND the estimate. The estimate is advisory (ratio
        telemetry); the encoded bytes come from liblz4 either way, which
        keeps every volume readable by both packages.

`cuda` is the default. A volume's or mount's `xla` names it too, as
`chunk/indexer.py pipeline_backend` maps it for hashing.

The plane computes no estimate itself: the sharding plane estimates every
ingest batch it hashes (`ShardPlane.hash_async` inside `advised()`), and
the plane records those advisories (`estimate_packed`). A batch on one
device is estimated in its hash launch (the row chain's
`jth256_block_digests_estimate` entry); a batch split over a mesh by the
mesh's histogram and entropy programs (`sharding.sharded_estimate_step`).

`estimate(words, lane_counts)` is the counterpart of the reference's
XLA estimator program (not a Pallas kernel): it takes every 16th row and
every 16th column of each 64 KiB lane (64 words = 256 bytes), builds a
256-bin byte histogram per block with lanes at or past `lane_counts`
masked out, and returns min(entropy / 8, 1). It is `byte_histogram` and
then `entropy_ratio`: on the card two launches of a hand-written kernel
(`gpu/kernels/compress_estimate.cu`, entries `compress_histogram` and
`compress_entropy`, counted in `kernels.LAUNCHES`), the sampled words'
bytes binned in shared memory and the blocks' counts gathered by the last
CTA of each block to arrive, then the entropy; on the CPU the plain torch
versions (`byte_histogram_ref`: a strided view, the little-endian byte
view of the sampled words, one `scatter_add_` into a (B, 256) float32
histogram; `entropy_ratio_ref`). A mesh runs the same pair, one
histogram a lane shard with its lane offset, summed over the lane axis
before the entropy. Every bin holds an integer count below 2^24, so the
histogram is exact either way and the advisories of one device and of
every mesh are the same bits; the entropy may differ from XLA's in the
last ulp.

Degrades: a lane fan-out that cannot place work (scheduler closed, queue
full under `nowait`) degrades that batch to the serial in-thread encode,
and a failed estimating hash (`estimate_failed`) is logged at WARNING
and stops estimating. Both count in `degraded`. Unlike the reference,
which falls back from its device backend to cpu at construction, an
active `cuda` plane checks its device at construction and raises when
there is no card (`device=None` means the process-wide sharding plane
over every card, as for the hash pipeline; tests pass `device="cpu"` for
the plain torch path). The none-compressor plane does no device work and
checks nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..metric import global_registry
from ..utils import get_logger
from . import kernels
from .hash_torch import _int64_on, zeroed_workspace
from .jth256 import COLS, ROWS

logger = get_logger("gpu.compress")

_reg = global_registry()
_BATCH_BLOCKS = _reg.histogram(
    "juicefs_compress_batch_blocks", "Blocks per batched compress call",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
_BYTES_IN = _reg.counter(
    "juicefs_compress_bytes_in", "Raw bytes entering the compression plane"
)
_BYTES_OUT = _reg.counter(
    "juicefs_compress_bytes_out", "Compressed bytes leaving the plane"
)
_RATIO = _reg.histogram(
    "juicefs_compress_ratio",
    "Per-block compressed/raw size ratio (1.0+ = incompressible)",
    buckets=(0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9, 0.97, 1.0, 1.1),
)
_DEGRADED = _reg.counter(
    "juicefs_compress_degraded",
    "Compression-plane degrades taken (estimator failure, lane fan-out -> "
    "serial in-thread encode)",
)

SAMPLE_STRIDE = 16  # every 16th row and column: 64 words of a 128x128 lane
_WORK_WORDS = 1 + 256  # the kernel's workspace a block: arrivals, then counts


@dataclass
class CompressBatchConfig:
    backend: str = "cuda"  # cuda (estimator on the card) | cpu
    # parallel encode lanes on the qos "slice" lane; 0 = host cores
    lanes: int = 0
    # batches below either floor encode serially: a lane hop costs more
    # than it saves on a lone or tiny block
    min_fanout_blocks: int = 2
    min_fanout_bytes: int = 64 << 10


def byte_histogram_ref(words: torch.Tensor, lane_counts: torch.Tensor,
                       lane_offset: int = 0) -> torch.Tensor:
    """Plain torch sampled byte histogram: int32 words (B, M, 128, 128) and
    lane counts (B,) -> float32 (B, 256), on the words' device. The M lanes
    are lanes [lane_offset, lane_offset + M) of each block: a lane is
    counted when its global index is below the block's lane count, so
    per-shard histograms of a lane-split batch sum to the whole batch's."""
    b, m = words.shape[0], words.shape[1]
    sub = words[:, :, ::SAMPLE_STRIDE, ::SAMPLE_STRIDE].reshape(b, -1)
    # little-endian bytes of each sampled word, in word order: the same
    # order as the reference's stack of (w >> 8i) & 0xFF over i
    by = sub.contiguous().view(torch.uint8).to(torch.int64)  # (B, M*256)
    per_lane = by.shape[1] // m
    first = lane_offset * per_lane
    lane = torch.arange(first, first + by.shape[1], device=words.device) // per_lane
    counts = lane_counts.to(device=words.device, dtype=torch.int64)
    w = (lane[None, :] < counts[:, None]).to(torch.float32)
    h = torch.zeros((b, 256), dtype=torch.float32, device=words.device)
    return h.scatter_add_(1, by, w)


def entropy_ratio_ref(h: torch.Tensor) -> torch.Tensor:
    """Plain torch entropy: float32 byte histograms (B, 256) -> predicted
    compressed-size fractions min(entropy / 8, 1), float32 (B,)."""
    p = h / torch.clamp(h.sum(-1, keepdim=True), min=1.0)
    # 0 * log2(0) is NaN in the branch not taken; the where discards it
    ent = -torch.where(p > 0, p * torch.log2(p), torch.zeros_like(p)).sum(-1)
    return torch.clamp(ent / 8.0, max=1.0)


def _on_card(x: torch.Tensor, entry: str) -> bool:
    """True for a CUDA tensor (the kernel's), False for a CPU one (the
    plain version's); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{entry} runs on cuda or cpu, not {x.device}")
    return True


def _card_words(words: torch.Tensor, lane_counts: torch.Tensor) -> torch.Tensor:
    """Checks packed words for the kernel; returns the lane counts as a
    contiguous int64 (B,) tensor on the words' card."""
    b = words.shape[0]
    if words.dtype != torch.int32 or words.dim() != 4 or words.shape[1] < 1 \
            or words.shape[2:] != (ROWS, COLS) or not words.is_contiguous():
        raise ValueError(f"words must be contiguous int32 (B, M >= 1, {ROWS}, {COLS}), "
                         f"got {words.dtype} {tuple(words.shape)}")
    counts = _int64_on(lane_counts, words.device)
    if counts.shape != (b,):
        raise ValueError(f"lane_counts must be ({b},), got {tuple(counts.shape)}")
    return counts


def _launch(entry: str, dev: torch.device, *args, work_blocks: int = 0) -> None:
    """Launch `entry` with `args` on the current stream of `dev`. With
    `work_blocks`, the stream's zeroed workspace for that many blocks goes
    after the first two arguments (the words and their lane counts)."""
    fn = kernels.function(entry)
    switch = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        stream = torch.cuda.current_stream(dev).cuda_stream
        if work_blocks:
            work = zeroed_workspace(entry, dev, stream, work_blocks, _WORK_WORDS)
            args = (*args[:2], work.data_ptr(), *args[2:])
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    kernels.LAUNCHES[entry] += 1


def byte_histogram(words: torch.Tensor, lane_counts: torch.Tensor,
                   lane_offset: int = 0) -> torch.Tensor:
    """Sampled byte histogram: int32 words (B, M, 128, 128) and lane counts
    (B,) -> float32 (B, 256) integer counts, on the words' device, lanes
    [lane_offset, lane_offset + M) of each block. One launch of the
    kernel's `compress_histogram` entry on the card; `byte_histogram_ref`
    on the CPU."""
    if not _on_card(words, "byte_histogram"):
        return byte_histogram_ref(words, lane_counts, lane_offset)
    counts = _card_words(words, lane_counts)
    b, m = words.shape[0], words.shape[1]
    out = torch.empty((b, 256), dtype=torch.float32, device=words.device)
    if b:
        _launch("compress_histogram", words.device, words.data_ptr(), counts.data_ptr(),
                out.data_ptr(), b, m, int(lane_offset) & 0xFFFFFFFF, work_blocks=b)
    return out


def entropy_ratio(h: torch.Tensor) -> torch.Tensor:
    """float32 byte histograms (B, 256) of integer counts -> predicted
    compressed-size fractions min(entropy / 8, 1), float32 (B,). One launch
    of the kernel's `compress_entropy` entry on the card;
    `entropy_ratio_ref` on the CPU."""
    if not _on_card(h, "entropy_ratio"):
        return entropy_ratio_ref(h)
    if h.dtype != torch.float32 or h.dim() != 2 or h.shape[1] != 256:
        raise ValueError(f"histograms must be float32 (B, 256), got {h.dtype} "
                         f"{tuple(h.shape)}")
    h = h.contiguous()
    out = torch.empty((h.shape[0],), dtype=torch.float32, device=h.device)
    if h.shape[0]:
        _launch("compress_entropy", h.device, h.data_ptr(), out.data_ptr(), h.shape[0])
    return out


def estimate(words: torch.Tensor, lane_counts: torch.Tensor) -> torch.Tensor:
    """Per-block compressibility estimate of a packed batch already on its
    device: int32 words (B, M, 128, 128), lane counts (B,) -> float32 (B,)
    predicted compressed-size fractions min(entropy / 8, 1). `entropy_ratio`
    of `byte_histogram`, a mesh's estimate with one shard; any device but
    cuda or cpu raises."""
    return entropy_ratio(byte_histogram(words, lane_counts))


def compress_backend(name: str) -> str:
    """Map a volume's or mount's compress backend name onto the port's."""
    from ..chunk.indexer import pipeline_backend

    return pipeline_backend(name)


class CompressPlane:
    """Batched write-path compression with the hash plane's degrade
    contract. `compress_one` is the single-block seam `_put_block`
    routes through (serial fast path, the degrade target); the ingest
    finalizer feeds whole MISS batches to `compress_blocks`."""

    def __init__(self, compressor, config: Optional[CompressBatchConfig] = None,
                 scheduler=None, device=None):
        self.compressor = compressor
        self.config = config or CompressBatchConfig()
        self.config.backend = compress_backend(self.config.backend)
        self.device: Optional[torch.device] = None
        if self.config.backend == "cuda" and self.active:
            # device=None is where the hash pipeline's device=None hashes:
            # the process-wide sharding plane, which raises without a card
            if device is None:
                from .sharding import get_plane

                device = get_plane().home
            self.device = torch.device(device)
        # True while the plane takes advisories; a failed estimate clears it
        self.estimating = self.device is not None
        self._exec = None
        self.lanes = 0
        if self.active:
            from ..qos import IOClass, global_scheduler

            sched = scheduler or global_scheduler()
            self.lanes = self.config.lanes or max(2, os.cpu_count() or 2)
            # qos lane sizing: the encode fan-out shares the "slice" lane
            # (CPU-bound work, same as the read-side slice spool) at
            # INGEST class — it outranks background bulk work but never
            # starves a foreground read's slice fan-out
            self._exec = sched.executor("slice", IOClass.INGEST,
                                        width=self.lanes)
        self._lock = threading.Lock()
        # stats mirror of the global counters, per plane (bench/tests)
        self.blocks = 0
        self.batches = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.degraded = 0
        self.estimated = 0
        self.last_estimate: Optional[list] = None

    @property
    def active(self) -> bool:
        """False for the none-compressor: everything passes through."""
        return bool(self.compressor.name)

    @property
    def backend(self) -> str:
        return self.config.backend

    # -- single block (the `_put_block` seam) ------------------------------
    def compress_one(self, raw) -> bytes:
        data = self.compressor.compress(raw)
        self._account([len(raw)], [len(data)], batch=False)
        return data

    # -- whole batch (the ingest-finalizer seam) ---------------------------
    def compress_blocks(self, blocks: Sequence) -> list[bytes]:
        """Compress a batch, fanning out across the slice lane. Output is
        byte-identical to [compressor.compress(b) for b in blocks]."""
        blocks = list(blocks)
        if not blocks:
            return []
        if not self.active:
            return [self.compressor.compress(b) for b in blocks]
        nbytes = sum(len(b) for b in blocks)
        if (self._exec is None
                or len(blocks) < self.config.min_fanout_blocks
                or nbytes < self.config.min_fanout_bytes):
            out = [self.compressor.compress(b) for b in blocks]
        else:
            out = self._fanout(blocks)
        self._account([len(b) for b in blocks], [len(d) for d in out])
        return out

    def _fanout(self, blocks: list) -> list[bytes]:
        # one task per LANE, not per block: each submit/result crossing
        # is Python-level work competing for the GIL against the encode
        # threads themselves — chunking keeps the lanes C-dominated
        n = min(self.lanes, len(blocks))
        step = -(-len(blocks) // n)
        chunks = [blocks[i:i + step] for i in range(0, len(blocks), step)]
        comp = self.compressor

        def encode(chunk: list) -> list[bytes]:
            return [comp.compress(b) for b in chunk]

        futs = []
        for chunk in chunks:
            try:
                # nowait: a saturated slice lane must degrade THIS batch
                # to the serial path, not park the ingest worker behind
                # someone else's backlog (advisory contract)
                futs.append(self._exec.submit(encode, chunk, nowait=True))
            except (TimeoutError, RuntimeError):
                futs.append(None)
        out: list[bytes] = []
        degraded = 0
        for chunk, f in zip(chunks, futs):
            if f is None:
                degraded += len(chunk)
                out.extend(comp.compress(b) for b in chunk)
            else:
                out.extend(f.result())
        if degraded:
            self.degraded += degraded
            _DEGRADED.inc(degraded)
        return out

    def estimate_packed(self, advisories: torch.Tensor) -> None:
        """Record the advisories of a hash batch: the float32 (n,) host
        tensor, one a hashed block, that the shared pack's hash computed
        (`HashPipeline.hash_packed(..., advise=True)`)."""
        with self._lock:
            self.estimated += len(advisories)
            self.last_estimate = [round(float(p), 4) for p in advisories]

    def estimate_failed(self, e: Exception) -> None:
        """The hash that also estimates failed: logged and counted, and the
        plane stops estimating (a broken device costs no more retries)."""
        logger.warning("compress estimate degraded: %s", e)
        self.degraded += 1
        _DEGRADED.inc()
        self.estimating = False

    def _account(self, sizes_in: list, sizes_out: list, batch=True) -> None:
        n_in, n_out = sum(sizes_in), sum(sizes_out)
        _BYTES_IN.inc(n_in)
        _BYTES_OUT.inc(n_out)
        if batch:
            _BATCH_BLOCKS.observe(len(sizes_in))
        for i, o in zip(sizes_in, sizes_out):
            if i > 0:
                _RATIO.observe(o / i)
        with self._lock:
            self.blocks += len(sizes_in)
            if batch:
                self.batches += 1
            self.bytes_in += n_in
            self.bytes_out += n_out

    def close(self) -> None:
        """Drain this plane's outstanding lane submissions (the executor
        owns only its own futures — closing never stops slice-lane
        workers another consumer shares)."""
        if self._exec is not None:
            self._exec.shutdown(wait=True, timeout=60.0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "backend": self.backend,
                "algorithm": self.compressor.name or "none",
                "lanes": self.lanes,
                "blocks": self.blocks,
                "batches": self.batches,
                "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
                "ratio": round(self.bytes_out / self.bytes_in, 4)
                if self.bytes_in else 0.0,
                "degraded": self.degraded,
                "estimated": self.estimated,
            }
