"""The port's write-path BlockIndexer (juicefs_tpu_torch/chunk/indexer.py)
against the JAX package's.

The same blocks, made from a seed with numpy, are submitted under the same
block keys to both indexers, each over its own package's mem:// meta; the
digest rows they persist must be identical (exact). The overload contract
is the reference's (tests/test_index.py): a full queue drops the block
(counted) instead of blocking the upload worker.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from juicefs_tpu.chunk.indexer import BlockIndexer as RefBlockIndexer
from juicefs_tpu.meta import new_client as ref_new_client
from juicefs_tpu.meta.types import Format as RefFormat
from juicefs_tpu.tpu.jth256 import jth256
from juicefs_tpu_torch.chunk.cached_store import block_key
from juicefs_tpu_torch.chunk.indexer import BlockIndexer
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.metric.trace import stage_metrics_snapshot

BS = 256 << 10  # 4 lanes a block


def _blocks(seed: int = 3):
    """11 full blocks (two of them repeats) and a ragged tail."""
    rng = np.random.default_rng(seed)
    full = [rng.integers(0, 256, size=BS, dtype=np.uint8).tobytes() for _ in range(9)]
    full += [full[2], full[5]]
    return full + [rng.integers(0, 256, size=BS // 3 + 11, dtype=np.uint8).tobytes()]


def _rows(m) -> dict:
    return {(sid, indx): (bsize, d) for sid, indx, bsize, d in m.scan_block_digests()}


@pytest.mark.parametrize("kw", [{"device": "cpu"}, {"backend": "cpu"}],
                         ids=["cuda-backend-on-cpu-tensors", "cpu-backend"])
def test_indexer_rows_match_reference(kw):
    blocks = _blocks()
    ref_m = ref_new_client("mem://")
    ref_m.init(RefFormat(name="ix"), force=True)
    m = new_client("mem://")
    m.init(Format(name="ix"), force=True)
    ref = RefBlockIndexer(meta=ref_m, backend="cpu", block_size=BS, batch_blocks=4)
    port = BlockIndexer(meta=m, block_size=BS, batch_blocks=4, **kw)
    assert port.backend == kw.get("backend", "cuda")
    batches0 = stage_metrics_snapshot().get("gpu.index.batch", {"count": 0})["count"]
    try:
        for i, data in enumerate(blocks):
            key = block_key(40 + i, i % 3, len(data))
            ref.submit(key, data)
            port.submit(key, data)
        ref.flush()
        port.flush()
        want = _rows(ref_m)
        assert len(want) == len(blocks)
        assert _rows(m) == want
        assert sorted(d for _b, d in want.values()) == sorted(jth256(b) for b in blocks)
        st, ref_st = port.stats(), ref.stats()
        for k in ("blocks", "bytes", "errors", "dropped"):
            assert st[k] == ref_st[k], k
        assert st["backend"] == port.backend
        # one batch histogram entry per hashed batch (chip_smoke.py counts
        # kernel launches against it)
        batches = stage_metrics_snapshot()["gpu.index.batch"]["count"] - batches0
        assert 1 <= batches <= len(blocks)
    finally:
        ref.close()
        port.close()


def test_indexer_ignores_foreign_keys():
    idx = BlockIndexer(meta=None, backend="cpu", block_size=1 << 18)
    try:
        idx.submit("not-a-chunk-key", b"xyz")  # silently skipped
        idx.submit(block_key(7, 0, 5), b"hello")
        idx.flush()
        s = idx.stats()
        assert s["blocks"] == 1 and s["bytes"] == 5 and s["errors"] == 0
    finally:
        idx.close()


def test_indexer_drops_under_overload_without_blocking_writes():
    """A slow hash backend must never throttle the foreground write path:
    with the queue full, submit() drops (counted) instead of blocking; gc
    --dedup backfills the missing rows (tests/test_torch_cmd.py)."""
    idx = BlockIndexer(meta=None, device="cpu", block_size=1 << 16,
                       batch_blocks=4, queue_blocks=4)
    real = idx._pipe.hash_blocks

    def slow(blocks):
        time.sleep(0.05)  # deliberately pathological backend: 50 ms a batch
        return real(blocks)

    idx._pipe.hash_blocks = slow
    data = b"\xab" * (1 << 16)
    n = 200
    try:
        t0 = time.perf_counter()
        for i in range(n):
            idx.submit_raw(7, i, len(data), data)
        elapsed = time.perf_counter() - t0
        # 200 blocks at 50 ms a 4-block batch would take >2.5 s if submit()
        # blocked; the drop path keeps the producer at memcpy speed
        assert elapsed < 0.5, f"submit path blocked for {elapsed:.2f}s"
        assert idx.dropped > 0
        idx.flush(timeout=30)
        assert idx.blocks + idx.dropped == n
        assert idx.stats()["dropped"] == idx.dropped
    finally:
        idx.close()


def test_failed_batch_is_counted_and_logged(caplog):
    idx = BlockIndexer(meta=None, device="cpu", block_size=1 << 16)

    def broken(blocks):
        raise RuntimeError("device lost")

    idx._pipe.hash_blocks = broken
    try:
        with caplog.at_level("WARNING", logger="chunk.indexer"):
            idx.submit_raw(1, 0, 3, b"abc")
            idx.submit_raw(1, 1, 3, b"def")
            idx.flush(timeout=30)
        st = idx.stats()
        assert st["errors"] == 2 and st["blocks"] == 0
        assert any("index batch of" in r.getMessage() for r in caplog.records)
    finally:
        idx.close()


def test_default_backend_is_the_card():
    """BlockIndexer() hashes on the card; with none it raises at
    construction instead of hashing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: construction succeeds")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockIndexer()

