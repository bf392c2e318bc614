"""The port's write-path BlockIndexer (juicefs_tpu_torch/chunk/indexer.py)
against the JAX package's.

The same blocks, made from a seed with numpy, are submitted under the same
block keys to both indexers, each over its own package's mem:// meta; the
digest rows they persist must be identical (exact). The overload contract
is the reference's (tests/test_index.py): a full queue drops the block
(counted) instead of blocking the upload worker.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from juicefs_tpu.chunk.indexer import BlockIndexer as RefBlockIndexer
from juicefs_tpu.meta import new_client as ref_new_client
from juicefs_tpu.meta.types import Format as RefFormat
from juicefs_tpu.tpu.jth256 import jth256
from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
from juicefs_tpu_torch.chunk.cached_store import block_key
from juicefs_tpu_torch.chunk.indexer import BlockIndexer
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.metric import global_registry
from juicefs_tpu_torch.metric.trace import stage_metrics_snapshot
from juicefs_tpu_torch.object import create_storage
from portbench.reference import jth256 as frozen

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
    real = idx._pipe.hash_slot

    def slow(slot, n):
        time.sleep(0.05)  # deliberately pathological backend: 50 ms a batch
        return real(slot, n)

    idx._pipe.hash_slot = slow
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


@pytest.mark.parametrize("fault", ["raises", "short"])
def test_failed_batch_is_counted_and_logged(caplog, fault):
    """A hash call that raises, or returns fewer digests than blocks, fails
    its whole batch: counted, logged, no row kept, and flush returns."""
    idx = BlockIndexer(meta=None, device="cpu", block_size=1 << 16)
    real = idx._pipe.hash_slot

    def broken(slot, n):
        if fault == "raises":
            raise RuntimeError("device lost")
        return real(slot, n)[:1]

    idx._pipe.hash_slot = broken
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



COUNTERS = ("juicefs_index_blocks", "juicefs_index_bytes", "juicefs_index_dropped",
            "juicefs_index_errors")
STAGES = ("chunk.index.process", "gpu.index.batch", "chunk.index.register",
          "chunk.index.wait", "chunk.index.pack")


def _counts() -> dict:
    have = {m.name: m.value for m in global_registry().walk() if m.kind == "counter"}
    return {name: have.get(name, 0) for name in COUNTERS}


def _stage_counts() -> dict:
    snap = stage_metrics_snapshot()
    return {name: snap.get(name, {"count": 0})["count"] for name in STAGES}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def test_spans_and_counters_move_for_a_known_batch(tmp_path):
    """One full batch of 4 blocks: the registry counts 4 blocks and their
    bytes indexed, nothing dropped or failed; the worker processed one
    batch (one hash call, one index transaction), and each block left one
    wait stamp and one pack."""
    blocks = _blocks()[:4]
    m = new_client(f"sqlite3://{tmp_path / 'meta.db'}")
    m.init(Format(name="ix"), force=True)
    c0, s0 = _counts(), _stage_counts()
    idx = BlockIndexer(meta=m, device="cpu", block_size=BS, batch_blocks=4)
    try:
        for i, data in enumerate(blocks):
            idx.submit(block_key(60, i, len(data)), data)
        idx.flush(timeout=60)
    finally:
        idx.close()
    assert _delta(_counts(), c0) == {
        "juicefs_index_blocks": 4, "juicefs_index_bytes": 4 * BS,
        "juicefs_index_dropped": 0, "juicefs_index_errors": 0}
    assert _delta(_stage_counts(), s0) == {
        "chunk.index.process": 1, "gpu.index.batch": 1, "chunk.index.register": 1,
        "chunk.index.wait": 4, "chunk.index.pack": 4}
    assert len(_rows(m)) == 4
    m.client.close()


@pytest.mark.parametrize("fail_first", [False, True], ids=["hashed", "first-batch-fails"])
def test_accounting_holds_with_the_worker_held(fail_first):
    """Four submitting threads while the worker is held inside its first
    hash call: no submit waits for it (the blocks past the staging slots
    are dropped, counted), and once it is let go every block is indexed,
    dropped or counted in a failed batch."""
    idx = BlockIndexer(meta=None, device="cpu", block_size=1 << 16, batch_blocks=4,
                       queue_blocks=8)
    real = idx._pipe.hash_slot
    entered, release = threading.Event(), threading.Event()
    calls = []

    def held(slot, n):
        calls.append(n)
        if len(calls) == 1:
            entered.set()
            release.wait(30)
            if fail_first:
                raise RuntimeError("device lost")
        return real(slot, n)

    idx._pipe.hash_slot = held
    data = b"\x5a" * (1 << 16)
    per_thread, slowest = 40, []

    def submitter(t):
        for i in range(per_thread):
            t0 = time.perf_counter()
            idx.submit_raw(100 + t, i, len(data), data)
            slowest.append(time.perf_counter() - t0)

    try:
        idx.submit_raw(99, 0, len(data), data)  # the batch the worker is held in
        for i in range(1, 4):
            idx.submit_raw(99, i, len(data), data)
        assert entered.wait(30)
        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        # the worker is still held: room for two batches of 4 beside its own
        assert idx.dropped == 4 * per_thread - 8
        assert max(slowest) < 1.0, f"a submit waited {max(slowest):.2f} s"
        release.set()
        idx.flush(timeout=30)
        submitted = 4 + 4 * per_thread
        st = idx.stats()
        assert st["blocks"] + st["dropped"] + st["errors"] == submitted
        assert st["errors"] == (4 if fail_first else 0)
        assert st["blocks"] == len(idx.digests) == (8 if fail_first else 12)
    finally:
        release.set()
        idx.close()


def test_four_writers_through_the_store_index_every_block(tmp_path):
    """Four writer threads through a CachedStore whose uploads feed a
    CPU-plane indexer on a sqlite3 meta: every block uploaded has a row,
    and each row is the frozen reference's digest of the block's bytes."""
    m = new_client(f"sqlite3://{tmp_path / 'meta.db'}")
    m.init(Format(name="ix", block_size=BS >> 10), force=True)
    store = CachedStore(create_storage("mem://ix"), ChunkConfig(
        block_size=BS, compress_backend="cpu", device="cpu", cache_dirs=("memory",)))
    store.indexer = BlockIndexer(meta=m, device="cpu", block_size=BS)
    store.conf.fingerprint = store.indexer.submit
    rng = np.random.default_rng(26)
    pool = [rng.integers(0, 256, size=BS, dtype=np.uint8).tobytes() for _ in range(2)]
    want, errors = {}, []

    def writer(w):
        try:
            for f in range(3):
                sid = 1000 + 10 * w + f
                ws = store.new_writer(sid)
                for i in range(3):
                    data = (pool[(w + i) % 2] if i == 1 else
                            rng_for(w, f, i).integers(0, 256, size=BS, dtype=np.uint8).tobytes())
                    ws.write_at(data, i * BS)
                    ws.flush_to((i + 1) * BS)
                    want[(sid, i)] = frozen.jth256(data)
                ws.finish(3 * BS)
        except Exception as e:  # reported below, with the thread's name
            errors.append(repr(e))

    def rng_for(w, f, i):
        return np.random.default_rng([26, w, f, i])

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors and not any(t.is_alive() for t in threads)
        store.flush_all(120)
        st = store.indexer.stats()
        assert st["dropped"] == 0 and st["errors"] == 0 and st["blocks"] == len(want) == 36
        assert {k: d for k, (_b, d) in _rows(m).items()} == want
    finally:
        store.close()
        m.client.close()


def test_index_rows_past_one_insert_statement(tmp_path):
    """A transaction of more rows than one multi-row INSERT binds
    (`SETS_ROWS`) records every row, and a row written twice keeps its
    last value, on the sqlite3 engine as on mem://."""
    from juicefs_tpu_torch.meta.tkv_client import SETS_ROWS

    n = 2 * SETS_ROWS + 3
    rows = [(7, i, 100 + i, bytes([i % 251]) * 32) for i in range(n)]
    again = [(7, 5, 1, b"\x01" * 32), (7, 5, 2, b"\x02" * 32)]
    got = []
    for url in (f"sqlite3://{tmp_path / 'meta.db'}", "mem://"):
        m = new_client(url)
        m.init(Format(name="ix"), force=True)
        m.set_block_digests(rows + again)
        got.append(_rows(m))
        if m.client is not None and url.startswith("sqlite3"):
            m.client.close()
    want = {(sid, indx): (bsize, d) for sid, indx, bsize, d in rows + again}
    assert got[0] == got[1] == want and len(want) == n
