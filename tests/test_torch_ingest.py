"""The port's inline-dedup ingest (juicefs_tpu_torch/chunk/ingest.py) against
the JAX package's.

The contract drills of tests/test_ingest.py run on the port's CachedStore
and IngestPipeline, with the JAX package's sqlite meta behind the
ContentRefs seam (the port has no meta engine yet). The slice as a whole:
the write drive of __graft_entry__.py (each block its own slice, ~25%
planted duplicates, bypass off) runs once through the reference (xla
backend on CPU JAX) and once through the port (cuda backend, plain torch
path on the CPU), each on its own meta and blob directory; stats, objects,
digest rows, content refs and aliases, read-back and the port's cold
`gc --dedup` scan must agree exactly.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from juicefs_tpu.chunk import CachedStore as RefCachedStore
from juicefs_tpu.chunk import ChunkConfig as RefChunkConfig
from juicefs_tpu.chunk import ContentRefs as RefContentRefs
from juicefs_tpu.chunk import IngestPipeline as RefIngestPipeline
from juicefs_tpu.chunk.bypass import ElisionGovernor as RefGovernor
from juicefs_tpu.meta import new_client
from juicefs_tpu.meta.types import Format
from juicefs_tpu.object.file import FileStorage as RefFileStorage
from juicefs_tpu.tpu.jth256 import jth256
from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig, ContentRefs, IngestPipeline
from juicefs_tpu_torch.chunk.bypass import ElisionGovernor
from juicefs_tpu_torch.chunk.cached_store import block_key
from juicefs_tpu_torch.cmd.gc import dedup_scan
from juicefs_tpu_torch.gpu import hash_torch
from juicefs_tpu_torch.gpu.pipeline import HashPipeline, PipelineConfig
from juicefs_tpu_torch.metric import global_registry
from juicefs_tpu_torch.object.file import FileStorage
from juicefs_tpu_torch.object.resilient import BreakerOpenError

BS = 1 << 18  # 256 KiB blocks = 4 lanes


class CountingStore:
    """Backend wrapper recording PUT/DELETE/GET keys (counter-assertions)."""

    def __init__(self, inner):
        self._inner = inner
        self.put_keys: list[str] = []
        self.deleted: list[str] = []
        self.get_keys: list[str] = []
        self.lock = threading.Lock()

    def get(self, key, off=0, limit=-1):
        with self.lock:
            self.get_keys.append(key)
        return self._inner.get(key, off, limit)

    def put(self, key, data):
        with self.lock:
            self.put_keys.append(key)
        return self._inner.put(key, data)

    def delete(self, key):
        with self.lock:
            self.deleted.append(key)
        return self._inner.delete(key)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _new_meta(path):
    m = new_client(f"sqlite3://{path}")
    m.init(Format(name="t", trash_days=0, block_size=BS >> 10), force=True)
    m.load()
    return m


@pytest.fixture
def meta(tmp_path):
    return _new_meta(tmp_path / "meta.db")


@pytest.fixture
def vol(meta, tmp_path):
    storage = FileStorage(str(tmp_path / "blob"))
    storage.create()
    counting = CountingStore(storage)
    store = CachedStore(counting, ChunkConfig(block_size=BS, cache_size=1))
    refs = ContentRefs(meta)
    store.content_refs = refs
    store.ingest = IngestPipeline(store, refs, backend="cpu", batch_blocks=8,
                                  flush_timeout=0.005)
    yield meta, store, counting
    store.close()


def _write(store, sid: int, *blocks: bytes) -> None:
    w = store.new_writer(sid)
    for j, b in enumerate(blocks):
        w.write_at(b, j * BS)
    w.finish(len(blocks) * BS)


def _cold_reader(meta, counting):
    cold = CachedStore(counting, ChunkConfig(block_size=BS, cache_size=1))
    cold.content_refs = ContentRefs(meta)
    return cold


def _read_back(meta, counting, slices):
    cold = _cold_reader(meta, counting)
    try:
        for sid, blocks in slices.items():
            r = cold.new_reader(sid, len(blocks) * BS)
            for j, want in enumerate(blocks):
                assert bytes(r.read(j * BS, BS)) == want
    finally:
        cold.close()


# -- contract drills of tests/test_ingest.py ----------------------------------

def test_duplicate_puts_elided_and_readback_identical(vol):
    meta, store, counting = vol
    dup = os.urandom(BS)
    uniq = [os.urandom(BS) for _ in range(3)]
    _write(store, 1, dup, uniq[0])
    _write(store, 2, dup, uniq[1])
    _write(store, 3, uniq[2], dup)
    store.ingest.flush()
    st = store.ingest.stats()
    assert st["put_elided"] == 2 and st["errors"] == 0
    assert not {block_key(2, 0, BS), block_key(3, 1, BS)} & set(counting.put_keys)
    assert len(counting.put_keys) == 4
    _read_back(meta, counting, {1: [dup, uniq[0]], 2: [dup, uniq[1]], 3: [uniq[2], dup]})
    cold = _cold_reader(meta, counting)
    try:  # ranged read through the alias (small-read shortcut)
        assert bytes(cold.new_reader(2, 2 * BS).read(7, 100)) == dup[7:107]
    finally:
        cold.close()


def test_elided_block_reads_as_one_get_of_its_canonical(vol):
    """An elided block resolves its alias before the backend rung and loads
    its canonical through the cache under the canonical's key only: a cold
    read of two slices whose blocks alias each other's content costs one
    GET of each stored object, and a warm re-read costs no GET and no meta
    read. A ranged read GETs the block's own key first, as the reference
    does, so an elided block seen first there costs a NotFound and a GET
    of its canonical, and once resolved one GET."""
    meta, store, counting = vol
    a, b = os.urandom(BS), os.urandom(BS)
    _write(store, 1, a, b)
    _write(store, 2, b, a)  # both blocks elided
    store.ingest.flush()
    assert store.ingest.stats()["put_elided"] == 2
    stored = {block_key(1, 0, BS), block_key(1, 1, BS)}
    assert set(counting.put_keys) == stored
    counting.get_keys.clear()
    cold = CachedStore(counting, ChunkConfig(block_size=BS, cache_size=64 << 20))
    cold.content_refs = ContentRefs(meta)
    try:
        assert bytes(cold.new_reader(2, 2 * BS).read(0, 2 * BS)) == b + a
        assert bytes(cold.new_reader(1, 2 * BS).read(0, 2 * BS)) == a + b
        assert sorted(counting.get_keys) == sorted(stored)
        # the cache holds each stored object once, under its own key
        assert all(cold.cache.load(k, count_miss=False) is None
                   for k in (block_key(2, 0, BS), block_key(2, 1, BS)))
        resolves = []
        real = meta.content_resolve
        meta.content_resolve = lambda *a: resolves.append(a) or real(*a)
        try:
            assert bytes(cold.new_reader(2, 2 * BS).read(0, 2 * BS)) == b + a
        finally:
            del meta.content_resolve
        assert sorted(counting.get_keys) == sorted(stored) and resolves == []
    finally:
        cold.close()
    counting.get_keys.clear()
    cold = _cold_reader(meta, counting)
    try:
        r = cold.new_reader(2, 2 * BS)
        assert bytes(r.read(BS + 5, 100)) == a[5:105]
        assert counting.get_keys == [block_key(2, 1, BS), block_key(1, 0, BS)]
        counting.get_keys.clear()
        assert bytes(r.read(BS + 7, 100)) == a[7:107]
        assert counting.get_keys == [block_key(1, 0, BS)]
    finally:
        cold.close()


def test_store_without_the_plane_keeps_one_get_a_block(meta, tmp_path):
    """A store with no content-ref plane reads each cold block with one GET
    of its own key, and one with the plane reads a block it does not alias
    the same way."""
    storage = FileStorage(str(tmp_path / "plain"))
    storage.create()
    counting = CountingStore(storage)
    blocks = [os.urandom(BS) for _ in range(3)]
    writer = CachedStore(counting, ChunkConfig(block_size=BS, cache_size=1))
    try:
        _write(writer, 5, *blocks)
        writer.flush_all()
    finally:
        writer.close()
    keys = [block_key(5, j, BS) for j in range(3)]
    for refs in (None, ContentRefs(meta)):
        counting.get_keys.clear()
        cold = CachedStore(counting, ChunkConfig(block_size=BS, cache_size=64 << 20))
        cold.content_refs = refs
        try:
            assert bytes(cold.new_reader(5, 3 * BS).read(0, 3 * BS)) == b"".join(blocks)
        finally:
            cold.close()
        assert sorted(counting.get_keys) == keys


def test_refcounts_exact_under_concurrent_identical_writers(vol):
    """More writers than cores, a short switch interval: the ref row still
    counts exactly the alias rows, and every block reads back."""
    meta, store, counting = vol
    dup = os.urandom(BS)
    n_writers, per_writer = 2 * (os.cpu_count() or 2), 3
    barrier = threading.Barrier(n_writers)
    errs: list = []

    def writer(base_sid: int):
        try:
            barrier.wait(10)
            for k in range(per_writer):
                _write(store, base_sid + k, dup)
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(100 * (i + 1),))
               for i in range(n_writers)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not [t for t in threads if t.is_alive()] and not errs
    store.ingest.flush()
    total = n_writers * per_writer
    st = store.ingest.stats()
    assert st["put_elided"] + st["uploaded"] + st["passthrough"] == total
    refs = list(meta.scan_content_refs())
    assert len(refs) == 1
    assert refs[0][2] == len(list(meta.scan_content_aliases()))
    _read_back(meta, counting, {100 * (i + 1) + k: [dup]
                                for i in range(n_writers) for k in range(per_writer)})


def test_same_batch_duplicates_elide_via_followers(vol):
    meta, store, counting = vol
    dup, uniq = os.urandom(BS), os.urandom(BS)
    _write(store, 1, dup, dup, uniq, dup, dup)
    store.ingest.flush()
    st = store.ingest.stats()
    assert st["put_elided"] == 3 and st["uploaded"] == 2, st
    assert len(counting.put_keys) == 2
    assert sorted(r for _, _, r in meta.scan_content_refs()) == [1, 4]
    _read_back(meta, counting, {1: [dup, dup, uniq, dup, dup]})


def test_leader_put_failure_fails_the_whole_group(vol):
    meta, store, counting = vol
    orig = store._put_block

    def bad_put(key, raw, parent=None, fingerprint=True, data=None):
        raise IOError("backend exploded")

    store._put_block = bad_put
    dup = os.urandom(BS)
    w = store.new_writer(1)
    w.write_at(dup, 0)
    w.write_at(dup, BS)
    with pytest.raises(IOError, match="backend exploded"):
        w.finish(2 * BS)
    store._put_block = orig
    assert counting.put_keys == []
    assert list(meta.scan_content_refs()) == []


def test_register_failure_keeps_followers_durable(vol):
    meta, store, counting = vol

    def broken_register(entries):
        raise RuntimeError("meta down")

    store.ingest.refs.register = broken_register
    dup = os.urandom(BS)
    _write(store, 1, dup, dup)
    store.ingest.flush()
    st = store.ingest.stats()
    assert st["errors"] >= 1 and st["put_elided"] == 0
    assert set(counting.put_keys) == {block_key(1, 0, BS), block_key(1, 1, BS)}
    _read_back(meta, counting, {1: [dup, dup]})


def test_overload_degrades_to_passthrough_without_blocking(vol):
    meta, store, counting = vol
    store.ingest.close()
    store.ingest = IngestPipeline(store, ContentRefs(meta), backend="cpu",
                                  batch_blocks=4, queue_blocks=4, flush_timeout=0.005)
    real = store.ingest._batcher.pipe.hash_blocks

    def slow(blocks):
        time.sleep(0.05)
        return real(blocks)

    store.ingest._batcher.pipe.hash_blocks = slow
    datas = [os.urandom(BS) for _ in range(24)]
    t0 = time.perf_counter()
    futs = [store.ingest.submit(block_key(10 + i, 0, BS), d) for i, d in enumerate(datas)]
    assert time.perf_counter() - t0 < 0.25, "submit path blocked"
    store.ingest.flush(timeout=30)
    assert all(f.exception() is None for f in futs)
    st = store.ingest.stats()
    assert st["passthrough"] > 0 and st["blocks"] == 24, st
    _read_back(meta, counting, {10 + i: [d] for i, d in enumerate(datas)})


def test_breaker_open_mid_ingest_stages_whole_group(vol):
    meta, store, counting = vol
    orig = store._put_block
    calls = {"n": 0}

    def tripping(key, raw, parent=None, fingerprint=True, data=None):
        calls["n"] += 1
        raise BreakerOpenError("open")

    store._put_block = tripping
    dup = os.urandom(BS)
    _write(store, 1, dup, dup)
    store.ingest.flush()
    assert calls["n"] >= 1
    with store._pending_lock:
        staged = set(store._pending_staged)
    assert staged == {block_key(1, 0, BS), block_key(1, 1, BS)}
    assert list(meta.scan_content_refs()) == []
    store._put_block = orig
    store._replay_staged()
    store.flush_all(timeout=30)
    assert set(counting.put_keys) == staged


def test_follower_incref_failure_falls_back_to_upload(vol):
    meta, store, counting = vol
    real = store.ingest.refs.incref
    state = {"calls": 0}

    def flaky(entries):
        state["calls"] += 1
        if state["calls"] >= 2:  # first call = batch lookup, then fail
            raise RuntimeError("meta blinked")
        return real(entries)

    store.ingest.refs.incref = flaky
    dup = os.urandom(BS)
    _write(store, 1, dup, dup)
    store.ingest.flush()
    store.ingest.refs.incref = real
    assert state["calls"] >= 2
    assert set(counting.put_keys) == {block_key(1, 0, BS), block_key(1, 1, BS)}
    _read_back(meta, counting, {1: [dup, dup]})


def test_hash_failure_degrades_visibly(vol, caplog):
    """A hash-plane failure degrades the batch to plain uploads (writes never
    fail for want of dedup), but it is logged at WARNING and counted."""
    meta, store, counting = vol

    def broken(blocks):
        raise RuntimeError("device lost")

    store.ingest._batcher.pipe.hash_blocks = broken
    datas = [os.urandom(BS), os.urandom(BS)]
    with caplog.at_level(logging.WARNING):
        _write(store, 1, *datas)
        store.ingest.flush()
    st = store.ingest.stats()
    assert st["errors"] == 2 and st["passthrough"] == 2 and st["put_elided"] == 0
    assert "ingest batch of 2 degraded: device lost" in caplog.text
    _read_back(meta, counting, {1: datas})


@pytest.mark.parametrize("gov_cls", [RefGovernor, ElisionGovernor], ids=["ref", "port"])
def test_governor_state_machine(gov_cls):
    g = gov_cls(window=16, min_samples=8, low_water=0.1, high_water=0.3, probe_every=4)
    for _ in range(7):
        assert g.admit() == g.DEDUP
        g.record(False)
    assert not g.bypassing
    assert g.admit() == g.DEDUP
    g.record(False)
    assert g.bypassing
    verdicts = [g.admit() for _ in range(8)]
    assert verdicts.count(g.PROBE) == 2 and verdicts[0] == g.BYPASS
    assert g.DEDUP not in verdicts
    rounds = 0
    while g.bypassing and rounds < 200:
        if g.admit() == g.PROBE:
            g.record(True)
        rounds += 1
    assert not g.bypassing
    st = g.stats()
    assert st["transitions"] == 2 and st["bypassed"] >= 6 and st["probes"] >= 1


@pytest.mark.parametrize("gov_cls", [RefGovernor, ElisionGovernor], ids=["ref", "port"])
def test_governor_dup_heavy_stream_never_bypasses(gov_cls):
    g = gov_cls(window=16, min_samples=8, low_water=0.1, high_water=0.3)
    for i in range(200):
        assert g.admit() == g.DEDUP
        g.record(i % 3 == 0)
    assert not g.bypassing and g.stats()["bypassed"] == 0


def _counter(name):
    return global_registry()._metrics[name].value


def test_ingest_device_backend_shares_packed_upload(meta, tmp_path):
    """cuda backend (plain torch path on the CPU): ONE packed upload per
    hash batch feeds both the digests and the compress estimator, and
    elision stays byte-exact."""
    storage = FileStorage(str(tmp_path / "blob-cuda"))
    storage.create()
    counting = CountingStore(storage)
    store = CachedStore(counting, ChunkConfig(block_size=BS, cache_size=1, compress="lz4",
                                              compress_backend="cuda", device="cpu"))
    refs = ContentRefs(meta)
    store.content_refs = refs
    store.ingest = IngestPipeline(store, refs, backend="cuda", device="cpu", batch_blocks=4,
                                  flush_timeout=0.005, hot_bytes=0)
    try:
        hashed0 = _counter("juicefs_torch_blocks_hashed")
        h2d0 = _counter("juicefs_torch_h2d_bytes")
        dup = os.urandom(BS)
        datas = [dup, os.urandom(BS), dup, os.urandom(BS)]
        _write(store, 960, *datas)
        store.ingest.flush()
        st = store.ingest.stats()
        assert st["put_elided"] == 1 and st["errors"] == 0
        hashed = _counter("juicefs_torch_blocks_hashed") - hashed0
        assert hashed == 4
        assert _counter("juicefs_torch_h2d_bytes") - h2d0 == hashed * BS  # once
        assert store.compress_plane.estimated == 4
        assert store.compress_plane.degraded == 0
        assert hash_torch.last_kernel_mode() == "torch-cpu"
        r = store.new_reader(960, 4 * BS)
        for j, d in enumerate(datas):
            assert bytes(r.read(j * BS, BS)) == d
    finally:
        store.close()


def _device_store(meta, tmp_path, name, **ingest_kw):
    """A store whose cuda compress plane and ingest run the plain torch path
    on the CPU (the store's `device`, inherited by the IngestPipeline)."""
    storage = FileStorage(str(tmp_path / name))
    storage.create()
    counting = CountingStore(storage)
    store = CachedStore(counting, ChunkConfig(block_size=BS, cache_size=1, compress="lz4",
                                              device="cpu"))
    refs = ContentRefs(meta)
    store.content_refs = refs
    store.ingest = IngestPipeline(store, refs, flush_timeout=0.005, **ingest_kw)
    assert store.ingest._batcher.pipe.device == torch.device("cpu")
    return store, counting


def test_shared_pack_upload_failure_degrades_counted(meta, tmp_path, caplog):
    """A failed shared-pack upload degrades the batch to plain uploads (no
    second upload of host arrays), logged and counted like a hash failure."""
    store, counting = _device_store(meta, tmp_path, "blob-upload", batch_blocks=4,
                                    hot_bytes=0)
    try:
        def lost(packed):
            raise RuntimeError("upload lost")

        store.ingest._batcher.pipe.shard_packed = lost
        h2d0 = _counter("juicefs_torch_h2d_bytes")
        datas = [os.urandom(BS), os.urandom(BS)]
        with caplog.at_level(logging.WARNING):
            _write(store, 980, *datas)
            store.ingest.flush()
        st = store.ingest.stats()
        assert st["errors"] == 2 and st["passthrough"] == 2 and st["put_elided"] == 0
        assert "ingest batch of 2 degraded: upload lost" in caplog.text
        assert _counter("juicefs_torch_h2d_bytes") == h2d0
        assert store.compress_plane.estimated == 0
        assert set(counting.put_keys) == {block_key(980, 0, BS), block_key(980, 1, BS)}
        r = store.new_reader(980, 2 * BS)
        assert [bytes(r.read(j * BS, BS)) for j in range(2)] == datas
    finally:
        store.close()


def test_concurrent_writers_fill_device_batches_and_elide_exactly(meta, tmp_path):
    """Writers in parallel, each slice several blocks: blocks submitted back
    to back share a hash batch, with one upload and one estimate per batch,
    every planted duplicate elided and nothing degraded."""
    store, counting = _device_store(meta, tmp_path, "blob-conc", batch_blocks=8,
                                    bypass=False)
    blocks, expect_dups = _plan(seed=3, n_full=24)
    slices = {1 + k: blocks[i:i + 6] for k, i in enumerate(range(0, len(blocks), 6))}
    batches = global_registry()._metrics["juicefs_torch_batch_blocks"]
    try:
        hashed0 = _counter("juicefs_torch_blocks_hashed")
        h2d0 = _counter("juicefs_torch_h2d_bytes")
        n_batches0 = batches.total
        barrier = threading.Barrier(len(slices))

        def writer(sid):
            barrier.wait(10)
            data = b"".join(slices[sid])
            w = store.new_writer(sid)
            w.write_at(data, 0)
            w.finish(len(data))

        threads = [threading.Thread(target=writer, args=(sid,)) for sid in slices]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        store.ingest.flush()
        st = store.ingest.stats()
        hashed = _counter("juicefs_torch_blocks_hashed") - hashed0
        n_batches = batches.total - n_batches0
        assert st["put_elided"] == expect_dups
        assert st["uploaded"] == len(blocks) - expect_dups
        assert st["passthrough"] == st["errors"] == st["race_collapsed"] == 0
        assert len(counting.put_keys) == len(blocks) - expect_dups
        assert store.compress_plane.estimated == hashed
        assert store.compress_plane.degraded == 0
        # once each, every batch packed to its longest block: a full block
        # ships BS, and the short last block its own lanes when its batch
        # holds it alone
        tail = -(-len(blocks[-1]) // (1 << 16)) * (1 << 16)
        assert _counter("juicefs_torch_h2d_bytes") - h2d0 in (hashed * BS,
                                                              (hashed - 1) * BS + tail)
        assert hashed > n_batches  # some batch held more than one block
        for sid, chunk in slices.items():
            data = b"".join(chunk)
            assert bytes(store.new_reader(sid, len(data)).read(0, len(data))) == data
    finally:
        store.close()


def _count_calls(monkeypatch, obj, name) -> list:
    """Record each call of obj.name (still made) in the returned list."""
    calls: list = []
    orig = getattr(obj, name)

    def counted(*args, **kwargs):
        calls.append(args)
        return orig(*args, **kwargs)

    monkeypatch.setattr(obj, name, counted)
    return calls


def _estimates_seen(store, datas, sid):
    """Write `datas` as one slice and flush; returns (ingest stats, blocks
    hashed, hash batches) of the write."""
    batches = global_registry()._metrics["juicefs_torch_batch_blocks"]
    hashed0, n0 = _counter("juicefs_torch_blocks_hashed"), batches.total
    _write(store, sid, *datas)
    store.ingest.flush()
    return (store.ingest.stats(), _counter("juicefs_torch_blocks_hashed") - hashed0,
            batches.total - n0)


def test_one_device_batches_are_estimated_in_their_hash_launch(meta, tmp_path, monkeypatch):
    """A batch on one device is hashed and estimated in one call of the
    estimating hash (one launch of the row chain's estimating entry on the
    card), and the compress plane records its advisories once a batch:
    every hashed block is estimated, elision exact."""
    from juicefs_tpu_torch.gpu import sharding

    store, counting = _device_store(meta, tmp_path, "blob-in-hash", batch_blocks=4,
                                    hot_bytes=0)
    try:
        fused = _count_calls(monkeypatch, sharding, "hash_estimate_device")
        recorded = _count_calls(monkeypatch, store.compress_plane, "estimate_packed")
        dup = os.urandom(BS)
        datas = [dup, os.urandom(BS), dup, os.urandom(BS), os.urandom(BS), os.urandom(BS)]
        st, hashed, n_batches = _estimates_seen(store, datas, 990)
        comp = st["compress"]
        assert hashed == 6 and len(fused) == len(recorded) == n_batches > 0
        assert sum(len(adv) for (adv,) in recorded) == hashed
        assert all(adv.device.type == "cpu" and adv.dtype == torch.float32
                   for (adv,) in recorded)
        assert comp["estimated"] == hashed and "estimated_in_hash" not in comp
        assert comp["degraded"] == 0 and len(store.compress_plane.last_estimate) >= 1
        assert st["put_elided"] == 1 and st["passthrough"] == st["errors"] == 0
        r = store.new_reader(990, 6 * BS)
        assert [bytes(r.read(j * BS, BS)) for j in range(6)] == datas
    finally:
        store.close()


def test_mesh_split_batches_are_estimated_apart(meta, tmp_path, monkeypatch):
    """A batch split over a mesh (ShardedTensors) is estimated apart from
    the hash launches, by the mesh's histogram and entropy programs inside
    the plane's hash (`hash_async`); the compress plane records the
    advisories, sliced to the real blocks, and nothing degrades."""
    from juicefs_tpu_torch.gpu import sharding

    mesh = sharding.ShardPlane([torch.device("cpu")] * 2)
    assert mesh.mesh is not None
    store, counting = _device_store(meta, tmp_path, "blob-mesh", batch_blocks=4,
                                    hot_bytes=0, plane=mesh)
    try:
        sharded = _count_calls(monkeypatch, mesh, "_estimate_sharded")
        fused = _count_calls(monkeypatch, sharding, "hash_estimate_device")
        recorded = _count_calls(monkeypatch, store.compress_plane, "estimate_packed")
        dup = os.urandom(BS)
        datas = [dup, os.urandom(BS), dup, os.urandom(BS), os.urandom(BS)]
        st, hashed, n_batches = _estimates_seen(store, datas, 995)
        comp = st["compress"]
        assert hashed == 5 and len(sharded) == len(recorded) == n_batches > 0
        assert fused == []
        assert all(isinstance(words, sharding.ShardedTensor) for words, _c in sharded)
        assert sum(len(adv) for (adv,) in recorded) == hashed
        assert comp["estimated"] == hashed and comp["degraded"] == 0
        assert st["put_elided"] == 1 and st["passthrough"] == st["errors"] == 0
        r = store.new_reader(995, 5 * BS)
        assert [bytes(r.read(j * BS, BS)) for j in range(5)] == datas
    finally:
        store.close()


def test_failed_hash_estimate_launch_degrades_only_the_estimate(meta, tmp_path, monkeypatch,
                                                                caplog):
    """A failed launch of the estimating hash costs only the estimate:
    logged and counted once in the compress plane's `degraded`, the batch
    hashed again alone and no batch estimated from then on; no block passes
    through, every block is hashed, elided or uploaded as without it."""
    from juicefs_tpu_torch.gpu import sharding

    store, counting = _device_store(meta, tmp_path, "blob-in-hash-lost", batch_blocks=4,
                                    hot_bytes=0)
    try:
        def lost(*args, **kwargs):
            raise RuntimeError("estimating launch lost")

        monkeypatch.setattr(sharding, "hash_estimate_device", lost)
        tried = _count_calls(monkeypatch, sharding, "hash_estimate_device")
        passthrough0 = _counter("juicefs_ingest_passthrough")
        dup = os.urandom(BS)
        datas = [dup, os.urandom(BS), dup, os.urandom(BS), os.urandom(BS), os.urandom(BS)]
        with caplog.at_level(logging.WARNING):
            st, hashed, n_batches = _estimates_seen(store, datas, 998)
        comp = st["compress"]
        assert hashed == 6 and n_batches >= 2 and len(tried) == 1
        assert comp["degraded"] == 1 and not store.compress_plane.estimating
        assert comp["estimated"] == 0 and store.compress_plane.last_estimate is None
        assert st["passthrough"] == st["errors"] == 0
        assert _counter("juicefs_ingest_passthrough") == passthrough0
        assert st["put_elided"] == 1 and st["uploaded"] == 5
        assert "compress estimate degraded: estimating launch lost" in caplog.text
        r = store.new_reader(998, 6 * BS)
        assert [bytes(r.read(j * BS, BS)) for j in range(6)] == datas
    finally:
        store.close()


def test_hot_content_cache_persists_across_mounts(meta, tmp_path):
    storage = FileStorage(str(tmp_path / "blob-hot"))
    storage.create()
    store = CachedStore(CountingStore(storage), ChunkConfig(block_size=BS, cache_size=1))
    refs = ContentRefs(meta)
    store.content_refs = refs
    store.ingest = IngestPipeline(store, refs, backend="cpu", batch_blocks=4,
                                  flush_timeout=0.005)
    hot_blocks = [os.urandom(BS) for _ in range(3)]
    _write(store, 970, *hot_blocks)
    store.ingest.flush()
    assert store.ingest.stats()["hot_content"]["entries"] == 3
    store.close()  # persists the snapshot
    assert store.ingest.hot_persisted == 3
    assert len(meta.load_hot_fingerprints()) == 3

    counting2 = CountingStore(storage)
    store2 = CachedStore(counting2, ChunkConfig(block_size=BS, cache_size=1))
    refs2 = ContentRefs(meta)
    store2.content_refs = refs2
    store2.ingest = IngestPipeline(store2, refs2, backend="cpu", batch_blocks=4,
                                   flush_timeout=0.005)
    try:
        deadline = time.time() + 10
        while store2.ingest.hot_loaded < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert store2.ingest.hot_loaded == 3
        _write(store2, 971, *hot_blocks)
        store2.ingest.flush()
        st2 = store2.ingest.stats()
        assert st2["hot_content"]["hits"] == 3 and st2["put_elided"] == 3
        assert not [k for k in counting2.put_keys if "971" in k]
    finally:
        store2.close()


def test_cuda_backends_without_card_raise(meta, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    storage = FileStorage(str(tmp_path / "blob-nocard"))
    storage.create()
    store = CachedStore(storage, ChunkConfig(block_size=BS, cache_size=1))
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IngestPipeline(store, ContentRefs(meta), backend="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IngestPipeline(store, ContentRefs(meta), backend="xla")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HashPipeline(PipelineConfig(backend="cuda"))
    finally:
        store.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CachedStore(storage, ChunkConfig(block_size=BS, compress="lz4",
                                         compress_backend="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CachedStore(storage, ChunkConfig(block_size=BS, compress="lz4"))  # the default
    store = CachedStore(storage, ChunkConfig(block_size=BS, cache_size=1))
    try:  # the default ingest backend is cuda too
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IngestPipeline(store, ContentRefs(meta))
    finally:
        store.close()


# -- the slice as a whole ------------------------------------------------------

def _plan(seed: int = 7, n_full: int = 16):
    rng = np.random.default_rng(seed)
    pool = [rng.integers(0, 256, size=BS, dtype=np.uint8).tobytes() for _ in range(4)]
    blocks = [pool[int(rng.integers(0, len(pool)))] if rng.random() < 0.25
              else rng.integers(0, 256, size=BS, dtype=np.uint8).tobytes()
              for _ in range(n_full)]
    blocks.append(rng.integers(0, 256, size=BS // 3 + 5, dtype=np.uint8).tobytes())
    seen: set[int] = set()
    expect_dups = 0
    for b in blocks:
        expect_dups += id(b) in seen
        seen.add(id(b))
    return blocks, expect_dups


def _drive(root, blocks, port: bool):
    """Write every block as its own slice; returns (meta, storage, stats)."""
    meta = _new_meta(root / "meta.db")
    if port:
        storage = FileStorage(str(root / "blob"))
        conf = ChunkConfig(block_size=BS, compress="lz4", compress_backend="cuda",
                           device="cpu", cache_size=1)
        store_cls, refs_cls, ingest_kw = CachedStore, ContentRefs, {
            "backend": "cuda", "device": "cpu"}
        ingest_cls = IngestPipeline
    else:
        storage = RefFileStorage(str(root / "blob"))
        conf = RefChunkConfig(block_size=BS, compress="lz4", compress_backend="xla",
                              cache_size=1)
        store_cls, refs_cls, ingest_kw = RefCachedStore, RefContentRefs, {"backend": "xla"}
        ingest_cls = RefIngestPipeline
    storage.create()
    store = store_cls(storage, conf)
    refs = refs_cls(meta)
    store.content_refs = refs
    store.ingest = ingest_cls(store, refs, batch_blocks=8, bypass=False, **ingest_kw)
    try:
        for i, data in enumerate(blocks):
            w = store.new_writer(1 + i)
            w.write_at(data, 0)
            w.finish(len(data))
        store.ingest.flush()
        store.flush_all()
        return meta, storage, store.ingest.stats()
    finally:
        store.close()


def _refs_and_aliases(meta):
    refs = sorted(meta.scan_content_refs())
    aliases = sorted((k, d, bsize) for k, d, bsize, _ts in meta.scan_content_aliases())
    return refs, aliases


def test_slice_matches_reference(tmp_path):
    blocks, expect_dups = _plan()
    assert expect_dups >= 2
    n = len(blocks)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    rmeta, rstorage, rst = _drive(tmp_path / "ref", blocks, port=False)
    pmeta, pstorage, pst = _drive(tmp_path / "port", blocks, port=True)

    # ingest stats: identical but for the backend names (xla vs cuda)
    assert rst.pop("backend") == "xla" and pst.pop("backend") == "cuda"
    assert rst["compress"].pop("backend") == "xla"
    assert pst["compress"].pop("backend") == "cuda"
    rst["compress"].pop("lanes")
    pst["compress"].pop("lanes")
    assert pst == rst and pst["compress"]["estimated"] > 0
    assert pst["put_elided"] == expect_dups and pst["uploaded"] == n - expect_dups
    assert pst["passthrough"] == pst["errors"] == pst["race_collapsed"] == 0
    assert pst["compress"]["degraded"] == 0

    # objects, digest rows, content refs and aliases: identical
    robjs = {o.key: rstorage.get(o.key) for o in rstorage.list_all("chunks/")}
    pobjs = {o.key: pstorage.get(o.key) for o in pstorage.list_all("chunks/")}
    assert pobjs == robjs and len(pobjs) == n - expect_dups
    ingest_rows = sorted(pmeta.scan_block_digests())
    assert ingest_rows == sorted(rmeta.scan_block_digests())
    assert len(ingest_rows) == n
    assert _refs_and_aliases(pmeta) == _refs_and_aliases(rmeta)

    # read-back through a cold port store (aliases resolved) and a cold
    # reference store on the port's volume
    live = {block_key(1 + i, 0, len(b)): len(b) for i, b in enumerate(blocks)}
    cold = CachedStore(pstorage, ChunkConfig(block_size=BS, compress="lz4", cache_size=1,
                                             device="cpu"))
    cold.content_refs = ContentRefs(pmeta)
    rcold = RefCachedStore(RefFileStorage(pstorage.root),
                           RefChunkConfig(block_size=BS, compress="lz4", cache_size=1))
    rcold.content_refs = RefContentRefs(pmeta)
    try:
        for i, data in enumerate(blocks):
            assert bytes(cold.new_reader(1 + i, len(data)).read(0, len(data))) == data
            assert bytes(rcold.new_reader(1 + i, len(data)).read(0, len(data))) == data
        # the port's cold gc --dedup scan reproduces the ingest-time rows
        pmeta.delete_block_digests([(sid, indx) for sid, indx, _b, _d in ingest_rows])
        scan = dedup_scan(pmeta, cold, live, "cuda", "", BS, threads=4, device="cpu",
                          batch_blocks=8)
    finally:
        cold.close()
        rcold.close()
    assert hash_torch.last_kernel_mode() == "torch-cpu"
    assert scan["hashed_now"] == n
    assert sorted(pmeta.scan_block_digests()) == ingest_rows
    rows = {block_key(sid, indx, bsize): d for sid, indx, bsize, d in ingest_rows}
    for i in range(0, n, 3):
        assert rows[block_key(1 + i, 0, len(blocks[i]))] == jth256(blocks[i])
    assert scan["duplicate_blocks"] == expect_dups
