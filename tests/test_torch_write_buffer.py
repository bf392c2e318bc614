"""The port's write buffer bound (`ChunkConfig.buffer_size`, mount
`--buffer-size`): a writer waits in `WSlice._upload_block` while the
store's blocks handed to the upload and not yet durable would pass the
bound, so one streaming writer cannot outrun the inline-dedup stage's
queue (upstream pkg/vfs/writer.go slows its writers on `usedBufferSize`).

Each drill runs on a CPU-backend volume: the port's sqlite3 meta, a
`file://` blob directory, the `cpu` hash backend, no compression and the
elision bypass off (every block is hashed, as on the benchmark's
`--no-dedup-bypass` volume)."""

from __future__ import annotations

import argparse
import os
import random
import sys
import threading
import time

import pytest

from juicefs_tpu.tpu.jth256 import jth256
from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig, ContentRefs, IngestPipeline
from juicefs_tpu_torch.cmd import chunk_conf
from juicefs_tpu_torch.cmd import mount as mount_cmd
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.metric.trace import stage_metrics_snapshot
from juicefs_tpu_torch.object import create_storage
from juicefs_tpu_torch.object.file import FileStorage
from juicefs_tpu_torch.vfs import ROOT_INO, VFS

BS = 1 << 20  # 1 MiB blocks = 16 lanes; four writes a block, as juicefs
# bench's 1 MiB writes fill a 4 MiB block
WAIT = "chunk.write.buffer_wait"


def _waits() -> int:
    return stage_metrics_snapshot().get(WAIT, {"count": 0})["count"]


@pytest.fixture
def volume(tmp_path):
    """(meta, make_store): stores on one volume, each closed at the end."""
    meta = new_client(f"sqlite3://{tmp_path / 'meta.db'}")
    meta.init(Format(name="wb", trash_days=0, block_size=BS >> 10), force=True)
    meta.load()
    storage = FileStorage(str(tmp_path / "blob"))
    storage.create()
    stores = []

    def make(buffer_size: int, ingest: bool = True, queue_blocks: int = 4,
             hash_delay: float = 0.0, **conf) -> CachedStore:
        conf = {"block_size": BS, "cache_size": 1, "buffer_size": buffer_size, **conf}
        store = CachedStore(storage, ChunkConfig(**conf))
        stores.append(store)
        store.content_refs = ContentRefs(meta)
        if ingest:
            store.ingest = IngestPipeline(store, store.content_refs, backend="cpu",
                                          batch_blocks=4, queue_blocks=queue_blocks,
                                          flush_timeout=0.005, bypass=False)
            if hash_delay:
                real = store.ingest._batcher.pipe.hash_blocks

                def slow(blocks):
                    time.sleep(hash_delay)
                    return real(blocks)

                store.ingest._batcher.pipe.hash_blocks = slow
        return store

    yield meta, make
    for store in stores:
        store.close()
    meta.client.close()


def _blocks(n: int, seed: int, bs: int = BS) -> list[bytes]:
    rng = random.Random(seed)
    return [rng.randbytes(bs) for _ in range(n)]


def _stream(store, sid: int, blocks: list[bytes], peak: list[int]) -> None:
    """One slice written in writes of a quarter block, each completed
    block flushed at once (as `vfs/writer.py` does), then closed;
    `peak[0]` keeps the most handed-off bytes seen after any write. Only
    writers raise the account, so its every peak follows one of their
    writes."""
    w = store.new_writer(sid)
    bs = store.conf.block_size
    off = 0
    for b in blocks:
        for i in range(0, bs, bs // 4):
            off += w.write_at(b[i:i + bs // 4], off)
            w.flush_to(off)
            peak[0] = max(peak[0], store.handed_off_bytes)
    w.finish(off)


def _read_back(store, slices: dict[int, list[bytes]]) -> None:
    bs = store.conf.block_size
    cold = CachedStore(store.storage, ChunkConfig(block_size=bs, cache_size=1))
    cold.content_refs = store.content_refs
    try:
        for sid, blocks in slices.items():
            r = cold.new_reader(sid, len(blocks) * bs)
            for i, b in enumerate(blocks):
                assert bytes(r.read(i * bs, bs)) == b, (sid, i)
    finally:
        cold.close()


def test_one_streaming_writer_is_held_to_the_bound(volume):
    """A writer of one long slice against a hash stage slower than it, on
    an ingest queue of 4 blocks: with a bound of 4 blocks it waits for
    room instead of overrunning the queue, so no block is passed through,
    the handed-off bytes never pass the bound, every block reads back and
    its index row is its JTH-256."""
    meta, make = volume
    bound = 4 * BS
    store = make(bound, hash_delay=0.03)
    assert store.ingest._batcher._q.maxsize == 5  # the bound's blocks and a marker
    blocks = _blocks(24, seed=1)
    peak = [0]
    waits = _waits()
    _stream(store, 7, blocks, peak)
    store.ingest.flush(timeout=30)
    st = store.ingest.stats()
    assert st["blocks"] == 24 and st["passthrough"] == 0 and st["errors"] == 0, st
    assert 0 < peak[0] <= bound, peak  # within the bound plus one block, and tighter
    assert _waits() > waits
    assert store.handed_off_bytes == 0
    _read_back(store, {7: blocks})
    rows = {(sid, indx): d for sid, indx, _bs, d in meta.scan_block_digests()}
    assert [rows[(7, i)] for i in range(24)] == [jth256(b) for b in blocks]


def test_writers_under_the_bound_never_wait(volume):
    """Four writers whose files of 4 blocks fit the bound together (16
    blocks) hand every block off at once: no wait is recorded."""
    _meta, make = volume
    store = make(16 * BS, queue_blocks=64)
    files = {w: [_blocks(4, seed=10 * w + f) for f in range(3)] for w in range(4)}
    peak, errors = [0], []
    waits = _waits()

    def writer(w):
        try:
            for f, blocks in enumerate(files[w]):
                _stream(store, 100 + 10 * w + f, blocks, peak)
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert _waits() == waits
    assert 0 < peak[0] <= 16 * BS
    store.ingest.flush(timeout=30)
    assert store.ingest.stats()["passthrough"] == 0
    _read_back(store, {100 + 10 * w + f: files[w][f] for w in range(4) for f in range(3)})


def test_no_bound_keeps_the_old_behaviour(volume):
    """buffer_size 0: the writer never waits, so against the slow stage
    its blocks overrun the 4-block queue and pass through (the fault the
    bound cures), while the account still counts each hand-off."""
    _meta, make = volume
    store = make(0, hash_delay=0.03)
    assert store.ingest._batcher._q.maxsize == 4
    blocks = _blocks(24, seed=2)
    peak = [0]
    waits = _waits()
    _stream(store, 8, blocks, peak)
    store.ingest.flush(timeout=30)
    assert _waits() == waits
    assert store.ingest.stats()["passthrough"] > 0
    assert peak[0] > 4 * BS and store.handed_off_bytes == 0
    _read_back(store, {8: blocks})


def test_writeback_blocks_are_never_counted(volume, tmp_path):
    """Staged writeback blocks ack from disk at once: the account never
    sees them, so a bound of one block holds back nothing."""
    _meta, make = volume
    store = make(BS, ingest=False, writeback=True,
                 cache_dirs=(str(tmp_path / "cache"),))
    blocks = _blocks(8, seed=3)
    peak = [0]
    waits = _waits()
    _stream(store, 9, blocks, peak)
    assert peak[0] == 0 and _waits() == waits
    store.flush_all(timeout=30)
    _read_back(store, {9: blocks})


def test_plain_uploads_are_held_to_the_bound(volume):
    """With no ingest stage the bound holds the FOREGROUND upload pool's
    hand-offs: a writer against slow PUTs waits and never passes it."""
    _meta, make = volume
    store = make(2 * BS, ingest=False)
    real = store._put_or_stage

    def slow(key, raw, parent=None):
        time.sleep(0.02)
        return real(key, raw, parent)

    store._put_or_stage = slow
    blocks = _blocks(12, seed=4)
    peak = [0]
    waits = _waits()
    _stream(store, 11, blocks, peak)
    assert 0 < peak[0] <= 2 * BS and _waits() > waits
    _read_back(store, {11: blocks})


def test_the_account_under_many_writers(volume):
    """Sixteen writers of 64 KiB blocks under a bound of 8 blocks, the
    interpreter switching threads every microsecond: the account never
    passes the bound and returns to 0, so no update of it is lost."""
    _meta, make = volume
    bs = 64 << 10
    store = make(8 * bs, ingest=False, block_size=bs)
    files = {w: [_blocks(4, seed=1000 + 10 * w + f, bs=bs) for f in range(4)]
             for w in range(16)}
    peak, errors = [0], []

    def writer(w):
        try:
            for f, blocks in enumerate(files[w]):
                _stream(store, 1000 + 10 * w + f, blocks, peak)
        except BaseException as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer, args=(w,)) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert 0 < peak[0] <= 8 * bs and store.handed_off_bytes == 0
    _read_back(store, {1000 + 10 * w + f: files[w][f] for w in range(16) for f in range(4)})


@pytest.mark.parametrize("bound, queue_blocks, want", [
    (0, 64, 64),  # no bound: the queue as given
    (0, 4, 4),
    (300 << 20, 64, 301),  # upstream's default: 300 blocks and a marker
    (1 << 30, 64, 1025),  # 1 GiB of 1 MiB blocks and a marker
    (8 * BS, 64, 64),  # a small bound never shrinks the queue
    (4 * BS + 1, 4, 6),  # a part block counts whole
])
def test_ingest_queue_follows_the_bound(volume, bound, queue_blocks, want):
    _meta, make = volume
    store = make(bound, queue_blocks=queue_blocks)
    assert store.ingest._batcher._q.maxsize == want


def _mount_args(*flags):
    p = argparse.ArgumentParser()
    mount_cmd.add_parser(p.add_subparsers())
    return p.parse_args(["mount", "sqlite3:///x.db", "/mp", *flags])


@pytest.mark.parametrize("flags, want", [
    ((), 300 << 20),  # upstream's default
    (("--buffer-size", "8"), 8 << 20),
    (("--buffer-size", "0"), 0),
])
def test_mount_buffer_size_reaches_the_chunk_config(flags, want):
    args = _mount_args(*flags)
    assert chunk_conf(Format(name="v", block_size=4096), args).buffer_size == want


def test_used_buffer_gauge_counts_handed_off_bytes(tmp_path):
    """`juicefs_used_buffer_size_bytes` (DataWriter.buffered_bytes) counts
    the blocks a writer still fills and those handed to an upload that has
    not finished, as upstream's usedBufferSize counts every page not yet
    uploaded; both drain to 0 once the file is flushed."""
    gate = threading.Event()
    inner = create_storage("mem://")

    class Gated:
        def put(self, key, data):
            gate.wait(30)
            return inner.put(key, data)

        def __getattr__(self, name):
            return getattr(inner, name)

    m = new_client("mem://")
    m.init(Format(name="g", storage="mem", block_size=BS >> 10), force=False)
    m.new_session()
    store = CachedStore(Gated(), ChunkConfig(block_size=BS, buffer_size=64 * BS))
    v = VFS(m, store)
    ctx = Context(uid=0, gid=0, pid=1)
    try:
        st, ino, _attr, fh = v.create(ctx, ROOT_INO, b"f", 0o644)
        assert st == 0
        assert v.write(ctx, ino, fh, 0, os.urandom(2 * BS + BS // 2)) == 0
        # two full blocks handed off behind the gate, half a block held
        assert store.handed_off_bytes == 2 * BS
        assert v.writer.buffered_bytes() == 2 * BS + BS // 2
        gate.set()
        assert v.flush(ctx, ino, fh) == 0
        assert v.writer.buffered_bytes() == 0 and store.handed_off_bytes == 0
        assert v.release(ctx, ino, fh) == 0
    finally:
        gate.set()
        v.close()
        store.close()
