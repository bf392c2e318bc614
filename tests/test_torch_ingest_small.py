"""The inline-dedup ingest stage on blocks shorter than the block size:
each hash batch is packed to its own longest block (`IngestPipeline._process`),
on the device path on the CPU (backend "cuda", device "cpu").

Padding never enters a digest or an advisory, so the batch-sized pack
gives the bits the block size's 64-lane pad gives and the spec's `jth256`;
a batch that holds a full block still packs 64 lanes; a lane-split mesh
still splits the short pack; and a VFS writer of small files over an
inline-dedup volume elides its copies, reads every file back, and shows
its per-file stages (`vfs.create`, `vfs.flush`, `chunk.write.finish`) in
the stage rollup.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig, ContentRefs, IngestPipeline
from juicefs_tpu_torch.chunk.cached_store import block_key
from juicefs_tpu_torch.gpu import sharding
from juicefs_tpu_torch.gpu.hash_torch import hash_estimate_device
from juicefs_tpu_torch.gpu.jth256 import LANE_BYTES, jth256, pack_blocks
from juicefs_tpu_torch.meta import new_client
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.meta.types import ROOT_INODE, Format
from juicefs_tpu_torch.metric.trace import stage_metrics_snapshot
from juicefs_tpu_torch.object import create_storage
from juicefs_tpu_torch.vfs import VFS

BS = 4 << 20  # the format's block size: a pad of 64 lanes
KIB = 1024
SMALL = 128 * KIB  # juicefs bench's small file: 2 lanes
CTX = Context(uid=0, gid=0, gids=(0,), pid=1)


@pytest.fixture
def meta(tmp_path):
    m = new_client(f"sqlite3://{tmp_path}/meta.db")
    m.init(Format(name="small", storage="mem", block_size=BS // KIB, compression="lz4",
                  trash_days=0), force=True)
    yield m
    m.client.close()


def _store(meta, plane=None, batch_blocks=32, flush_timeout=0.005):
    """An inline-dedup store on the plain torch path: its compress plane on
    the CPU, its ingest stage on `plane` (a one-device CPU plane if None)."""
    store = CachedStore(create_storage("mem://"), ChunkConfig(
        block_size=BS, cache_size=1, compress="lz4", device="cpu"))
    refs = ContentRefs(meta)
    store.content_refs = refs
    store.ingest = IngestPipeline(store, refs, backend="cuda", bypass=False,
                                  batch_blocks=batch_blocks, flush_timeout=flush_timeout,
                                  hot_bytes=0, **({"plane": plane} if plane is not None
                                                  else {"device": "cpu"}))
    return store, refs


def _record(monkeypatch, obj, name):
    """Each call's result of `obj.name`, recorded as it passes."""
    seen = []
    orig = getattr(obj, name)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        seen.append((a, out))
        return out

    monkeypatch.setattr(obj, name, wrapped)
    return seen


def _ingest_one_batch(store, blocks, sid=100):
    """Every block of `blocks` its own slice, submitted to the ingest stage
    at once; with a batch of exactly len(blocks) and a long flush timeout
    they are hashed as one batch."""
    futs = [store.ingest.submit(block_key(sid + i, 0, len(b)), b) for i, b in enumerate(blocks)]
    store.ingest.flush()
    assert all(f.exception() is None for f in futs)


def _tensors(packed):
    words, counts, lengths = packed
    return (torch.from_numpy(np.ascontiguousarray(words).view(np.int32)),
            torch.from_numpy(counts.astype(np.int64)), torch.from_numpy(lengths.astype(np.int64)))


@pytest.mark.parametrize("sizes, lanes", [
    ([SMALL], 2),
    ([SMALL, SMALL], 2),
    ([777], 1),
    ([70000, 3 * LANE_BYTES + 1], 4),
    ([SMALL, BS, 70000, 777], 64),
    ([BS, BS], 64),
])
def test_a_batch_packs_to_its_longest_block(meta, monkeypatch, sizes, lanes):
    store, _refs = _store(meta, batch_blocks=len(sizes), flush_timeout=30.0)
    try:
        pipe = store.ingest._batcher.pipe
        packs = _record(monkeypatch, pipe, "shard_packed")
        advised = _record(monkeypatch, store.compress_plane, "estimate_packed")
        blocks = [os.urandom(n) for n in sizes]
        _ingest_one_batch(store, blocks)
        assert len(packs) == 1
        (host,), _placed = packs[0]
        assert host[0].shape == (len(sizes), lanes, 128, 128)
        assert host[0].nbytes == len(sizes) * lanes * LANE_BYTES
        # the batch-sized pack's digests and advisories are the 64-lane
        # pad's, bit for bit, and the digests are the spec's
        digests, advisories = hash_estimate_device(*_tensors(host))
        full_d, full_a = hash_estimate_device(*_tensors(pack_blocks(blocks, pad_lanes=64)))
        assert torch.equal(digests, full_d) and torch.equal(advisories, full_a)
        (recorded,), _ = advised[0]
        assert torch.equal(recorded, full_a)
        rows = {sid: d for sid, _i, _b, d in meta.scan_block_digests()}
        assert [rows[100 + i] for i in range(len(blocks))] == [jth256(b) for b in blocks]
    finally:
        store.close()


def test_a_block_longer_than_the_block_size_still_raises():
    with pytest.raises(ValueError, match="pad_lanes=64"):
        pack_blocks([os.urandom(BS + 1)], pad_lanes=64)


@pytest.mark.parametrize("n_devices, lane_split", [(2, False), (4, True)])
@pytest.mark.parametrize("sizes, need", [([SMALL], 2), ([777, SMALL], 2), ([777], 1)])
def test_a_mesh_still_splits_the_short_pack(meta, monkeypatch, n_devices, lane_split, sizes,
                                            need):
    """On a (data x lane) mesh the pack is rounded up to the lane axis's
    extent, so a short batch is split over the mesh and not degraded to
    one device: 2 x 1 splits the blocks, 2 x 2 the lanes too (a batch of
    one 1-lane block packs 2 lanes there)."""
    plane = sharding.ShardPlane([torch.device("cpu")] * n_devices)
    assert plane.mesh is not None and (plane.n_lane == 2) == lane_split
    store, _refs = _store(meta, plane=plane, batch_blocks=len(sizes), flush_timeout=30.0)
    try:
        packs = _record(monkeypatch, store.ingest._batcher.pipe, "shard_packed")
        degraded0 = sharding._DEGRADED.value
        blocks = [os.urandom(n) for n in sizes]
        _ingest_one_batch(store, blocks)
        (host,), placed = packs[0]
        lanes = -(-need // plane.n_lane) * plane.n_lane
        assert host[0].shape[1] == lanes
        words = placed[0]
        assert isinstance(words, sharding.ShardedTensor)
        assert [[p.shape[1] for p in row] for row in words.shards] == \
            [[lanes // plane.n_lane] * plane.n_lane] * plane.n_data
        assert sharding._DEGRADED.value == degraded0
        rows = {sid: d for sid, _i, _b, d in meta.scan_block_digests()}
        assert [rows[100 + i] for i in range(len(blocks))] == [jth256(b) for b in blocks]
    finally:
        store.close()


def test_small_files_through_the_vfs(meta, monkeypatch):
    """juicefs bench's small-file phase at a small count: four pool files,
    then 20 files of which every fourth copies a pool file. Each file is
    created, written, flushed and released; each close hashes one 2-lane
    block. Copies are elided, uniques uploaded, every file reads back, its
    index row is the spec's digest, and the stage rollup counts each
    file's create, flush and block wait."""
    store, refs = _store(meta)
    vfs = VFS(meta, store)
    try:
        packs = _record(monkeypatch, store.ingest._batcher.pipe, "shard_packed")
        err, dir_ino, _attr = vfs.mkdir(CTX, ROOT_INODE, b"bench", 0o755)
        assert err == 0
        pool = [os.urandom(SMALL) for _ in range(4)]
        contents = pool + [pool[i // 4 % 4] if i % 4 == 3 else os.urandom(SMALL)
                           for i in range(20)]
        names = [b"pool-%d" % j for j in range(4)] + [b"f%d" % i for i in range(20)]
        stages = ("vfs.create", "vfs.flush", "chunk.write.finish")
        zero = {"count": 0}
        before = {s: stage_metrics_snapshot().get(s, zero)["count"] for s in stages}
        inos = []
        for name, body in zip(names, contents):
            err, ino, _attr, fh = vfs.create(CTX, dir_ino, name, 0o644, 0, os.O_WRONLY)
            assert err == 0
            assert vfs.write(CTX, ino, fh, 0, body) == 0
            assert vfs.flush(CTX, ino, fh) == 0
            assert vfs.release(CTX, ino, fh) == 0
            inos.append(ino)
        after = stage_metrics_snapshot()
        assert {s: after[s]["count"] - before[s] for s in stages} == \
            {s: len(names) for s in stages}
        assert all(after[s]["sum_seconds"] > 0 for s in stages)
        store.ingest.flush()  # the index rows are written behind the commits
        st = store.ingest.stats()
        assert st["put_elided"] == 5 and st["uploaded"] == 19
        assert st["passthrough"] == st["errors"] == st["race_collapsed"] == 0
        assert {h[0].shape for (h,), _p in packs} == {(1, 2, 128, 128)}
        rows = {(sid, indx): d for sid, indx, _b, d in meta.scan_block_digests()}
        pool_keys = []
        for i, (ino, body) in enumerate(zip(inos, contents)):
            err, attr = meta.getattr(CTX, ino)
            assert err == 0 and attr.length == SMALL
            err, slices = meta.read_chunk(ino, 0)
            assert err == 0 and len(slices) == 1 and slices[0].len == SMALL
            key = block_key(slices[0].id, 0, SMALL)
            assert rows[(slices[0].id, 0)] == jth256(body)
            canonical = refs.resolve(key)
            if i < 4:
                pool_keys.append(key)
                assert canonical is None
            elif (i - 4) % 4 == 3:
                assert canonical == pool_keys[(i - 4) // 4 % 4]
            else:
                assert canonical is None
            err, _attr, fh = vfs.open(CTX, ino, os.O_RDONLY)
            assert err == 0
            err, got = vfs.read(CTX, ino, fh, 0, SMALL)
            assert err == 0 and bytes(got) == body
            assert vfs.release(CTX, ino, fh) == 0
    finally:
        vfs.close()
        store.close()
