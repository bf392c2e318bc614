"""The port's CachedStore (juicefs_tpu_torch/chunk/cached_store.py) against
the JAX package's.

The same slices (full blocks, a ragged tail, an overwrite inside a block,
a hole) go through both stores, lz4-compressed, each over its own file://
directory. The stored object keys and bytes must be identical, each
package must read back what it wrote, and volumes cross over: the port
reads the reference's volume and the reference reads the port's. The
writeback ladder (breaker open -> staged -> breaker reset -> replay) is
held to the same contract in both packages.
"""

import importlib
import os
import time
import types

import numpy as np
import pytest

from juicefs_tpu.chunk import cached_store as ref_cs
from juicefs_tpu.object.file import FileStorage as RefFileStorage
from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig, block_key, parse_block_key
from juicefs_tpu_torch.chunk import cached_store as port_cs
from juicefs_tpu_torch.chunk.disk_cache import DiskCache
from juicefs_tpu_torch.object import MemStorage
from juicefs_tpu_torch.object.file import FileStorage as PortFileStorage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 256 << 10
PACKAGES = {
    "ref": types.SimpleNamespace(cs=ref_cs, File=RefFileStorage,
                                 res=importlib.import_module("juicefs_tpu.object.resilient")),
    "port": types.SimpleNamespace(cs=port_cs, File=PortFileStorage,
                                  res=importlib.import_module("juicefs_tpu_torch.object.resilient")),
}


def _slices():
    """{sid: (writes [(off, data)], length, expected bytes)} from a seed."""
    rng = np.random.default_rng(11)

    def rand(n):
        return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()

    out = {}
    full = rand(3 * BS + 1234)  # 3 full blocks + a ragged tail
    out[1] = ([(0, full)], len(full), full)
    a, b = rand(BS + 500), rand(3000)  # overwrite inside block 0
    want = bytearray(a)
    want[100:3100] = b
    out[2] = ([(0, a), (100, b)], len(a), bytes(want))
    c = rand(777)  # a hole: block 0 zero-filled, data inside block 1
    want = bytearray(2 * BS)
    want[BS + 5:BS + 5 + len(c)] = c
    out[3] = ([(BS + 5, c)], 2 * BS, bytes(want))
    text = b"compressible text " * (BS // 18 + 1)
    out[4] = ([(0, text[:BS])], BS, text[:BS])  # one exact block, aliased
    return out


def _store(pkg, root, **kw):
    storage = pkg.File(str(root))
    storage.create()
    conf = dict(block_size=BS, compress="lz4", cache_dirs=("memory",), cache_size=1)
    if pkg is PACKAGES["port"]:
        conf["device"] = "cpu"  # the port's default cuda plane, on the CPU
    conf.update(kw)
    return pkg.cs.CachedStore(storage, pkg.cs.ChunkConfig(**conf)), storage


def _write(store, slices):
    for sid, (writes, length, _want) in slices.items():
        w = store.new_writer(sid)
        for off, data in writes:
            w.write_at(data, off)
        w.finish(length)
    store.flush_all()


def _read_all(store, slices):
    return {sid: bytes(store.new_reader(sid, length).read(0, length))
            for sid, (_w, length, _want) in slices.items()}


def _objects(storage):
    return {o.key: storage.get(o.key) for o in storage.list_all("chunks/")}


def test_block_key_layout_is_the_reference_layout():
    for sid, indx, bsize in ((1, 0, BS), (1_234_567, 3, 17), (999, 12, 0)):
        key = port_cs.block_key(sid, indx, bsize)
        assert key == ref_cs.block_key(sid, indx, bsize)
        assert port_cs.parse_block_key(key) == ref_cs.parse_block_key(key)
    assert port_cs.parse_block_key("not/a/key") is None


def test_stores_write_identical_objects_and_volumes_cross_over(tmp_path):
    slices = _slices()
    want = {sid: s[2] for sid, s in slices.items()}
    ref_store, ref_storage = _store(PACKAGES["ref"], tmp_path / "ref")
    port_store, port_storage = _store(PACKAGES["port"], tmp_path / "port")
    cross = []
    try:
        _write(ref_store, slices)
        _write(port_store, slices)
        ref_objs, port_objs = _objects(ref_storage), _objects(port_storage)
        assert sorted(port_objs) == sorted(ref_objs)
        assert len(port_objs) == 4 + 2 + 2 + 1
        assert port_objs == ref_objs  # identical lz4 bytes under identical keys
        assert _read_all(ref_store, slices) == want
        assert _read_all(port_store, slices) == want
        # each package reads the volume the other wrote, through a cold store
        port_on_ref, _ = _store(PACKAGES["port"], tmp_path / "ref")
        ref_on_port, _ = _store(PACKAGES["ref"], tmp_path / "port")
        cross = [port_on_ref, ref_on_port]
        assert _read_all(port_on_ref, slices) == want
        assert _read_all(ref_on_port, slices) == want
        # ranged reads inside a block, across blocks, and past the end
        r = port_on_ref.new_reader(1, slices[1][1])
        assert bytes(r.read(7, 100)) == want[1][7:107]
        assert bytes(r.read(BS - 10, 2 * BS)) == want[1][BS - 10:3 * BS - 10]
        assert bytes(r.read(3 * BS + 1000, 10_000)) == want[1][3 * BS + 1000:]
    finally:
        for s in [ref_store, port_store] + cross:
            s.close()


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_writeback_ladder_stage_then_replay_on_reset(tmp_path, name):
    """Breaker open: a write stages with zero backend PUTs and reads back
    from staging; the breaker's reset replays it to the backend."""
    pkg = PACKAGES[name]
    br = pkg.res.CircuitBreaker(backend=f"ladder-{name}", threshold=0.5, min_samples=2,
                                probe_interval=999.0)  # probes off: drive by hand
    store, storage = _store(pkg, tmp_path / "blob", breaker=br)
    try:
        br.record_failure()
        br._trip_locked()
        assert store.degraded
        slices = {9: _slices()[1]}
        w = store.new_writer(9)
        w.write_at(slices[9][0][0][1], 0)
        w.finish(slices[9][1])
        with store._pending_lock:
            staged = set(store._pending_staged)
        assert staged == {pkg.cs.block_key(9, i, BS) for i in range(3)} | \
            {pkg.cs.block_key(9, 3, 1234)}
        assert _objects(storage) == {}  # nothing reached the backend
        assert _read_all(store, slices) == {9: slices[9][2]}  # served from staging
        # reset: half-open successes close the breaker and fire on_reset
        br._state = pkg.res.BreakerState.HALF_OPEN
        br.record_success()
        br.record_success()
        assert br.state == pkg.res.BreakerState.CLOSED
        store.flush_all(timeout=30)
        assert sorted(_objects(storage)) == sorted(staged)
        cold, _ = _store(pkg, tmp_path / "blob")
        try:
            assert _read_all(cold, slices) == {9: slices[9][2]}
        finally:
            cold.close()
    finally:
        store.close()


def test_chunk_config_device_reaches_the_compress_plane(tmp_path):
    """The store's one device setting reaches its compress plane and, by
    default, the IngestPipeline attached to it."""
    from juicefs_tpu_torch.chunk import ContentRefs, IngestPipeline

    store, _ = _store(PACKAGES["port"], tmp_path / "blob", compress_backend="xla",
                      device="cpu")
    try:
        assert port_cs.ChunkConfig().compress_backend == "cuda"
        assert store.compress_plane.backend == "cuda"
        assert str(store.compress_plane.device) == "cpu"
        store.ingest = IngestPipeline(store, ContentRefs(meta=None), hot_bytes=0)
        assert store.ingest.backend == "cuda"
        assert str(store.ingest._batcher.pipe.device) == "cpu"
    finally:
        store.close()


# ---------------------------------------------------------------------------
# the twins of tests/test_chunk.py's cases (reference pkg/chunk/
# cached_store_test.go: a mem object store and a temp disk cache), on the
# port's store; make_store asks for the CPU compress plane


def make_store(tmp_path=None, **kw):
    if tmp_path is not None:
        kw.setdefault("cache_dirs", (str(tmp_path / "cache"),))
    kw.setdefault("compress_backend", "cpu")
    return CachedStore(MemStorage(), ChunkConfig(block_size=1 << 16, **kw))


def test_block_key_scheme():
    assert block_key(1234567, 3, 4096) == "chunks/1/1234/1234567_3_4096"
    assert parse_block_key("chunks/1/1234/1234567_3_4096") == (1234567, 3, 4096)
    assert parse_block_key("meta/dump.json") is None
    assert parse_block_key("chunks/bad") is None


@pytest.mark.parametrize("compress", ["", "lz4", "zstd"])
def test_write_read_roundtrip(compress):
    try:
        store = make_store(compress=compress)
    except ModuleNotFoundError as e:
        pytest.skip(f"{compress} codec unavailable: {e}")
    data = os.urandom(200_000)  # ~3 blocks of 64 KiB
    w = store.new_writer(7)
    w.write_at(data, 0)
    w.finish(len(data))
    r = store.new_reader(7, len(data))
    assert r.read(0, len(data)) == data
    # ranged reads
    assert r.read(1000, 500) == data[1000:1500]
    assert r.read(65536 - 100, 200) == data[65536 - 100 : 65536 + 100]  # cross block
    assert r.read(len(data) - 10, 100) == data[-10:]  # clamped at end


def test_sparse_write_zero_fill():
    store = make_store()
    w = store.new_writer(9)
    w.write_at(b"tail", 70000)  # block 1, offset beyond start
    w.finish(70004)
    r = store.new_reader(9, 70004)
    out = r.read(0, 70004)
    assert out[:65536] == b"\x00" * 65536
    assert out[65536:70000] == b"\x00" * (70000 - 65536)
    assert out[70000:] == b"tail"


def test_flush_to_then_finish():
    store = make_store()
    w = store.new_writer(11)
    data = os.urandom(3 * 65536 + 123)
    w.write_at(data, 0)
    w.flush_to(2 * 65536)  # first two blocks upload early
    w.write_at(b"xx", 3 * 65536 + 123)
    w.finish(3 * 65536 + 125)
    r = store.new_reader(11, 3 * 65536 + 125)
    assert r.read(0, len(data)) == data
    assert r.read(3 * 65536 + 123, 2) == b"xx"


def test_remove():
    store = make_store()
    w = store.new_writer(13)
    w.write_at(b"abc", 0)
    w.finish(3)
    assert store.new_reader(13, 3).read(0, 3) == b"abc"
    store.remove(13, 3)
    from juicefs_tpu_torch.object import NotFoundError

    with pytest.raises(NotFoundError):
        store.new_reader(13, 3).read(0, 3)


def test_disk_cache_roundtrip(tmp_path):
    store = make_store(tmp_path)
    data = os.urandom(130_000)
    w = store.new_writer(17)
    w.write_at(data, 0)
    w.finish(len(data))
    r = store.new_reader(17, len(data))
    assert r.read(0, len(data)) == data  # populates disk cache
    # second read served from cache even if object deleted behind our back
    store.storage.delete(block_key(17, 0, 65536))
    assert store.new_reader(17, len(data)).read(0, 65536) == data[:65536]
    n, used = store.cache.stats()
    assert n >= 1 and used > 0


def test_disk_cache_eviction(tmp_path):
    dc = DiskCache(str(tmp_path / "small"), capacity=100_000)
    for i in range(10):
        dc.cache(f"chunks/0/0/{i}_0_20000", bytes(20000))
        time.sleep(0.01)
    n, used = dc.stats()
    assert used <= 100_000
    assert n < 10  # something evicted
    # oldest evicted first: newest key must survive
    assert dc.load("chunks/0/0/9_0_20000") is not None


def test_writeback_staging(tmp_path):
    store = make_store(tmp_path, writeback=True)
    data = os.urandom(65536 * 2)
    w = store.new_writer(19)
    w.write_at(data, 0)
    w.finish(len(data))  # returns fast; upload happens in background
    store.flush_all()
    # object eventually in storage
    assert store.storage.get(block_key(19, 0, 65536)) == data[:65536]
    r = store.new_reader(19, len(data))
    assert r.read(0, len(data)) == data


def test_writeback_read_before_upload(tmp_path):
    """Reads must see staged data even before background upload lands."""
    store = make_store(tmp_path, writeback=True)
    data = os.urandom(65536)
    w = store.new_writer(23)
    w.write_at(data, 0)
    w.finish(len(data))
    r = store.new_reader(23, len(data))
    assert r.read(100, 200) == data[100:300]
    store.flush_all()


def test_staging_recovery(tmp_path):
    """Blocks staged before a crash are re-uploaded on startup
    (reference disk_cache.go scanStaging)."""
    cache_dir = tmp_path / "cache"
    storage = MemStorage()
    # simulate a crashed writer: block staged but never uploaded
    dc = DiskCache(str(cache_dir))
    data = os.urandom(65536)
    key = block_key(29, 0, 65536)
    dc.stage(key, data)
    dc.close()  # "crash": the kernel would release the dir flock
    store = CachedStore(
        storage,
        ChunkConfig(block_size=1 << 16, cache_dirs=(str(cache_dir),), writeback=True),
    )
    store.flush_all()
    assert storage.get(key) == data


def test_staging_recovery_strips_stale_trailer(tmp_path):
    """A crash inside the old uploaded() window left a staging file with a
    checksum trailer appended in place; recovery must re-upload the bare
    payload, not payload+trailer."""
    import struct
    import zlib

    cache_dir = tmp_path / "cache"
    storage = MemStorage()
    dc = DiskCache(str(cache_dir))
    data = os.urandom(65536)
    key = block_key(37, 0, 65536)
    path = dc.stage(key, data)
    # simulate the legacy in-place trailer append, then "crash" pre-rename
    with open(path, "ab") as f:
        f.write(struct.pack("<4sI", b"JFC1", zlib.crc32(data)))
    # and a second block whose trailer append itself crashed partway
    data2 = os.urandom(65536)
    key2 = block_key(38, 0, 65536)
    path2 = dc.stage(key2, data2)
    with open(path2, "ab") as f:
        f.write(b"JFC")
    dc.close()
    store = CachedStore(
        storage,
        ChunkConfig(block_size=1 << 16, cache_dirs=(str(cache_dir),), writeback=True),
    )
    store.flush_all()
    assert storage.get(key) == data  # exactly bsize bytes, trailer stripped
    assert storage.get(key2) == data2  # partial trailer junk truncated
    r = store.new_reader(37, len(data))
    assert r.read(0, len(data)) == data
    # the raw cache entry must hold exactly the payload, not stale bytes
    assert store.cache.load(key) == data
    assert store.cache.load(key2) == data2
    store.close()


def test_uploaded_never_mutates_staging(tmp_path):
    """uploaded() copies staging→raw (tmp+rename); the staged file is
    removed only after the raw entry is complete, and is never trailered."""
    cache_dir = tmp_path / "cache"
    dc = DiskCache(str(cache_dir))
    data = os.urandom(4096)
    key = "chunks/0/0/41_0_4096"
    dc.stage(key, data)
    dc.uploaded(key, len(data))
    assert not os.path.exists(dc._stage_path(key))
    assert dc.load(key) == data  # trailered raw entry verifies
    dc.close()


def test_fill_and_check_cache():
    store = make_store()
    data = os.urandom(65536 * 2)
    w = store.new_writer(31)
    w.write_at(data, 0)
    w.finish(len(data))
    store.evict_cache(31, len(data))
    assert store.check_cache(31, len(data)) == 0
    store.fill_cache(31, len(data))
    assert store.check_cache(31, len(data)) == 2


def test_fingerprint_hook():
    seen = []
    store = CachedStore(
        MemStorage(),
        ChunkConfig(block_size=1 << 16, fingerprint=lambda k, raw: seen.append((k, len(raw)))),
    )
    data = os.urandom(100_000)
    w = store.new_writer(37)
    w.write_at(data, 0)
    w.finish(len(data))
    assert len(seen) == 2
    assert seen[0][0] == block_key(37, 0, 65536)


def test_concurrent_readers_singleflight():
    """Many readers of one uncached block trigger a single GET."""
    gets = []
    storage = MemStorage()
    orig = storage.get

    def counting_get(key, off=0, limit=-1):
        gets.append(key)
        time.sleep(0.01)
        return orig(key, off, limit)

    storage.get = counting_get
    # hedge=False: this asserts SINGLEFLIGHT dedup (exactly one GET);
    # with hedging on, the process-global mem-backend p95 — polluted
    # by any earlier fast test — can drop below the 10ms sleep and a
    # legitimate hedge duplicates the GET
    store = CachedStore(storage, ChunkConfig(block_size=1 << 16,
                                             hedge=False))
    data = os.urandom(65536)
    w = store.new_writer(41)
    w.write_at(data, 0)
    w.finish(len(data))
    store.evict_cache(41, len(data))
    gets.clear()
    import threading

    results = []
    ts = [
        threading.Thread(target=lambda: results.append(store.new_reader(41, 65536).read(0, 65536)))
        for _ in range(8)
    ]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert all(r == data for r in results)
    full_gets = [k for k in gets if k == block_key(41, 0, 65536)]
    assert len(full_gets) == 1  # deduped by singleflight


@pytest.mark.parametrize("algo", ["lz4", "zstd"])
def test_compressor_thread_safety(algo):
    """Concurrent (de)compression on ONE shared compressor: the upload pool
    and objbench share an instance across worker threads; zstandard ctx
    objects are not thread safe and used to segfault here."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from juicefs_tpu_torch.compress import new_compressor

    try:
        comp = new_compressor(algo)
    except ModuleNotFoundError as e:
        pytest.skip(f"{algo} codec unavailable: {e}")
    payloads = [os.urandom(1 << 20) + bytes(1 << 20) for _ in range(16)]

    def roundtrip(p):
        c = comp.compress(p)
        assert comp.decompress(c, len(p)) == p
        return len(c)

    with ThreadPoolExecutor(max_workers=8) as pool:
        sizes = list(pool.map(roundtrip, payloads * 4))
    assert all(0 < s < 2 << 20 for s in sizes)


def test_multi_block_read_parallel():
    """Cold-cache multi-block reads fan out over the download pool
    with per-GET latency L and B blocks, wall time must be
    far below the serial B*L (reference reader.go:160 async workers)."""
    import time as _time

    from juicefs_tpu_torch.object.mem import MemStorage

    DELAY, BS, NBLOCKS = 0.03, 1 << 18, 8

    class SlowMem(MemStorage):
        def get(self, key, off=0, size=-1):
            _time.sleep(DELAY)
            return super().get(key, off, size)

    store = CachedStore(SlowMem(), ChunkConfig(block_size=BS, max_download=8))
    data = os.urandom(BS * NBLOCKS)
    w = store.new_writer(77)
    w.write_at(data, 0)
    w.finish(len(data))
    store.evict_cache(77, len(data))  # force cold cache

    t0 = _time.perf_counter()
    got = store.new_reader(77, len(data)).read(0, len(data))
    wall = _time.perf_counter() - t0
    assert got == data
    serial = NBLOCKS * DELAY
    assert wall < serial / 2, f"read took {wall:.3f}s, serial would be {serial:.3f}s"


def test_disk_cache_checksum_detects_bitrot(tmp_path):
    """Checksum-on-read (reference disk_cache.go option): a flipped byte
    in a cached file becomes a miss + self-heal, never a corrupt read."""
    from juicefs_tpu_torch.chunk.disk_cache import DiskCache

    dc = DiskCache(str(tmp_path / "c"), checksum=True)
    data = os.urandom(50_000)
    dc.cache("chunks/0/0/1_0_50000", data)
    assert dc.load("chunks/0/0/1_0_50000") == data

    # flip one byte on disk
    path = dc._raw_path("chunks/0/0/1_0_50000")
    with open(path, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    assert dc.load("chunks/0/0/1_0_50000") is None  # detected, dropped
    assert not os.path.exists(path)  # self-healed (evicted)
    # re-cache works
    dc.cache("chunks/0/0/1_0_50000", data)
    assert dc.load("chunks/0/0/1_0_50000") == data


def test_disk_cache_dir_lock_liveness(tmp_path):
    """Two processes must not share one cache dir (reference
    disk_cache.go:157-198 lock-file): the second opener fails fast."""
    import subprocess
    import sys

    from juicefs_tpu_torch.chunk.disk_cache import DiskCache

    d = str(tmp_path / "c")
    dc = DiskCache(d)
    # same-process double-open also refuses (flock is per-fd)
    out = subprocess.run(
        [sys.executable, "-c",
         "from juicefs_tpu_torch.chunk.disk_cache import DiskCache; "
         f"DiskCache({d!r}, lock_timeout=0)"],
        capture_output=True, text=True, cwd=REPO,
    )
    assert out.returncode != 0
    assert "in use by another process" in out.stderr


def test_staged_block_readable_and_uploaded_with_checksum(tmp_path):
    from juicefs_tpu_torch.chunk.disk_cache import DiskCache

    dc = DiskCache(str(tmp_path / "c"), checksum=True)
    data = os.urandom(10_000)
    path = dc.stage("chunks/0/0/2_0_10000", data)
    assert path and open(path, "rb").read() == data  # staging stays raw
    assert dc.load("chunks/0/0/2_0_10000") == data   # served pre-upload
    dc.uploaded("chunks/0/0/2_0_10000", len(data))
    assert dc.load("chunks/0/0/2_0_10000") == data   # now in raw/ + trailer
    assert not os.path.exists(path)
