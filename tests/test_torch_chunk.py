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
import types

import numpy as np
import pytest

from juicefs_tpu.chunk import cached_store as ref_cs
from juicefs_tpu.object.file import FileStorage as RefFileStorage
from juicefs_tpu_torch.chunk import cached_store as port_cs
from juicefs_tpu_torch.object.file import FileStorage as PortFileStorage

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
