"""The port's sharding plane (juicefs_tpu_torch/gpu/sharding.py) against the
JAX package's (juicefs_tpu/tpu/sharding.py).

The drills of tests/test_tpu_shard.py, case for case, run on
`ShardPlane([cpu] * n)`: one device may be listed several times, so the
reference's forced-host subprocesses become in-process parametrised
cases. Then the same seeded inputs go through both packages' planes
(the reference over `jax.devices()[:n]`, which conftest makes 8 host
devices): snapshots, digests and dedup verdicts must be identical, the
`sharded_scan_many` checksums equal, and the estimator's advisories
bit-identical to the port's one-device estimate and within 1e-5 of the
reference's (XLA's float32 log2 may differ from torch's in the last ulp,
as tests/test_torch_compress.py records). Last, the kernel's lane offset
(g++ twin and plain torch) against the JAX chain, the multichip run on a
2 x 2 CPU mesh, and `gc --dedup` reporting the plane it ran on.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from juicefs_tpu.tpu import compress_batch as ref_cb  # noqa: E402
from juicefs_tpu.tpu import hash_jax as hj  # noqa: E402
from juicefs_tpu.tpu import sharding as ref_sharding  # noqa: E402
from juicefs_tpu.tpu.jth256 import pack_blocks  # noqa: E402
from juicefs_tpu_torch import cmd  # noqa: E402
from juicefs_tpu_torch.compress import LZ4Compressor  # noqa: E402
from juicefs_tpu_torch.gpu import compress_batch as cb  # noqa: E402
from juicefs_tpu_torch.gpu import hash_torch as ht  # noqa: E402
from juicefs_tpu_torch.gpu import kernels, sharding  # noqa: E402
from juicefs_tpu_torch.gpu.dedup import dedup_digests  # noqa: E402
from juicefs_tpu_torch.gpu.jth256 import digests_to_bytes, jth256  # noqa: E402
from juicefs_tpu_torch.gpu.pipeline import HashPipeline, PipelineConfig  # noqa: E402
from juicefs_tpu_torch.meta import CHUNK_SIZE, Slice  # noqa: E402
from juicefs_tpu_torch.meta.context import Context  # noqa: E402
from juicefs_tpu_torch.qos import Scheduler  # noqa: E402

CPU = torch.device("cpu")
BB = 1 << 22  # an exactly-4-MiB block: 64 lanes


def cpus(n: int) -> list:
    return [CPU] * n


def _blocks(rng, block_bytes=1 << 20):
    """The acceptance shape suite: ragged sizes, 1-byte, a cross-batch
    duplicate, and an exactly-full block."""
    return [
        rng.integers(0, 256, size=block_bytes, dtype=np.uint8).tobytes(),
        b"\x07",
        rng.integers(0, 256, size=100_000, dtype=np.uint8).tobytes(),
        b"\x07",
        rng.integers(0, 256, size=block_bytes - 1, dtype=np.uint8).tobytes(),
    ]


def _shapes(seed: int):
    """Per batch: ragged blocks around a full 4 MiB one, empty, single."""
    rng = np.random.default_rng(seed)
    return [_blocks(rng, BB), [], [b"x"]]


def _tensors(packed):
    words, counts, lengths = packed
    return (torch.from_numpy(words.view(np.int32)), torch.from_numpy(counts.astype(np.int64)),
            torch.from_numpy(lengths.astype(np.int64)))


@pytest.fixture
def plane():
    return sharding.ShardPlane(cpus(8))


def _advised(plane, packed):
    """The advisories of the plane's advised hash (`hash_async` inside
    `advised()`) of a placed pack, sliced to its real blocks."""
    with plane.advised() as advice:
        plane.hash_async(*packed)
    (pred,) = advice
    return pred[: packed.batch]


# -- the reference's drills, on the port's plane -------------------------------

def test_plane_mesh_over_all_devices(plane):
    snap = plane.snapshot()
    assert snap["devices"] == 8
    assert snap["mesh"] == {"data": 4, "lane": 2}
    assert not snap["degraded"]


def test_put_packed_counts_one_sharded_transfer_and_pads(plane):
    rng = np.random.default_rng(1)
    packed = pack_blocks(_blocks(rng), pad_lanes=16)
    before = sharding._H2D_BATCHES.value
    sp = plane.put_packed(*packed)
    # ONE placement per batch, counter-asserted
    assert sharding._H2D_BATCHES.value == before + 1
    assert isinstance(sp, sharding.ShardedPack)
    assert sp.batch == 5
    # 5 ragged blocks pad up to the data-axis extent (4 -> 8 rows)
    assert sp[0].shape[0] == 8 and sp[1].shape[0] == 8
    # placed over the mesh: 4 data rows x 2 lane halves of 8 lanes
    assert isinstance(sp[0], sharding.ShardedTensor)
    assert [[tuple(s.shape[:2]) for s in row] for row in sp[0].shards] == [[(2, 8)] * 2] * 4
    # pad rows repeat the last block
    words = sp[0].gather(CPU)
    assert torch.equal(words[5:], words[4:5].expand(3, *words.shape[1:]))
    # hashing the placed pack does NOT place again
    mid = sharding._H2D_BATCHES.value
    dig = plane.hash_packed(*sp, n=sp.batch)
    assert sharding._H2D_BATCHES.value == mid
    assert dig.shape == (5, 8)


def test_hash_byte_identity_every_shape(plane):
    rng = np.random.default_rng(2)
    blocks = _blocks(rng)
    refs = [jth256(b) for b in blocks]
    got = digests_to_bytes(plane.hash_packed(*pack_blocks(blocks, pad_lanes=16)))
    assert got == refs
    # empty batch: no device work, shape (0, 8)
    assert plane.hash_packed(*pack_blocks([], pad_lanes=16)).shape == (0, 8)
    # single 1-byte block (padded to the data axis: 4 rows), identical
    one = digests_to_bytes(plane.hash_packed(*pack_blocks([b"x"], pad_lanes=16)))
    assert one == [jth256(b"x")]


def test_scan_packed_dedup_matches_reference(plane):
    rng = np.random.default_rng(3)
    blocks = _blocks(rng)
    refs = [jth256(b) for b in blocks]
    rdup, rfirst = dedup_digests(refs)
    d, dup, first = plane.scan_packed(*pack_blocks(blocks, pad_lanes=16))
    assert digests_to_bytes(d) == refs
    assert list(dup) == list(rdup)
    assert list(first) == list(rfirst)


def test_estimator_advisory_identity_sharded_vs_single(plane):
    rng = np.random.default_rng(4)
    packed = pack_blocks(_blocks(rng), pad_lanes=16)
    words, counts, _ = _tensors(packed)
    single = cb.estimate(words, counts)
    sp = plane.put_packed(*packed)
    pred = _advised(plane, sp)
    # the integer-valued histogram sum is exact, so the advisory is not
    # merely close: it is bit-identical to the one-device estimate
    assert torch.equal(single, pred)
    hist = sum(cb.byte_histogram(w, sp[1].shards[0][li], li * w.shape[1])
               for li, w in enumerate(sp[0].shards[0]))
    assert torch.equal(hist, cb.byte_histogram(words[:2], counts[:2]))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_compress_plane_estimates_a_pack_another_plane_split(n):
    """The store's compress plane holds no plane while ingest may split its
    shared pack over a mesh: the pipeline's advised hash estimates the pack
    where it lies, every real block is estimated, the padding is sliced
    off, and the compress plane records the one-device advisories."""
    rng = np.random.default_rng(40 + n)
    blocks = _blocks(rng)[:5]  # 5 blocks: padded over every data axis here
    packed = pack_blocks(blocks, pad_lanes=16)
    words, counts, _ = _tensors(packed)
    want = [round(float(p), 4) for p in cb.estimate(words, counts)]
    pipe = HashPipeline(PipelineConfig(backend="cuda", pad_lanes=16),
                        plane=sharding.ShardPlane(cpus(n)))
    sp = pipe.shard_packed(packed)
    assert isinstance(sp[0], sharding.ShardedTensor) and sp[0].shape[0] > sp.batch == 5
    digests, adv = pipe.hash_packed(*sp, n=sp.batch, advise=True)
    assert digests == [jth256(b) for b in blocks] and tuple(adv.shape) == (5,)
    sched = Scheduler()
    comp = cb.CompressPlane(LZ4Compressor(), scheduler=sched, device="cpu")
    try:
        assert comp.device == CPU
        comp.estimate_packed(adv)
        assert comp.degraded == 0 and comp.estimated == 5
        assert comp.last_estimate == want
    finally:
        comp.close()
        sched.close()


def test_shard_gauge_describes_the_process_plane(monkeypatch):
    """Only the process plane sets juicefs_torch_shard_devices: the
    one-device planes built for an explicit device leave it alone."""
    monkeypatch.setattr(sharding, "_plane", None)
    monkeypatch.setattr(sharding, "local_devices", lambda: cpus(4))
    monkeypatch.setattr(sharding._DEVICES, "value", 0.0)
    assert sharding.get_plane().snapshot()["devices"] == 4
    assert sharding._DEVICES.value == 4
    sharding.ShardPlane([CPU])
    sharding.plane_for("cpu")
    sharding.ShardPlane(cpus(8))
    assert sharding._DEVICES.value == 4
    assert sharding.get_plane() is sharding.get_plane()


def test_pipeline_stream_routes_through_plane(plane):
    rng = np.random.default_rng(5)
    blocks = _blocks(rng) + [b"tail"]
    pipe = HashPipeline(PipelineConfig(backend="cuda", batch_blocks=4, pad_lanes=16),
                        plane=plane)
    assert pipe.device_backend and pipe.plane is plane
    before = sharding._H2D_BATCHES.value
    assert pipe.hash_blocks(blocks) == [jth256(b) for b in blocks]
    # 6 blocks at batch_blocks=4 -> exactly 2 placements
    assert sharding._H2D_BATCHES.value == before + 2


def test_shard_packed_then_hash_packed_slices_to_n(plane):
    rng = np.random.default_rng(6)
    blocks = _blocks(rng)
    pipe = HashPipeline(PipelineConfig(backend="cuda", pad_lanes=16), plane=plane)
    packed = pipe.shard_packed(pack_blocks(blocks, pad_lanes=16))
    assert isinstance(packed, sharding.ShardedPack)
    assert pipe.hash_packed(*packed, n=len(blocks)) == [jth256(b) for b in blocks]


@pytest.mark.parametrize("n", [3, 5])
def test_degrade_odd_device_counts_counted_never_error(n):
    rng = np.random.default_rng(7)
    blocks = _blocks(rng)
    before = sharding._DEGRADED.value
    p = sharding.ShardPlane(cpus(n))
    assert p.mesh is None
    assert sharding._DEGRADED.value == before + 1
    assert p.snapshot()["degraded"]
    assert "odd" in p.snapshot()["reason"]
    got = digests_to_bytes(p.hash_packed(*pack_blocks(blocks, pad_lanes=16)))
    assert got == [jth256(b) for b in blocks]


def test_degrade_mesh_init_failure_counted_never_error(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no mesh for you")

    monkeypatch.setattr(sharding, "make_mesh", boom)
    before = sharding._DEGRADED.value
    p = sharding.ShardPlane(cpus(8))
    assert p.mesh is None
    assert sharding._DEGRADED.value == before + 1
    assert "mesh init failed" in p.snapshot()["reason"]
    got = digests_to_bytes(p.hash_packed(*pack_blocks([b"a", b"bb"], pad_lanes=4)))
    assert got == [jth256(b"a"), jth256(b"bb")]


def test_indivisible_lane_batch_degrades_counted(plane):
    # pad_lanes=1 (64 KiB blocks) cannot split across lane=2: the plane
    # takes the one-device placement for THAT batch, counts it, and stays
    # byte-identical
    blocks = [b"a" * 100, b"z" * 65536]
    before = sharding._DEGRADED.value
    sp = plane.put_packed(*pack_blocks(blocks, pad_lanes=1))
    assert sharding._DEGRADED.value == before + 1
    assert isinstance(sp[0], torch.Tensor)
    assert digests_to_bytes(plane.hash_packed(*sp, n=sp.batch)) == [jth256(b) for b in blocks]


def test_single_device_plane_degrades_uncounted():
    # one device is the natural rung, not a fault: no degrade count
    before = sharding._DEGRADED.value
    p = sharding.ShardPlane(cpus(1))
    assert p.mesh is None
    assert sharding._DEGRADED.value == before
    assert p.snapshot() == {"devices": 1, "mesh": None, "degraded": True,
                            "reason": "single device"}


def test_dispatch_boundary_exact_batch_count(plane):
    # 9 blocks at batch_blocks=4 dispatch as 4+4+1: a boundary mutant
    # (dispatch past instead of at the batch size) ships 5+4 and the
    # placement counter catches it
    blocks = [b"block-%d" % i for i in range(9)]
    pipe = HashPipeline(PipelineConfig(backend="cuda", batch_blocks=4, pad_lanes=16),
                        plane=plane)
    before = sharding._H2D_BATCHES.value
    assert pipe.hash_blocks(blocks) == [jth256(b) for b in blocks]
    assert sharding._H2D_BATCHES.value == before + 3


def test_mesh_policy_exact_shapes():
    # the lane-axis policy term by term: n=4 exercises the >= boundary
    # (a `> 4` mutant drops to lane=1), n=6 the conjunction (an `or`
    # mutant splits 3x2)
    assert sharding.ShardPlane(cpus(4)).snapshot()["mesh"] == {"data": 2, "lane": 2}
    assert sharding.ShardPlane(cpus(6)).snapshot()["mesh"] == {"data": 6, "lane": 1}
    assert sharding.ShardPlane(cpus(2)).snapshot()["mesh"] == {"data": 2, "lane": 1}
    # make_mesh's n_data default derives by floor-division of the count
    assert sharding.make_mesh(n_lane=2, devices=cpus(8)).shape == {"data": 4, "lane": 2}
    with pytest.raises(ValueError):
        sharding.make_mesh(n_data=3, n_lane=2, devices=cpus(4))


def test_empty_batch_put_is_not_a_degrade(plane):
    before = sharding._DEGRADED.value
    sp = plane.put_packed(*pack_blocks([], pad_lanes=16))
    assert sp.batch == 0
    assert sharding._DEGRADED.value == before


def test_preplaced_indivisible_batch_takes_single_path(plane):
    # tensors placed OUTSIDE put_packed (so unpadded: B=5 does not divide
    # data=4) take the one-device program where they lie
    rng = np.random.default_rng(8)
    blocks = _blocks(rng)
    refs = [jth256(b) for b in blocks]
    packed = _tensors(pack_blocks(blocks, pad_lanes=16))
    before = sharding._H2D_BATCHES.value
    assert digests_to_bytes(plane.hash_packed(*packed)) == refs
    d, dup, first = plane.scan_packed(*packed)
    rdup, rfirst = dedup_digests(refs)
    assert digests_to_bytes(d) == refs
    assert list(dup) == list(rdup) and list(first) == list(rfirst)
    assert sharding._H2D_BATCHES.value == before


def test_no_card_raises_without_building_a_plane(monkeypatch):
    # devices=None is every local card: none here, so the plane raises
    # (never a silent CPU plane), and the process plane stays unbuilt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sharding, "_plane", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.get_plane()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.ShardPlane()
    assert sharding._plane is None


# the reference's forced-host subprocess tier, in process: every device
# count over the shape suite (ragged / empty / 1-byte / exactly-4MiB)

@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_device_count_byte_identity(n):
    before = sharding._DEGRADED.value
    p = sharding.ShardPlane(cpus(n))
    want_mesh = {1: None, 2: {"data": 2, "lane": 1}, 3: None,
                 4: {"data": 2, "lane": 2}, 8: {"data": 4, "lane": 2}}[n]
    assert p.snapshot()["mesh"] == want_mesh
    assert sharding._DEGRADED.value == before + (n == 3)
    for blocks in _shapes(42):
        refs = [jth256(b) for b in blocks]
        packed = pack_blocks(blocks, pad_lanes=64)
        assert digests_to_bytes(p.hash_packed(*packed)) == refs
        d, dup, first = p.scan_packed(*packed)
        rdup, rfirst = dedup_digests(refs)
        assert digests_to_bytes(d) == refs
        assert list(dup) == list(rdup) and list(first) == list(rfirst)
        if blocks:
            words, counts, _ = _tensors(packed)
            assert torch.equal(cb.estimate(words, counts), _advised(p, p.put_packed(*packed)))


# -- parity with the JAX package's plane ---------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_plane_parity_with_reference(n):
    ref = ref_sharding.ShardPlane(devices=jax.devices()[:n])
    port = sharding.ShardPlane(cpus(n))
    assert port.snapshot() == ref.snapshot()
    for blocks in _shapes(43):
        packed = pack_blocks(blocks, pad_lanes=64)
        want = ref.hash_packed(*packed)
        assert np.array_equal(port.hash_packed(*packed), want)
        for got, exp in zip(port.scan_packed(*packed), ref.scan_packed(*packed)):
            assert np.array_equal(got, exp)
        if not blocks:
            continue
        rsp = ref.put_packed(*packed)
        rpred = np.asarray(ref.make_estimator()(rsp[0], rsp[1]))[: rsp.batch]
        sp = port.put_packed(*packed)
        pred = _advised(port, sp)
        np.testing.assert_allclose(pred.numpy(), rpred, rtol=0, atol=1e-5)
        assert sp.batch == rsp.batch and tuple(sp[0].shape) == tuple(rsp[0].shape)


@pytest.mark.parametrize("n_data,n_lane", [(1, 1), (2, 1), (2, 2), (4, 2)])
def test_scan_many_checksum_matches_reference(n_data, n_lane):
    rng = np.random.default_rng(9)
    packed = pack_blocks(_blocks(rng), pad_lanes=16)
    rmesh = ref_sharding.make_mesh(n_data, n_lane, jax.devices()[:n_data * n_lane])
    want = int(ref_sharding.sharded_scan_many(rmesh)(
        *ref_sharding.shard_batch(rmesh, *packed), jnp.uint32(3)))
    pmesh = sharding.make_mesh(n_data, n_lane, cpus(n_data * n_lane))
    got = sharding.sharded_scan_many(pmesh)(*sharding.shard_batch(pmesh, *packed), 3)
    assert got == want


def test_sharded_steps_match_reference_steps():
    rng = np.random.default_rng(10)
    packed = pack_blocks(_blocks(rng), pad_lanes=16)
    rmesh = ref_sharding.make_mesh(4, 2, jax.devices())
    pmesh = sharding.make_mesh(4, 2, cpus(8))
    rplaced = ref_sharding.shard_batch(rmesh, *packed)
    placed = sharding.shard_batch(pmesh, *packed)
    want = np.asarray(ref_sharding.sharded_hash_step(rmesh)(*rplaced))
    got = sharding.sharded_hash_step(pmesh)(*placed)
    assert np.array_equal(ht.digests_to_numpy(got), want)
    for g, w in zip(sharding.sharded_scan_step(pmesh)(*placed),
                    ref_sharding.sharded_scan_step(rmesh)(*rplaced)):
        assert np.array_equal(g.numpy().astype(np.asarray(w).dtype), np.asarray(w))


# -- the kernel's global lane offset -------------------------------------------

def _ref_chain(words: np.ndarray, m: int, loff: int) -> np.ndarray:
    """The JAX chain over lanes that are lanes [loff, loff + m) of their
    blocks: words (L, 128, 128) uint32 with L = B * m."""
    w = jnp.asarray(words.reshape(-1, m, 128, 128))
    s = hj._row_chain_scan(w, hj._lane_states(w, loff))
    return np.asarray(s).reshape(-1, 128)


@pytest.mark.parametrize("loff", [0, 3, 64])
def test_lane_offset_twin_and_plain_match_jax(loff):
    rng = np.random.default_rng(11 + loff)
    m = 3
    words = rng.integers(0, 1 << 32, size=(2 * m, 128, 128), dtype=np.uint32)
    want = _ref_chain(words, m, loff)
    tw = torch.from_numpy(words.view(np.int32))
    plain = ht.row_chain_ref(tw, m, 0, loff)
    assert np.array_equal(plain.numpy().view(np.uint32), want)
    twin = kernels.load_twin()
    got = twin.row_chain(tw, m, 0, loff)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # uint32 wrap: an offset near 2^32 wraps as the reference's does
    near = (1 << 32) - 2
    assert np.array_equal(twin.row_chain(tw, m, 0, near).numpy().view(np.uint32),
                          ht.row_chain_ref(tw, m, 0, near).numpy().view(np.uint32))


@pytest.mark.parametrize("loff", [0, 3, 64])
def test_lane_accs_offset_matches_jax(loff):
    rng = np.random.default_rng(20 + loff)
    s = rng.integers(0, 1 << 32, size=(2, 5, 128), dtype=np.uint32)
    got = ht.lane_accs(torch.from_numpy(s.view(np.int32)), loff)
    want = np.asarray(hj._lane_accs(jnp.asarray(s), loff))
    assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_byte_histogram_offset_masks_global_lanes():
    rng = np.random.default_rng(12)
    blocks = [rng.bytes(4 << 16), rng.bytes((1 << 16) + 5), b"\x01"]
    words, counts, _ = _tensors(pack_blocks(blocks, pad_lanes=4))
    whole = cb.byte_histogram(words, counts)
    halves = (cb.byte_histogram(words[:, :2].contiguous(), counts, 0)
              + cb.byte_histogram(words[:, 2:].contiguous(), counts, 2))
    assert torch.equal(whole, halves)
    assert torch.equal(cb.entropy_ratio(whole), cb.estimate(words, counts))


# -- the slice as a whole ------------------------------------------------------

def test_dryrun_multichip_on_a_2x2_cpu_mesh(capsys):
    from juicefs_tpu_torch.multichip import dryrun_multichip

    before = sharding._DEGRADED.value
    res = dryrun_multichip(cpus(4), gib=9 / 1024, block_mib=1)
    assert res["identity_ok"] and res["mesh"] == {"data": 2, "lane": 2}
    assert not res["degraded"] and sharding._DEGRADED.value == before
    assert res["blocks"] == 9 and res["scan"]["hashed_now"] == 9
    # lz4 on: every block ingest hashed was estimated on the 2 x 2 mesh,
    # from the pack split over it, and recorded by the store's compress plane
    ing = res["ingest"]
    assert ing["estimated"] == ing["hashed"] > 0 and ing["compress_degraded"] == 0
    assert res["duplicate_blocks"] == res["ingest"]["put_elided"] > 0
    assert res["scan"]["shard"] == {"devices": 4, "mesh": {"data": 2, "lane": 2},
                                    "degraded": False, "reason": ""}
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("MULTICHIP ")]
    assert len(line) == 1 and json.loads(line[0][len("MULTICHIP "):]) == res


def test_gc_dedup_reports_the_plane_it_ran_on(tmp_path, monkeypatch, capsys):
    """`gc --dedup --hash-backend cuda` hashes on the process-wide plane
    (here a 2 x 2 mesh of CPU devices standing in for the cards) and its
    JSON `shard` is that plane's snapshot; the index it writes is the
    numpy spec's."""
    plane = sharding.ShardPlane(cpus(4))
    monkeypatch.setattr(sharding, "_plane", plane)
    bs = 256 << 10
    meta_url = f"sqlite3://{tmp_path}/vol.db"
    assert cmd.main(["format", meta_url, "vol", "--storage", "file", "--bucket",
                     str(tmp_path / "blob"), "--block-size", str(bs >> 10),
                     "--compress", "none", "--hash-backend", "cpu",
                     "--trash-days", "0"]) == 0
    rng = np.random.default_rng(13)
    uniq = [rng.bytes(bs) for _ in range(4)]
    blocks = uniq + [uniq[1], uniq[3], rng.bytes(bs // 2 + 9)]
    m, fmt = cmd.open_meta(meta_url)
    store = cmd.build_store(fmt, types.SimpleNamespace(compress_backend="cpu", cache_size=1),
                            meta=m, with_indexer=False)
    try:
        ctx = Context(uid=0, gid=0)
        st, ino, _ = m.create(ctx, 1, b"data.bin", 0o644)
        assert st == 0
        for i, data in enumerate(blocks):
            sid = m.new_slice()
            w = store.new_writer(sid)
            w.write_at(data, 0)
            w.finish(len(data))
            indx, pos = divmod(i, CHUNK_SIZE // bs)
            assert m.write_chunk(ino, indx, pos * bs, Slice(
                pos=pos * bs, id=sid, size=len(data), off=0, len=len(data))) == 0
        store.flush_all()
    finally:
        store.close()
        m.client.close()
    index = tmp_path / "index.json"
    h2d = sharding._H2D_BATCHES.value
    capsys.readouterr()
    assert cmd.main(["gc", meta_url, "--dedup", "--hash-backend", "cuda",
                     "--compress-backend", "cpu", "--threads", "4",
                     "--dedup-index", str(index)]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["shard"] == plane.snapshot() == {
        "devices": 4, "mesh": {"data": 2, "lane": 2}, "degraded": False, "reason": ""}
    assert stats["backend"] == "cuda" and stats["hashed_now"] == len(blocks)
    assert stats["duplicate_blocks"] == 2
    assert sharding._H2D_BATCHES.value == h2d + 1  # 7 blocks: one batch
    assert sorted(json.loads(index.read_text()).values()) == \
        sorted(jth256(b).hex() for b in blocks)
