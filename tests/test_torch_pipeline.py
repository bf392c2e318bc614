"""gpu/pipeline.py against tpu/pipeline.py, plus the batcher's contracts and
the hash-backend mapping of reference-formatted volumes.

Blocks come from numpy with a seed; digests must be identical (exact).
"""

import sys
import threading
import time

import numpy as np
import pytest

import juicefs_tpu.tpu  # noqa: F401  (loads the reference spec module)
from juicefs_tpu.tpu.pipeline import HashPipeline as RefPipeline
from juicefs_tpu.tpu.pipeline import PipelineConfig as RefConfig
from juicefs_tpu_torch.chunk.indexer import pipeline_backend
from juicefs_tpu_torch.gpu import pipeline as pp
from juicefs_tpu_torch.gpu.pipeline import HashBatcher, HashPipeline, PipelineConfig

ref_spec = sys.modules["juicefs_tpu.tpu.jth256"]
LANE = ref_spec.LANE_BYTES


def _items(seed, n):
    rng = np.random.default_rng(seed)
    sizes = [0, 1, 100, LANE, LANE + 7, 3 * LANE, 4 * LANE]
    return [(f"k{i}", rng.integers(0, 256, size=sizes[int(rng.integers(0, len(sizes)))],
                                   dtype=np.uint8).tobytes()) for i in range(n)]


@pytest.mark.parametrize("backend,n,inflight", [
    ("cuda", 11, 2),   # ragged last batch (4 + 4 + 3), device path on the CPU
    ("cuda", 8, 1),    # exact batches, no lookahead
    ("cuda", 13, 3),   # deeper in-flight window reuses staging slots
    ("cpu", 11, 2),
])
def test_hash_stream_matches_reference(backend, n, inflight):
    items = _items(n * 7 + inflight, n)
    ref = list(RefPipeline(RefConfig(backend="cpu", batch_blocks=4, pad_lanes=4))
               .hash_stream(items))
    pipe = HashPipeline(PipelineConfig(backend=backend, batch_blocks=4, pad_lanes=4,
                                       max_inflight_batches=inflight), device="cpu")
    got = list(pipe.hash_stream(items))
    assert got == ref
    assert [k for k, _ in got] == [k for k, _ in items]


def test_hash_stream_counters_and_bounds():
    items = _items(3, 9)
    pipe = HashPipeline(PipelineConfig(batch_blocks=4, pad_lanes=4), device="cpu")
    h2d0, blocks0 = pp._H2D_BYTES.value, pp._BLOCKS_HASHED.value
    bytes0 = pp._HASH_BYTES.value
    assert len(list(pipe.hash_stream(items))) == 9
    assert pp._BLOCKS_HASHED.value - blocks0 == 9
    assert pp._HASH_BYTES.value - bytes0 == sum(len(b) for _, b in items)
    # batches of 4 + 4 + 1 blocks, each padded to 4 lanes of 64 KiB
    assert pp._H2D_BYTES.value - h2d0 == 9 * 4 * LANE
    with pytest.raises(ValueError):
        list(pipe.hash_stream([("big", bytes(5 * LANE))]))


def test_cpu_backend_ships_nothing_to_a_device():
    pipe = HashPipeline(PipelineConfig(backend="cpu", batch_blocks=4))
    assert not pipe.device_backend
    h2d0 = pp._H2D_BYTES.value
    blocks = [b for _, b in _items(4, 6)]
    assert pipe.hash_blocks(blocks) == [ref_spec.jth256(b) for b in blocks]
    assert pp._H2D_BYTES.value == h2d0
    assert pipe.shard_snapshot()["devices"] == 0


def test_hash_packed_and_shard_packed():
    blocks = [b for _, b in _items(5, 5)]
    packed = ref_spec.pack_blocks(blocks, pad_lanes=4)
    want = [ref_spec.jth256(b) for b in blocks]
    for backend in ("cpu", "cuda"):
        pipe = HashPipeline(PipelineConfig(backend=backend, pad_lanes=4), device="cpu")
        assert pipe.hash_packed(*packed) == want
        assert pipe.hash_packed(*pipe.shard_packed(packed)) == want
        assert pipe.hash_packed(*packed, n=3) == want[:3]
    snap = HashPipeline(PipelineConfig(backend="cuda"), device="cpu").shard_snapshot()
    assert snap == {"devices": 1, "mesh": None, "degraded": False,
                    "reason": "cuda backend"}


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        HashPipeline(PipelineConfig(backend="xla"), device="cpu")


def test_pipeline_defaults_pinned():
    cfg = PipelineConfig()
    assert (cfg.backend, cfg.batch_blocks, cfg.pad_lanes, cfg.max_inflight_batches) \
        == ("cuda", 32, 64, 2)
    hb = HashBatcher(HashPipeline(PipelineConfig(backend="cpu")))
    assert hb._q.maxsize == 64
    hb.close()


def test_hash_batcher_flush_timeout_and_kick():
    hb = HashBatcher(HashPipeline(PipelineConfig(backend="cpu", batch_blocks=4)),
                     queue_blocks=8, flush_timeout=10.0)
    out: list = []
    t = threading.Thread(target=lambda: out.extend(hb.batches()), daemon=True)
    t.start()
    assert hb.submit("a")
    hb.kick()  # flushes a partial batch long before the 10s timeout
    deadline = time.monotonic() + 5
    while not out and time.monotonic() < deadline:
        time.sleep(0.01)
    assert out and out[0] == ["a"]
    for x in "bcde":  # a full batch flushes without any kick
        hb.submit(x)
    while len(out) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert out[1] == list("bcde")
    hb.close()
    t.join(5.0)
    assert not t.is_alive()


def test_hash_batcher_flush_timeout_bounds_latency():
    hb = HashBatcher(HashPipeline(PipelineConfig(backend="cpu", batch_blocks=64)),
                     flush_timeout=0.02)
    out: list = []
    t = threading.Thread(target=lambda: out.extend(hb.batches()), daemon=True)
    t.start()
    hb.submit("lonely")
    time.sleep(0.3)
    assert out == [["lonely"]]  # flushed on the timeout, not the 64-block fill
    hb.close()
    t.join(5.0)
    assert not t.is_alive()


def test_hash_batcher_close_nonblocking_on_full_queue():
    hb = HashBatcher(HashPipeline(PipelineConfig(backend="cpu", batch_blocks=4)),
                     queue_blocks=4, flush_timeout=0.01)
    for i in range(4):
        assert hb.submit(f"item{i}")
    assert not hb.submit("overflow")  # queue full: refused, never blocks
    t0 = time.monotonic()
    hb.kick()  # full queue: the marker is dropped, no block
    hb.close()
    assert time.monotonic() - t0 < 0.5
    got = [item for batch in hb.batches() for item in batch]
    assert got == [f"item{i}" for i in range(4)]  # accepted items drain
    assert not hb.submit("post-close")
    assert hb.qsize() == 0


@pytest.mark.parametrize("name,want", [
    ("", "cpu"), ("cpu", "cpu"), ("tpu", "cuda"), ("xla", "cuda"),
    ("pallas", "cuda"), ("cuda", "cuda"),
])
def test_pipeline_backend_maps_every_reference_name(name, want):
    assert pipeline_backend(name) == want
    assert pipeline_backend(name) in pp.BACKENDS


def test_pipeline_backend_rejects_unknown():
    with pytest.raises(ValueError):
        pipeline_backend("gpu-typo")


def test_spans_and_registry_expose_the_hash_stages():
    import juicefs_tpu_torch.chunk.parallel  # noqa: F401  (registers the fetch gauge)
    from juicefs_tpu_torch.metric import global_registry
    from juicefs_tpu_torch.metric.trace import global_tracer

    tr = global_tracer()
    tr.open_reader(4242)
    try:
        pipe = HashPipeline(PipelineConfig(batch_blocks=2, pad_lanes=4), device="cpu")
        assert len(pipe.hash_blocks([b"x" * 10, b"y" * 20, b"z"])) == 3
        events = tr.drain(4242)
    finally:
        tr.close_reader(4242)
    assert not tr.active
    stages = [(e["layer"], e["op"], e["stage"]) for e in events]
    assert stages.count(("gpu", "hash", "dispatch")) == 2  # batches of 2 + 1
    assert stages.count(("gpu", "hash", "drain")) == 2
    dispatch = [e for e in events if e["stage"] == "dispatch"]
    assert [(e["batch"], e["bytes"], e["backend"]) for e in dispatch] == \
        [(2, 30, "cuda"), (1, 1, "cuda")]
    text = global_registry().render()
    for name in ("juicefs_torch_blocks_hashed", "juicefs_torch_hash_bytes",
                 "juicefs_torch_h2d_bytes", "juicefs_torch_batch_blocks_bucket",
                 "juicefs_torch_fetch_inflight",
                 'juicefs_torch_stage_seconds_count{layer="gpu",op="hash",stage="drain"}'):
        assert name in text, name
    assert not global_registry().conflicts
