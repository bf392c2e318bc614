"""The port's tracer as a source of `torch.profiler` ranges.

While a torch profiler runs, every span also opens a profiler range named
`layer.op.stage` (a `cpu_op` event), on the thread that opened it; with
no profiler running `span()` returns what it always did and no range is
opened.
Checked under a CPU `torch.profiler` that records every thread, as the
benchmark's device trace does: the hash pipeline's dispatch stages nest
inside `gpu.hash.dispatch`, the fetch stage's wait and the ingest worker's
stages appear, and each stage's rollup counts one observation per batch
(or per block, for the fetch wait and the batcher's queue wait).
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
from torch.profiler import ProfilerActivity, profile

from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig, ContentRefs, IngestPipeline
from juicefs_tpu_torch.chunk.parallel import fetch_ordered
from juicefs_tpu_torch.gpu.pipeline import HashBatcher, HashPipeline, PipelineConfig
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.metric import trace as trace_mod
from juicefs_tpu_torch.metric.trace import (
    NULL_SPAN,
    global_tracer,
    stage_hist,
    stage_metrics_snapshot,
)
from juicefs_tpu_torch.object.file import FileStorage

BS = 1 << 18  # 256 KiB blocks = 4 lanes
DISPATCH_PARTS = ("slot_wait", "pack", "upload", "launch")


def _all_threads_profile():
    from torch._C._profiler import _ExperimentalConfig

    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _ranges(prof, tmp_path) -> list[dict]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
            and not e["name"].startswith("aten::")]


def _moved(before: dict, names) -> dict:
    after = stage_metrics_snapshot()
    zero = {"count": 0, "sum_seconds": 0.0}
    return {n: after.get(n, zero)["count"] - before.get(n, zero)["count"] for n in names}


def test_no_profiler_returns_the_same_spans_and_opens_no_range(tmp_path):
    tr = global_tracer()
    assert not trace_mod._profiling() and not tr.active
    hist = stage_hist("test", "ranges", "off")
    assert tr.span("test", "ranges", stage="off") is NULL_SPAN
    assert type(tr.span("test", "ranges", stage="off", hist=hist)) is trace_mod._TimedSpan
    with _all_threads_profile() as prof:
        pass
    # spans made before the profiler ran are plain, and so are those after
    assert tr.span("test", "ranges", stage="off") is NULL_SPAN
    assert not {e["name"] for e in _ranges(prof, tmp_path)} & {"test.ranges.off"}


def test_a_running_profiler_wraps_each_kind_of_span_and_stops_with_it(tmp_path):
    tr = global_tracer()
    hist = stage_hist("test", "ranges", "on")
    with _all_threads_profile() as prof:
        timed = tr.span("test", "ranges", stage="on", hist=hist)
        null = tr.span("test", "ranges")
        assert timed.inner.__class__ is trace_mod._TimedSpan and null.inner is NULL_SPAN
        with timed as sp:
            assert sp is timed.inner and not sp.active
        with null:
            pass
    assert tr.span("test", "ranges") is NULL_SPAN
    names = [e["name"] for e in _ranges(prof, tmp_path)]
    assert names.count("test.ranges.on") == 1 and names.count("test.ranges") == 1


def test_hash_pipeline_stages_nest_in_dispatch_and_count_per_batch(tmp_path):
    blocks = {f"k{i}": os.urandom(4096 + 1000 * i) for i in range(7)}
    pipe = HashPipeline(PipelineConfig(batch_blocks=2, pad_lanes=1), device="cpu")
    stages = [f"gpu.hash.{s}" for s in DISPATCH_PARTS + ("dispatch", "drain")]
    want = HashPipeline(PipelineConfig(backend="cpu")).hash_blocks(list(blocks.values()))
    before = stage_metrics_snapshot()
    with ThreadPoolExecutor(3) as pool, _all_threads_profile() as prof:
        got = dict(pipe.hash_stream(
            fetch_ordered(list(blocks), blocks.__getitem__, pool, 3)))
    assert got == dict(zip(blocks, want))
    batches = 4  # 7 blocks in batches of 2
    moved = _moved(before, stages + ["chunk.fetch.wait"])
    assert moved == {**{s: batches for s in stages}, "chunk.fetch.wait": len(blocks)}
    ranges = _ranges(prof, tmp_path)
    by_name: dict[str, list[dict]] = {}
    for e in ranges:
        by_name.setdefault(e["name"], []).append(e)
    assert {n: len(by_name.get(n, [])) for n in stages} == {s: batches for s in stages}
    assert len(by_name["chunk.fetch.wait"]) == len(blocks)
    dispatches = by_name["gpu.hash.dispatch"]
    for part in DISPATCH_PARTS:
        for e in by_name[f"gpu.hash.{part}"]:
            assert any(d["tid"] == e["tid"] and d["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= d["ts"] + d["dur"] for d in dispatches), part
    for e in by_name["gpu.hash.drain"] + by_name["chunk.fetch.wait"]:
        assert not any(d["ts"] < e["ts"] < d["ts"] + d["dur"] for d in dispatches)


def test_batcher_wait_covers_the_time_a_block_was_held():
    hb = HashBatcher(HashPipeline(PipelineConfig(backend="cpu", batch_blocks=4)),
                     flush_timeout=0.001)
    wait = stage_hist("gpu", "batcher", "wait")
    n0, s0 = wait.total, wait.sum
    assert hb.submit(("a", 1)) and hb.submit(("b", 2))
    time.sleep(0.05)
    batches = hb.batches()
    assert next(batches) == [("a", 1), ("b", 2)]  # the items as submitted
    assert wait.total - n0 == 2
    assert wait.sum - s0 >= 2 * 0.05
    hb.close()
    assert list(batches) == []


def test_ingest_worker_stages_on_its_own_thread(tmp_path):
    meta = new_client(f"sqlite3://{tmp_path}/meta.db")
    meta.init(Format(name="ranges", trash_days=0, block_size=BS >> 10), force=True)
    storage = FileStorage(str(tmp_path / "blob"))
    storage.create()
    store = CachedStore(storage, ChunkConfig(block_size=BS, cache_size=1, compress="lz4",
                                             compress_backend="cuda", device="cpu"))
    refs = ContentRefs(meta)
    store.content_refs = refs
    store.ingest = IngestPipeline(store, refs, backend="cuda", device="cpu", batch_blocks=4,
                                  flush_timeout=0.005, hot_bytes=0)
    names = ["chunk.ingest.process", "chunk.ingest.lookup", "chunk.ingest.estimate",
             "chunk.ingest.await", "chunk.ingest.pack", "gpu.hash.pack", "gpu.hash.upload"]
    before = stage_metrics_snapshot()
    dup = os.urandom(BS)
    datas = [dup, os.urandom(BS), dup, os.urandom(BS), os.urandom(BS)]
    try:
        with _all_threads_profile() as prof:
            with global_tracer().span("test", "ranges", stage="writer"):
                pass
            w = store.new_writer(700)
            for j, b in enumerate(datas):
                w.write_at(b, j * BS)
            w.finish(len(datas) * BS)
            store.ingest.flush()
        assert store.ingest.stats()["put_elided"] == 1
    finally:
        store.close()
    moved = _moved(before, names)
    batches = moved["chunk.ingest.lookup"]
    assert batches >= 2  # 5 blocks in batches of at most 4
    assert moved == {n: batches for n in names}
    ranges = _ranges(prof, tmp_path)
    process = [e for e in ranges if e["name"] == "chunk.ingest.process"]
    assert len(process) == batches
    (writer,) = {e["tid"] for e in ranges if e["name"] == "test.ranges.writer"}
    assert {e["tid"] for e in process} - {writer}  # the worker's own thread
    for part in ("gpu.hash.pack", "gpu.hash.upload", "chunk.ingest.estimate",
                 "chunk.ingest.await"):
        inside = [e for e in ranges if e["name"] == part]
        assert len(inside) == batches
        assert all(any(p["tid"] == e["tid"] and p["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= p["ts"] + p["dur"] for p in process)
                   for e in inside), part


@pytest.mark.parametrize("under_profiler", [False, True])
def test_a_range_is_closed_when_the_span_raises(tmp_path, under_profiler):
    """A span made while the profiler runs opens and closes its range even
    when its body raises; one made before the profiler started opens none."""
    tr = global_tracer()
    hist = stage_hist("test", "ranges", "raise")
    n0 = hist.total
    early = None if under_profiler else tr.span("test", "ranges", stage="raise", hist=hist)
    with _all_threads_profile() as prof:
        with pytest.raises(KeyError):
            with early or tr.span("test", "ranges", stage="raise", hist=hist):
                raise KeyError("x")
    assert hist.total - n0 == 1
    names = [e["name"] for e in _ranges(prof, tmp_path)]
    assert names.count("test.ranges.raise") == (1 if under_profiler else 0)
