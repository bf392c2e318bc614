"""The indexed-writer cell, `index-write.plain-4m`, at a tiny size on the
CPU: a run is correct, the reference's plan is the writers' stream, a
traced run reports the cell's six new metrics, and their readers on
records made by hand."""

import json
import pathlib

import numpy as np
import pytest

from portbench import data
from portbench.reference import index_write as plan
from portbench.reference import jth256 as ref
from portbench.run import ROOT, load_metric
from tiny import tiny_run

CELL = "index-write.plain-4m"
# two writers for half a second write fewer blocks than the indexer's
# staging slots hold, so the CPU's slow hash drops none
SMALL = {"traffic": {"writers": 2}}
CHECKS = {"readback_errors", "digest_errors", "index_count_errors", "dropped_pct",
          "failed_commits"}
NEW = ["index_dropped_share", "index_blocks_per_batch", "index_hash_ms_per_gib",
       "index_register_ms_per_gib", "index_worker_busy_share", "index_queue_wait_ms"]


def test_a_tiny_run_is_correct(cpu_plane):
    r = tiny_run(CELL, seconds=0.5, overrides=SMALL)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == CHECKS
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["unbounded"]) == {"write_gibs", "write_p95_ms"}


def test_a_traced_run_reports_the_new_metrics():
    """With the volume's host hash (`--hash-backend cpu`), fast enough on
    the CPU for four writers: every new metric has a value."""
    r = tiny_run(CELL, seconds=1.0, trace=True, overrides={"config": {"hash_backend": "cpu"}})
    assert r["correct"], r["checks"]
    got = {n: r["metrics"][n]["value"] for n in NEW}
    assert got["index_dropped_share"] == 0.0
    assert 0 < got["index_blocks_per_batch"] <= 32
    assert got["index_hash_ms_per_gib"] > 0 and got["index_register_ms_per_gib"] > 0
    assert 0 < got["index_worker_busy_share"] <= 100 and got["index_queue_wait_ms"] > 0
    assert "upload_put_ms_per_gib" in r["metrics"]


@pytest.mark.parametrize("seed", [0, 2**33 + 17, 2**62 + 5])
def test_the_plan_is_the_writers_stream(seed):
    traffic = json.loads(pathlib.Path(ROOT, "portbench", "traffic", "index-write.json").read_text())
    writers, every, pool = traffic["writers"], traffic["dup_every"], traffic["dup_pool"]
    for w in range(writers):
        stream = data.WriterStream(seed, w, writers, every, pool)
        cids = plan.Plan(seed, w, writers, every, pool).take(400)
        assert cids == [stream.next() for _ in range(400)]
        runs = [cids[i:i + every] for i in range(0, len(cids), every)]
        assert all(sum(c < 0 for c in run) == 1 for run in runs)
        assert [c for c in cids if c >= 0] == list(range(w, w + 300 * writers, writers))


def test_rows_follow_where_each_slice_lies():
    """A slice's block indx is its writer's stream at the slice's first
    position + indx; its row is that content's bytes and digest."""
    seed, writers, every, pool, size, stride = 5, 2, 4, 2, 1024, 1100
    buf = np.random.default_rng(1).bytes(64 * stride)
    contents = data.Contents(buf, size, pool, stride)
    placed = {10: (1, 0), 11: (0, 4), 12: (1, 4)}
    keys = [(10, 0), (10, 3), (11, 1), (12, 2)]
    got = plan.rows(buf, seed, placed, keys, writers=writers, dup_every=every, pool=pool,
                    block_size=size, stride=stride)
    streams = {w: data.WriterStream(seed, w, writers, every, pool) for w in range(writers)}
    cids = {w: [streams[w].next() for _ in range(8)] for w in range(writers)}
    for sid, indx in keys:
        w, first = placed[sid]
        block = contents.block(cids[w][first + indx])
        assert got[(sid, indx)] == (block, ref.jth256(block))
    with pytest.raises(ValueError):
        plan.content(buf, 10**6, size, pool, stride)


def _rec(stages=None, **window):
    return {"window": window, "stages": stages or {}, "counters": {}, "trace": None}


GIB = 1 << 30


@pytest.mark.parametrize("name, rec, want", [
    ("index_dropped_share", _rec(index_blocks=90, index_dropped=8, index_errors=2), 8.0),
    ("index_blocks_per_batch",
     _rec({"chunk.index.process": {"count": 4, "seconds": 1.0}}, index_blocks=100), 25.0),
    ("index_hash_ms_per_gib", _rec({"gpu.index.batch": {"count": 8, "seconds": 0.5}},
                                   bytes=2 * GIB), 250.0),
    ("index_register_ms_per_gib",
     _rec({"chunk.index.register": {"count": 8, "seconds": 0.2}}, bytes=GIB), 200.0),
    ("index_worker_busy_share",
     _rec({"chunk.index.process": {"count": 8, "seconds": 6.0}}, window_s=30.0), 20.0),
    ("index_queue_wait_ms", _rec({"chunk.index.wait": {"count": 64, "seconds": 3.2}}), 50.0),
    # what the parent program gives: no such counter or span, nothing to read
    ("index_dropped_share", _rec(bytes=GIB), None),
    ("index_dropped_share", _rec(index_blocks=0, index_dropped=0, index_errors=0), None),
    ("index_blocks_per_batch", _rec({"gpu.index.batch": {"count": 4, "seconds": 1.0}}), None),
    ("index_blocks_per_batch",
     _rec({"chunk.index.process": {"count": 4, "seconds": 1.0}}), None),
    ("index_hash_ms_per_gib", _rec(bytes=GIB), None),
    ("index_register_ms_per_gib", _rec(bytes=GIB), None),
    ("index_worker_busy_share", _rec(window_s=30.0), None),
    ("index_queue_wait_ms", _rec(), None),
])
def test_the_readers_on_records_made_by_hand(name, rec, want):
    got = load_metric(name)(rec)
    assert got == (pytest.approx(want) if want is not None else None)
