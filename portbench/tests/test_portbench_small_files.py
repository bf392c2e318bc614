"""The small-file cell, `small-files.dedup-4m-lz4`, at a tiny size on the
CPU: a run is correct, the reference's plan holds the duplicates the
traffic asks for, and a traced run reports the cell's four new metrics;
the readers of those metrics on records made by hand."""

import json
import pathlib

import pytest

from portbench.reference import small_files as plan
from portbench.run import ROOT, load_metric
from tiny import tiny_run

CELL = "small-files.dedup-4m-lz4"
ROUND = {"config": {"small_file_count": 10}}  # rounds of 10 files, so the tiny window unlinks
NEW = ["file_create_ms", "file_flush_ms", "file_block_wait_ms", "ingest_h2d_bytes_per_byte"]


def test_a_tiny_run_is_correct(cpu_plane):
    r = tiny_run(CELL, seconds=2.0, overrides=ROUND)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"elide_errors", "readback_errors", "passthrough_pct",
                                "digest_errors", "verdict_errors", "meta_errors",
                                "failed_commits"}
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert r["failed"] == 0 and r["attempted"] > 10
    assert set(r["unbounded"]) == {"write_gibs", "write_p95_ms", "small_files_s"}


@pytest.mark.parametrize("seed", [0, 2**33 + 17, 2**62 + 5])
def test_the_plan_holds_the_duplicates_the_traffic_asks_for(seed):
    traffic = json.loads(pathlib.Path(ROOT, "portbench", "traffic", "small-files.json").read_text())
    every, pool = traffic["dup_every"], traffic["dup_pool"]
    cids = plan.Plan(seed, every, pool).take(400)
    runs = [cids[i:i + every] for i in range(0, len(cids), every)]
    assert all(sum(c < 0 for c in run) == 1 for run in runs)
    assert {c for c in cids if c < 0} <= {-(j + 1) for j in range(pool)}
    uniques = [c for c in cids if c >= 0]
    assert uniques == list(range(len(uniques)))
    aliases = plan.aliases(cids, pool)
    assert [a is not None for a in aliases] == [c < 0 for c in cids]
    assert all(a == -c - 1 for a, c in zip(aliases, cids) if c < 0)
    assert cids == plan.Plan(seed, every, pool).take(400)  # the seed alone decides


def test_contents_are_windows_that_never_share_bytes():
    buf = bytes(range(256)) * 64
    size, pool, stride = 1024, 2, 100
    got = [plan.content(buf, c, size, pool, stride) for c in (-1, -2, 0, 1)]
    assert [len(b) for b in got] == [size] * 4 and len(set(got)) == 4
    assert got[2] == buf[2 * stride:2 * stride + size]
    with pytest.raises(ValueError):
        plan.content(buf, len(buf) // stride, size, pool, stride)


def test_a_traced_run_reports_the_new_metrics(cpu_plane):
    r = tiny_run(CELL, seconds=2.0, trace=True, overrides=ROUND)
    assert r["correct"], r["checks"]
    got = {n: r["metrics"][n]["value"] for n in NEW}
    assert got["ingest_h2d_bytes_per_byte"] == 1.0  # a 128 KiB file is 2 whole lanes
    assert 0 < got["file_create_ms"] and 0 < got["file_block_wait_ms"] <= got["file_flush_ms"]
    assert r["metrics"]["ingest_blocks_per_batch"]["value"] == 1.0


def _rec(stages=None, **window):
    return {"window": window, "stages": stages or {}, "counters": {}, "trace": None}


@pytest.mark.parametrize("name, rec, want", [
    ("file_create_ms", _rec({"vfs.create": {"count": 4, "seconds": 0.002}}), 0.5),
    ("file_flush_ms", _rec({"vfs.flush": {"count": 2, "seconds": 0.01}}), 5.0),
    ("file_block_wait_ms", _rec({"chunk.write.finish": {"count": 8, "seconds": 0.02}},
                                files=4), 5.0),
    ("ingest_h2d_bytes_per_byte", _rec(h2d_bytes=32 << 20, hash_bytes=1 << 20), 32.0),
    # what the parent program gives: no such span, so nothing to read
    ("file_create_ms", _rec(), None),
    ("file_flush_ms", _rec({"vfs.create": {"count": 4, "seconds": 0.002}}), None),
    ("file_block_wait_ms", _rec(files=4), None),
    ("file_block_wait_ms", _rec({"chunk.write.finish": {"count": 8, "seconds": 0.02}},
                                files=0), None),
    ("ingest_h2d_bytes_per_byte", _rec(h2d_bytes=0, hash_bytes=0), None),
    ("ingest_h2d_bytes_per_byte", _rec(bytes=1 << 20), None),
])
def test_the_readers_on_records_made_by_hand(name, rec, want):
    got = load_metric(name)(rec)
    assert got == (pytest.approx(want) if want is not None else None)
