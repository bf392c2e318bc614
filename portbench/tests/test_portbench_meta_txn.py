"""The readers of the sqlite meta engine's write-transaction stages
(`meta.txn.lock_wait`, `.run`, `.commit`) on hand-built records, and
their declarations in BENCHMARK.json."""

import json
import os

import pytest

from portbench.run import ROOT, applies, load_metric

GIB = 1 << 30
WRITE_CELLS = ["ingest-4w.dedup-4m-lz4", "ingest-1w.dedup-4m-lz4",
               "small-files.dedup-4m-lz4", "index-write.plain-4m"]
READERS = {"meta_lock_wait_ms_per_gib": WRITE_CELLS,
           "meta_txn_run_ms_per_gib": WRITE_CELLS,
           "meta_commit_ms_per_gib": WRITE_CELLS,
           "meta_txns_per_file": ["small-files.dedup-4m-lz4"]}
STAGE = {"meta_lock_wait_ms_per_gib": "meta.txn.lock_wait",
         "meta_txn_run_ms_per_gib": "meta.txn.run",
         "meta_commit_ms_per_gib": "meta.txn.commit",
         "meta_txns_per_file": "meta.txn.commit"}


def _rec(nbytes=2 * GIB, files=400, **stages):
    return {"window": {"bytes": nbytes, "files": files, "window_s": 30.0},
            "stages": stages}


def _stages():
    return {"meta.txn.lock_wait": {"count": 2010, "seconds": 0.5},
            "meta.txn.run": {"count": 2000, "seconds": 1.5},
            "meta.txn.commit": {"count": 2000, "seconds": 0.25},
            "chunk.ingest.register": {"count": 400, "seconds": 3.0}}


@pytest.mark.parametrize("name, want", [
    ("meta_lock_wait_ms_per_gib", 250.0),
    ("meta_txn_run_ms_per_gib", 750.0),
    ("meta_commit_ms_per_gib", 125.0),
    ("meta_txns_per_file", 5.0),
])
def test_a_reader_gives_the_known_number(name, want):
    assert load_metric(name)(_rec(**_stages())) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_without_its_stage_gives_none(name):
    """The parent program has no such span: the metric is left out."""
    stages = _stages()
    del stages[STAGE[name]]
    assert load_metric(name)(_rec(**stages)) is None
    assert load_metric(name)(_rec()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_of_an_empty_window_gives_none(name):
    field = "files" if name == "meta_txns_per_file" else "nbytes"
    assert load_metric(name)(_rec(**{field: 0}, **_stages())) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_is_declared_for_exactly_its_cells(name):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (metric,) = [m for m in bench["per_layer"] if m["name"] == name]
    cells = [w["name"] for w in bench["workloads"]]
    assert [c for c in cells if applies(metric, c)] == READERS[name]
    assert metric["source"] == "program_span"
    assert metric["layer"] == "meta (kv on sqlite3) transaction"
    assert metric["moves"] == "write_kernel_ms_per_gib"
    assert metric["better"] == "lower"
    assert metric["unit"] == ("txn/file" if name == "meta_txns_per_file" else "ms/GiB")
