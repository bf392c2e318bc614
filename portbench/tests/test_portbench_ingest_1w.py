"""The one-writer cell, `ingest-1w.dedup-4m-lz4`, at a tiny size on the CPU:
with mount's write buffer bound the writer waits for the inline-dedup
stage and every block is hashed; with the bound off and a small ingest
queue it outruns the stage, and the run's checks catch the blocks passed
through. And the reader of `write_buffer_wait_ms_per_gib` on records made
by hand."""

import importlib.util
import pathlib
import time

import pytest

from tiny import tiny_run

CELL = "ingest-1w.dedup-4m-lz4"
FLAGS = ["--inline-dedup", "--no-dedup-bypass"]
FILE_MIB = 32  # files of 8 blocks: the writer outruns a bound of 2 blocks


@pytest.fixture
def slow_hash(monkeypatch):
    """Each hash batch of the ingest stage takes 40 ms longer, so a
    writer on the CPU outruns the stage."""
    from juicefs_tpu_torch.chunk.ingest import IngestPipeline

    orig = IngestPipeline._process

    def process(self, batch):
        time.sleep(0.04)
        return orig(self, batch)

    monkeypatch.setattr(IngestPipeline, "_process", process)


def _run(buffer_mib: int, trace: bool):
    return tiny_run(CELL, trace=trace, overrides={
        "config": {"flags": FLAGS + ["--buffer-size", str(buffer_mib)]},
        "traffic": {"file_mib": FILE_MIB}})


def test_the_bound_holds_the_writer_to_the_stage(cpu_plane, slow_hash):
    for trace in (False, True):
        r = _run(8, trace)
        assert r["correct"], r["checks"]
        assert r["checks"]["passthrough_pct"]["value"] == 0
        assert r["failed"] == 0 and r["attempted"] > 0
        if trace:
            assert r["metrics"]["write_buffer_wait_ms_per_gib"]["value"] > 0
            assert r["metrics"]["ingest_blocks_per_batch"]["value"] >= 1


def test_without_the_bound_the_checks_catch_the_overrun(cpu_plane, slow_hash, monkeypatch):
    """`--buffer-size 0` and an ingest queue of 2 blocks: the writer's
    blocks overrun the queue and pass through unhashed, and the run is
    judged not correct on that share alone."""
    from juicefs_tpu_torch.gpu.pipeline import HashBatcher

    orig = HashBatcher.__init__

    def init(self, pipe, queue_blocks=64, flush_timeout=0.005):
        orig(self, pipe, queue_blocks=2, flush_timeout=flush_timeout)

    monkeypatch.setattr(HashBatcher, "__init__", init)
    r = _run(0, False)
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert checks.pop("passthrough_pct") > 1
    assert not r["correct"]
    assert set(checks.values()) == {0}, checks


def _reader():
    path = pathlib.Path(__file__).parents[1] / "metrics" / "write_buffer_wait_ms_per_gib.py"
    spec = importlib.util.spec_from_file_location("write_buffer_wait_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("stages, nbytes, want", [
    ({}, 1 << 30, 0.0),  # bytes committed, no writer waited
    ({"chunk.write.buffer_wait": {"count": 3, "seconds": 0.5}}, 2 << 30, 250.0),
    ({}, 0, None),  # nothing committed
    ({"chunk.write.buffer_wait": {"count": 3, "seconds": 0.5}}, 0, None),
])
def test_the_reader_on_records_made_by_hand(stages, nbytes, want):
    rec = {"window": {"bytes": nbytes}, "stages": stages, "counters": {}, "trace": None}
    assert _reader()(rec) == want
