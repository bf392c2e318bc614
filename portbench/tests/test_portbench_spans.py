"""The readers of the program's own spans (`portbench/spans.py` and the
metrics that use it) on synthetic records, the program's spans as ranges
of the device trace's profiler and never of the card clock's, and the new
metrics in a traced run at a tiny size on the CPU and, marked `cuda`, on
the card."""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

from portbench.devtrace import DeviceTrace
from portbench.run import ROOT, applies, load_metric
from tiny import CELLS, tiny_run

GIB = 1 << 30
GC = ["gc-cold.plain-4m", "gc-incr.plain-4m"]
INGEST = ["ingest-4w.dedup-4m-lz4"]
NEW = {"gc_pack_share": GC, "gc_fetch_wait_share": GC, "gc_card_wait_share": GC,
       "ingest_upload_ms_per_gib": INGEST, "ingest_worker_busy_share": INGEST,
       "ingest_queue_wait_ms": INGEST}


def _stage(count, seconds):
    return {"count": count, "seconds": seconds}


def _gc_rec(**stages):
    return {"window": {"passes": [{"seconds": 1.5}, {"seconds": 2.5}], "window_s": 4.2},
            "stages": stages}


def _ingest_rec(**stages):
    return {"window": {"bytes": 2 * GIB, "window_s": 10.0}, "stages": stages}


@pytest.mark.parametrize("name, rec, want", [
    ("gc_pack_share", _gc_rec(**{"gpu.hash.pack": _stage(66, 2.0)}), 50.0),
    ("gc_fetch_wait_share", _gc_rec(**{"chunk.fetch.wait": _stage(2050, 0.2)}), 5.0),
    ("gc_card_wait_share", _gc_rec(**{"gpu.hash.slot_wait": _stage(66, 0.1),
                                      "gpu.hash.drain": _stage(66, 0.3)}), 10.0),
    ("ingest_upload_ms_per_gib", _ingest_rec(**{"gpu.hash.upload": _stage(80, 0.5)}), 250.0),
    ("ingest_worker_busy_share", _ingest_rec(**{"chunk.ingest.process": _stage(80, 6.0)}),
     60.0),
    ("ingest_queue_wait_ms", _ingest_rec(**{"gpu.batcher.wait": _stage(100, 0.2)}), 2.0),
])
def test_a_reader_gives_the_known_number(name, rec, want):
    assert load_metric(name)(rec) == pytest.approx(want)


@pytest.mark.parametrize("name, rec", [
    ("gc_pack_share", _gc_rec(**{"chunk.fetch.wait": _stage(1, 0.1)})),
    ("gc_fetch_wait_share", _gc_rec()),
    # the parent program times the drain but not the slot wait
    ("gc_card_wait_share", _gc_rec(**{"gpu.hash.drain": _stage(66, 0.3)})),
    ("ingest_upload_ms_per_gib", _ingest_rec(**{"chunk.ingest.pack": _stage(80, 1.0)})),
    ("ingest_worker_busy_share", _ingest_rec()),
    ("ingest_queue_wait_ms", _ingest_rec(**{"chunk.ingest.hash": _stage(80, 0.1)})),
    ("gc_pack_share", {"window": {"passes": []}, "stages": {"gpu.hash.pack": _stage(1, 1.0)}}),
    ("ingest_worker_busy_share",
     {"window": {"window_s": 0.0}, "stages": {"chunk.ingest.process": _stage(1, 1.0)}}),
])
def test_a_missing_stage_or_base_gives_none(name, rec):
    assert load_metric(name)(rec) is None


def test_the_new_metrics_are_declared_for_their_cells():
    bench = json.loads(pathlib.Path(ROOT, "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name, cells in NEW.items():
        m = per_layer[name]
        assert m["source"] == "program_span" and m["workloads"] == cells
        assert callable(load_metric(name))
        assert all(applies(e, c) for c in cells for e in bench["end_to_end"]
                   if e["name"] == m["moves"])
    assert list(per_layer)[-len(NEW):] == list(NEW)


def test_the_device_trace_profiler_turns_the_spans_into_ranges(tmp_path):
    from juicefs_tpu_torch.metric.trace import NULL_SPAN, _RangedSpan, global_tracer

    tr = global_tracer()
    off = DeviceTrace(False, str(tmp_path), "cpu")
    off.begin()
    assert tr.span("test", "devtrace") is NULL_SPAN
    off.end()
    on = DeviceTrace(True, str(tmp_path), "cpu")
    on.begin()
    try:
        assert type(tr.span("test", "devtrace")) is _RangedSpan
    finally:
        with pytest.raises(RuntimeError, match="never marked"):
            on.end()  # no sub-window was marked; the profiler is stopped all the same
    assert tr.span("test", "devtrace") is NULL_SPAN


@pytest.mark.cuda
def test_the_card_clock_records_no_program_range(tmp_path):
    """`CardClock` records card activity alone: a span under it opens a
    range that records nothing, and costs little."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from juicefs_tpu_torch.metric.trace import _RangedSpan, global_tracer, stage_hist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    tr = global_tracer()
    hist = stage_hist("test", "cardclock", "span")
    n = 20000
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").sum().item()
        assert type(tr.span("test", "cardclock", stage="span", hist=hist)) is _RangedSpan
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.span("test", "cardclock", stage="span", hist=hist):
                pass
        per_span = (time.perf_counter() - t0) / n
    path = tmp_path / "card.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    assert not [e for e in events if e.get("name") == "test.cardclock.span"]
    print(f"a span under a card-only profiler: {per_span * 1e6:.2f} us")
    assert per_span < 20e-6


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_new_metrics(cell, cpu_plane):
    untraced = tiny_run(cell)
    assert untraced["correct"], untraced["checks"]
    r = tiny_run(cell, trace=True)
    assert r["correct"], r["checks"]
    got = {n: r["metrics"][n]["value"] for n, cells in NEW.items() if cell in cells}
    assert set(got) == {n for n, cells in NEW.items() if cell in cells}
    assert all(v >= 0 for v in got.values())
    if cell in GC:
        # one thread's disjoint stages: at most the whole of each pass
        assert got["gc_pack_share"] + got["gc_fetch_wait_share"] \
            + got["gc_card_wait_share"] <= 101.0
        assert got["gc_pack_share"] > 0
    else:
        assert 0 < got["ingest_worker_busy_share"] <= 100.0
        assert got["ingest_queue_wait_ms"] > 0 and got["ingest_upload_ms_per_gib"] > 0


PROGRAM = ("gpu.", "chunk.", "meta.", "object.")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gc-cold.plain-4m", "ingest-4w.dedup-4m-lz4"])
def test_a_traced_run_on_the_card_names_the_program_stages(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(2**33 + 5), "--seconds", "4", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    got = {n: r["metrics"][n]["value"] for n, cells in NEW.items() if cell in cells}
    assert len(got) == sum(cell in cells for cells in NEW.values())
    if cell in GC:
        assert got["gc_pack_share"] + got["gc_fetch_wait_share"] \
            + got["gc_card_wait_share"] <= 101.0
    gaps = [name for name, _s in r["breakdown"]["idle_gaps"]]
    assert sum(name.startswith(PROGRAM) for name in gaps) > len(gaps) / 2, gaps
