"""Cells at a size a test run holds, with no look for a card: 6 full
blocks and a tail, 64 MiB of buffer, a small live set, files of 2
blocks (at most 8 blocks in flight to the inline-dedup stage, which the
CPU's hash keeps up with: a full stage passes blocks through, and more
than 1 % of them is not correct)."""

import json
import pathlib

TINY = {"config": {"live_blocks": 6, "live_gib": 0.05}, "traffic": {"buffer_mib": 64, "file_mib": 8}}
CELLS = tuple(c["name"] for c in json.loads(
    pathlib.Path(__file__).parents[2].joinpath("BENCHMARK.json").read_text())["workloads"])


def one_writer() -> dict:
    """The one-writer mix kept for a later cell (`traffic/ingest-1w.json`,
    juicefs bench's big file) as overrides of an ingest cell, its files cut
    to 2 blocks, which the CPU's hash keeps up with."""
    path = pathlib.Path(__file__).parents[1] / "traffic" / "ingest-1w.json"
    return {"traffic": {**json.loads(path.read_text()), "file_mib": 8}}


def tiny_run(cell, seed=2**33 + 17, seconds=1.0, trace=False, overrides=None, sample=1000):
    """One run of `cell` at the tiny size, with no look for a card; every
    output is compared (the sample covers all of them)."""
    from portbench.run import run_cell

    ov = {k: dict(v) for k, v in TINY.items()}
    for k, v in (overrides or {}).items():
        ov.setdefault(k, {}).update(v)
    result, _checks = run_cell(cell, seed, seconds, trace, require_cuda=False,
                               overrides=ov, sample=sample)
    return result
