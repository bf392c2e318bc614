"""The program's own spans in a traced run.

While a torch profiler runs, every span of the port opens a profiler range
named after its stage (`layer.op.stage`), so the device trace names the
host stage around each idle gap; a program without such ranges leaves
only the benchmark's own.

The readers below take `rec["stages"]`, the stage rollup moved over the
window ({layer.op.stage: {count, seconds}}, seconds summed over threads),
and return None when a stage they need is missing from it.
"""

from __future__ import annotations


def _seconds(rec, stages):
    moved = rec["stages"]
    if not stages or any(s not in moved for s in stages):
        return None
    return sum(moved[s]["seconds"] for s in stages)


def stage_pass_share(rec, *stages: str):
    """Σ of the rollup's `stages` over Σ `gc --dedup` pass seconds, in %."""
    part = _seconds(rec, stages)
    total = sum(p["seconds"] for p in rec["window"].get("passes") or [])
    if part is None or total <= 0:
        return None
    return 100.0 * part / total


def stage_window_share(rec, stage: str):
    """The rollup's `stage` seconds over the window's seconds, in %."""
    part = _seconds(rec, (stage,))
    window_s = rec["window"].get("window_s", 0)
    if part is None or window_s <= 0:
        return None
    return 100.0 * part / window_s


def stage_mean_ms(rec, stage: str):
    """The mean of one observation of the rollup's `stage`, in ms."""
    moved = rec["stages"].get(stage)
    if moved is None or moved["count"] <= 0:
        return None
    return moved["seconds"] * 1e3 / moved["count"]
