"""Arithmetic shared by the per-layer metric readers in `metrics/`.

A reader gets the run's records, `rec`:

    kind      the card's name
    window    the driver's window record (gc: `passes`, each with the
              `stage_seconds` and `seconds` dedup_scan returned; writers:
              `bytes` committed)
    stages    the stage rollup juicefs_torch_stage_seconds{layer,op,stage}
              moved over the window: {layer.op.stage: {count, seconds}},
              seconds summed over threads
    counters  the pipeline's juicefs_torch_blocks_hashed and
              juicefs_torch_hash_bytes moved over the window
    trace     the device trace of the traced sub-window (devtrace.py), or
              None when the run was not traced

and returns a number, or None when it finds nothing to read.
"""

from __future__ import annotations

from . import roofline

GIB = 1 << 30


def pass_share(rec, *stages: str):
    """Σ of dedup_scan's wall-time `stages` over Σ pass seconds, in %."""
    passes = rec["window"].get("passes") or []
    total = sum(p["seconds"] for p in passes)
    if total <= 0:
        return None
    part = sum(p["stage_seconds"][s] for p in passes for s in stages)
    return 100.0 * part / total


def stage_ms_per_gib(rec, *stages: str):
    """Thread-milliseconds of the rollup's `stages` per GiB committed."""
    moved = [rec["stages"][s] for s in stages if s in rec["stages"]]
    nbytes = rec["window"].get("bytes", 0)
    if not moved or nbytes <= 0:
        return None
    return sum(m["seconds"] for m in moved) * 1e3 / (nbytes / GIB)


def blocks_per_batch(rec, stage: str):
    batches = rec["stages"].get(stage, {}).get("count", 0)
    if batches <= 0:
        return None
    return rec["counters"]["blocks_hashed"] / batches


def hash_roofline(rec):
    t = rec["trace"]
    if t is None:
        return None
    return roofline.hash_roofline_pct(t["hash_bytes"], t["blocks_hashed"],
                                      t["hash_kernel_s"], rec["kind"])


def device_idle(rec):
    t = rec["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
