"""`gc --dedup` scan passes over a volume PUT at set-up.

The volume is `live_blocks` full blocks and one ragged tail block, a
fixed share of them drawn from a pool of `dup_pool` blocks (traffic
`dup_share`), all PUT straight into the object store at set-up. Each pass
in the window first deletes index rows (`reset`: "all" rows, or "fifth":
a seeded fifth, a different one each pass of five), then runs the port's
`cmd.gc.dedup_scan` with the command's thread count, which reads back and
hashes on the card every block the index lacks and backfills its row.
Passes repeat until the window's time is up; the window closes when the
pass in flight ends. `scan_gibs` is the live bytes of every pass over the
window's seconds, resets included; `scan_card_ms_per_gib` and
`scan_kernel_ms_per_gib` divide the card's busy time and its kernels'
time in the window by the same bytes.

Set-up runs one whole cold pass, which builds and loads the kernels and
fills the index. `check` holds every pass's counts to the plan, every
index row's presence, the duplicate groups the rows make to the plan's,
and a seeded sample of rows (the tail and each pool block among them) to
the frozen reference's digests.
"""

from __future__ import annotations

import time

import numpy as np

from .. import data
from ..devtrace import span
from ..reference import jth256 as ref
from ..reference.verdicts import verdicts
from ..volume import close_meta, open_volume

SAMPLE = 256  # index rows compared digest for digest with the reference


def setup(ctx) -> dict:
    from juicefs_tpu_torch.chunk.cached_store import block_key
    from juicefs_tpu_torch.chunk.indexer import pipeline_backend

    cfg, tr = ctx.config, ctx.traffic
    bs = cfg["block_size_kib"] * 1024
    plan = data.volume_plan(ctx.seed, cfg["live_blocks"], bs, cfg["tail_bytes"],
                            tr["dup_share"], tr["dup_pool"])
    contents = data.Contents(ctx.buffer, bs, tr["dup_pool"], tr["stride_bytes"])
    meta, fmt, store, args = open_volume(cfg, ctx.workdir, with_indexer=False)
    blocks = [contents.block(cid, size) for cid, size in plan]
    keys = [block_key(1000 + i, 0, len(b)) for i, b in enumerate(blocks)]
    for key, b in zip(keys, blocks):
        store.storage.put(key, b)
    st = {
        "meta": meta, "store": store, "plan": plan, "contents": contents,
        "keys": keys, "live": {k: len(b) for k, b in zip(keys, blocks)},
        "pairs": [(1000 + i, 0) for i in range(len(keys))],
        "planted": data.planted_duplicates(blocks),
        "backend": pipeline_backend(args.hash_backend or fmt.hash_backend or "cuda"),
        "threads": args.threads, "bs": bs,
        "reset": tr["reset"], "passes": [], "failed": 0,
        "rng": np.random.default_rng(data.seed_key(ctx.seed, 3)),
    }
    del blocks
    st["passes"].append(_pass(st, reset=False))  # cold: builds, loads, fills
    st["passes"][0]["warmup"] = True
    return st


def _fifths(st) -> list[list[tuple[int, int]]]:
    order = st["rng"].permutation(len(st["pairs"]))
    return [[st["pairs"][i] for i in order[k::5]] for k in range(5)]


def _reset(st) -> int:
    """Delete this pass's index rows; returns how many the pass must hash."""
    if st["reset"] == "all":
        rows = st["pairs"]
    else:
        if not st.get("fifths") or st["next_fifth"] == 5:
            st["fifths"], st["next_fifth"] = _fifths(st), 0
        rows = st["fifths"][st["next_fifth"]]
        st["next_fifth"] += 1
    st["meta"].delete_block_digests(rows)
    return len(rows)


def _pass(st, reset: bool = True) -> dict:
    from juicefs_tpu_torch.cmd.gc import dedup_scan

    with span("portbench.gc.reset"):
        expect = _reset(st) if reset else len(st["pairs"])
    with span("portbench.gc.dedup_scan"):
        r = dedup_scan(st["meta"], st["store"], st["live"], st["backend"], "", st["bs"],
                       threads=st["threads"])
    return {"expect_hashed": expect, "hashed_now": r["hashed_now"], "blocks": r["blocks"],
            "bytes": r["bytes"], "duplicate_blocks": r["duplicate_blocks"],
            "seconds": r["seconds"], "stage_seconds": r["stage_seconds"]}


def window(st, ctx, trace) -> dict:
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    # the traced sub-window: the passes from a quarter of the window on,
    # until the first pass that ends past three quarters
    t_on, t_off = t0 + ctx.seconds / 4, t0 + 3 * ctx.seconds / 4
    passes = []
    while not passes or time.perf_counter() < deadline:
        if time.perf_counter() >= t_on or ctx.seconds < 4:
            trace.start()
        try:
            passes.append(_pass(st))
        except Exception as e:  # a failed pass is counted and reported
            st["failed"] += 1
            print(f"gc pass failed: {e!r}", file=ctx.err)
            break
        if trace.running and time.perf_counter() >= t_off:
            trace.stop()
    elapsed = time.perf_counter() - t0
    st["passes"].extend(passes)
    live_bytes = sum(st["live"].values())
    return {
        "metrics": {"scan_gibs": {"value": live_bytes * len(passes) / (1 << 30) / elapsed,
                                  "unit": "GiB/s"}},
        "card_work": {"scan_card_ms_per_gib": ("busy", live_bytes * len(passes)),
                      "scan_kernel_ms_per_gib": ("kernels", live_bytes * len(passes))},
        "attempted": len(passes) + st["failed"], "failed": st["failed"],
        "window_s": elapsed, "passes": passes,
    }


def check(st, ctx) -> list[tuple[str, float, float]]:
    from juicefs_tpu_torch.chunk.cached_store import block_key

    plan, keys = st["plan"], st["keys"]
    bad_passes = sum(p["hashed_now"] != p["expect_hashed"] or p["blocks"] != len(keys)
                     or p["duplicate_blocks"] != st["planted"] for p in st["passes"])
    rows = {block_key(sid, indx, bsize): d
            for sid, indx, bsize, d in st["meta"].scan_block_digests()}
    missing = sum(k not in rows for k in keys)
    # duplicate groups: the rows' digests against the plan's content ids
    cids = [cid for cid, _ in plan]
    want = verdicts(cids)
    got = verdicts([rows.get(k, ("missing", i)) for i, k in enumerate(keys)])
    verdict_errors = sum(a != b for a, b in zip(want, got))
    # digests: a seeded sample, with the tail and the first of each pool block
    rng = np.random.default_rng(data.seed_key(ctx.seed, 4))
    firsts = {cid: i for i, cid in reversed(list(enumerate(cids))) if cid < 0}
    n = min(len(keys), ctx.sample or SAMPLE)
    picked = sorted(set(int(i) for i in rng.choice(len(keys), n, replace=False))
                    | {len(keys) - 1} | set(firsts.values()))
    contents = st["contents"]
    want_d = ref.digests([contents.block(*plan[i]) for i in picked])
    digest_errors = sum(rows.get(keys[i]) != d for i, d in zip(picked, want_d))
    return [("bad_passes", bad_passes, 0), ("rows_missing", missing, 0),
            ("verdict_errors", verdict_errors, 0), ("digest_errors", digest_errors, 0),
            ("failed_passes", st["failed"], 0)]


def close(st) -> None:
    st["store"].close()
    close_meta(st["meta"])
