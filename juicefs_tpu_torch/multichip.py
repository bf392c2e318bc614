"""The multi-device run over a real volume: the port's twin of
__graft_entry__.py `dryrun_multichip`.

    python -m juicefs_tpu_torch.multichip [--devices cuda:0,cuda:1,...]
                                          [--gib G] [--block-mib N]

It writes a sqlite3:// + file:// volume through the port's chunk plane,
every block through an lz4 `CachedStore` with an inline-dedup
`IngestPipeline` on a sharding plane over `devices`, then wipes the
digest index and runs the cold `gc --dedup` scan (`cmd/gc.py
dedup_scan`) on the same plane, which reads every block back and hashes
it again. Three gates hold before any number is reported: the scan's
digest rows equal the rows ingest recorded, sampled rows equal the numpy
JTH-256 spec, and the duplicate count equals the duplicates planted.
Beside them, every block ingest hashed must have been estimated on the
mesh from the shared pack split over it, with no degrade. It
prints one `MULTICHIP {json}` line and returns the same dict.

`devices` takes the place of the reference's forced host device count:
None is every local card (and raises without one); a list may name one
device several times (`[cuda:0] * 4` is a 2 x 2 mesh over one card,
`[cpu] * 4` the same on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch


def dryrun_multichip(devices=None, gib: float = 0.0625, block_mib: int = 1,
                     dup_ratio: float = 0.25) -> dict:
    """Ingest then cold-scan a planned volume on a plane over `devices`;
    gate, print and return the `MULTICHIP` result."""
    from .chunk import CachedStore, ChunkConfig, ContentRefs, IngestPipeline
    from .chunk.cached_store import block_key
    from .cmd.gc import dedup_scan
    from .gpu import kernels, pipeline, sharding
    from .gpu.jth256 import jth256
    from .meta import CHUNK_SIZE, Format, Slice, new_client
    from .meta.context import Context
    from .object import create_storage

    plane = sharding.ShardPlane(devices)
    bs = block_mib << 20
    n_blocks = max(8, int(gib * (1 << 30)) // bs)
    if n_blocks % 4 == 0:
        n_blocks += 1  # ragged tail over any data axis, never aligned-only

    # plan the volume: ~dup_ratio of blocks share pool content; the expected
    # duplicate count comes from the plan, not from the scan
    rng = np.random.default_rng(7)
    dup_pool = [rng.bytes(bs) for _ in range(4)]
    blocks = [dup_pool[int(rng.integers(0, len(dup_pool)))]
              if rng.random() < dup_ratio else rng.bytes(bs)
              for _ in range(n_blocks)]
    seen_ids: set[int] = set()
    expect_dups = 0
    for b in blocks:
        expect_dups += id(b) in seen_ids  # pool entries are reused objects
        seen_ids.add(id(b))

    def kernel_launches() -> tuple[int, int]:
        """(row-chain, combine) launches so far."""
        if any(d.type == "cuda" for d in plane.devices):
            torch.cuda.synchronize()
        return kernels.LAUNCHES["jth256_row_chain"], kernels.LAUNCHES["jth256_combine"]

    def stage_launches(since: tuple[int, int]) -> tuple[int, int]:
        """(row-chain, combine) launches of a leg: a hash batch runs one
        row chain per mesh device. A lane-split mesh also runs one combine
        per data row, so the combines times the lane extent equal the row
        chains; with whole blocks on each device the combine runs in the
        row chain's epilogue and no combine kernel is launched."""
        now = kernel_launches()
        chains, combines = now[0] - since[0], now[1] - since[1]
        mesh = plane.snapshot()["mesh"]
        lanes = mesh["lane"] if mesh else 1
        if combines * lanes != (chains if lanes > 1 else 0):
            raise AssertionError(f"{chains} row-chain launches and {combines} combines on a "
                                 f"mesh of {lanes} lane shards")
        return chains, combines

    ctx = Context(uid=0, gid=0)
    base = tempfile.mkdtemp(prefix="jfs-torch-multichip-")
    fetch_threads = max(4, 2 * (os.cpu_count() or 2))
    store = None
    try:
        m = new_client(f"sqlite3://{base}/meta.db")
        m.init(Format(name="multichip", trash_days=0, block_size=bs >> 10), force=True)
        m.load()
        storage = create_storage(f"file://{base}/blob")
        storage.create()
        # the store's compress plane records the advisories the plane's
        # mesh computes as it hashes the pack ingest split over it
        store = CachedStore(storage, ChunkConfig(
            block_size=bs, compress="lz4", cache_dirs=("memory",), cache_size=1,
            max_upload=4, max_download=fetch_threads, device=plane.home))
        refs = ContentRefs(m)
        store.content_refs = refs
        store.ingest = IngestPipeline(store, refs, backend="cuda", batch_blocks=8,
                                      plane=plane)
        h2d0 = sharding._H2D_BATCHES.value

        # leg 1: inline ingest through the chunk plane (the wall includes
        # the pipeline drain)
        st, ino, _ = m.create(ctx, 1, b"data.bin", 0o644)
        if st != 0:
            raise RuntimeError(f"create: errno {st}")
        per_chunk = CHUNK_SIZE // bs
        sids: list[int] = []
        launches0 = kernel_launches()
        hashed0 = pipeline._BLOCKS_HASHED.value
        t0 = time.perf_counter()
        for i, data in enumerate(blocks):
            sid = m.new_slice()
            sids.append(sid)
            w = store.new_writer(sid)
            w.write_at(data, 0)
            w.finish(bs)
            indx, pos = divmod(i, per_chunk)
            st = m.write_chunk(ino, indx, pos * bs,
                               Slice(pos=pos * bs, id=sid, size=bs, off=0, len=bs))
            if st != 0:
                raise RuntimeError(f"write_chunk: errno {st}")
        store.ingest.flush()
        store.flush_all()
        ingest_s = time.perf_counter() - t0
        ingest_launches, ingest_combines = stage_launches(launches0)
        ing = store.ingest.stats()
        hashed = int(pipeline._BLOCKS_HASHED.value - hashed0)
        comp = store.compress_plane.stats()
        ingest_rows = {block_key(sid, indx, bsz): digest
                       for sid, indx, bsz, digest in m.scan_block_digests()}

        # the live map exactly as cmd/gc.py builds it
        live: dict[str, int] = {}
        for _ino, slcs in m.list_slices().items():
            for s in slcs:
                if s.id and s.size:
                    for j in range((s.size + bs - 1) // bs):
                        bsz = min(bs, s.size - j * bs)
                        live[block_key(s.id, j, bsz)] = bsz

        # leg 2: the gc --dedup bulk scan, cold: with the digest index
        # wiped every block is fetched back and hashed again on the plane
        stale = [(sid, indx) for sid, indx, _b, _d in m.scan_block_digests()]
        if stale:
            m.delete_block_digests(stale)
        launches0 = kernel_launches()
        scan = dedup_scan(m, store, live, "cuda", "", bs, threads=fetch_threads,
                          plane=plane)
        scan_launches, scan_combines = stage_launches(launches0)

        # the three identity gates, before any number is reported
        scan_rows = {block_key(sid, indx, bsz): digest
                     for sid, indx, bsz, digest in m.scan_block_digests()}
        if not scan["hashed_now"] == len(live) == n_blocks:
            raise AssertionError(f"scan hashed {scan['hashed_now']} of {len(live)} "
                                 f"live blocks, {n_blocks} written")
        if ingest_rows and scan_rows != ingest_rows:
            raise AssertionError("cold-scan digests diverge from ingest-time digests")
        ref_cache: dict[int, bytes] = {}
        for i in range(0, n_blocks, max(1, n_blocks // 8)):
            ref = ref_cache.setdefault(id(blocks[i]), jth256(blocks[i]))
            if scan_rows[block_key(sids[i], 0, bs)] != ref:
                raise AssertionError(f"block {i}: sharded digest != numpy spec")
        if scan["duplicate_blocks"] != expect_dups:
            raise AssertionError(f"duplicate_blocks {scan['duplicate_blocks']} "
                                 f"!= planted {expect_dups}")
        if hashed == 0 or comp["estimated"] != hashed or comp["degraded"] != 0:
            raise AssertionError(f"compress plane estimated {comp['estimated']} of "
                                 f"{hashed} hashed blocks, {comp['degraded']} degraded")

        snap = plane.snapshot()
        nbytes = n_blocks * bs
        result = {
            "schema": "multichip-torch",
            "n_devices": plane.n_devices,
            "devices": [str(d) for d in plane.devices],
            "mesh": snap["mesh"],
            "degraded": snap["degraded"],
            "volume_gib": round(nbytes / (1 << 30), 4),
            "blocks": n_blocks,
            "block_mib": block_mib,
            "dup_ratio": dup_ratio,
            "duplicate_blocks": scan["duplicate_blocks"],
            "h2d_batches": int(sharding._H2D_BATCHES.value - h2d0),
            "ingest": {
                "seconds": round(ingest_s, 3),
                "gibs": round(nbytes / (1 << 30) / ingest_s, 3),
                "put_elided": ing.get("put_elided", 0),
                "hot_hits": ing.get("hot_content", {}).get("hits", 0),
                "launches": ingest_launches,
                "combines": ingest_combines,
                "hashed": hashed,
                "estimated": comp["estimated"],
                "compress_degraded": comp["degraded"],
            },
            "scan": {
                "seconds": scan["seconds"],
                "gibs": scan["gibs"],
                "hashed_now": scan["hashed_now"],
                "fetch_window": scan["fetch_window"],
                "shard": scan.get("shard"),
                "launches": scan_launches,
                "combines": scan_combines,
            },
            "identity_ok": True,
        }
        print("MULTICHIP " + json.dumps(result), flush=True)
        return result
    finally:
        if store is not None:
            store.close()
        shutil.rmtree(base, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", default="",
                    help="comma-separated torch devices, one may repeat "
                         "(default: every local card)")
    ap.add_argument("--gib", type=float, default=0.0625)
    ap.add_argument("--block-mib", type=int, default=1)
    args = ap.parse_args(argv)
    devices = [d.strip() for d in args.devices.split(",") if d.strip()] or None
    dryrun_multichip(devices, gib=args.gib, block_mib=args.block_mib)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
