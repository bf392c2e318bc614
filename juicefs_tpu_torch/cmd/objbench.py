"""`objbench`: object-storage functional test + micro-benchmark (a copy of
juicefs_tpu/cmd/objbench.py; reference cmd/objbench.go:43-900).

Runs the API correctness suite (put/get/range/head/delete/list/multipart
when supported) then measures put/get throughput with a worker pool.

`--hash-backend` fingerprints every big object in the put path through a
`BlockIndexer` with no meta (it keeps the digests in memory): tpu, xla
and pallas hash on the CUDA card and fail without one, cpu hashes on the
host, and "" (the default) hashes nothing, since objbench has no volume.
"""

from __future__ import annotations

import json
import os
import time

from ..object import create_storage
from ..object.interface import NotFoundError
from ..qos import IOClass, global_scheduler


def add_parser(sub):
    p = sub.add_parser("objbench", help="test + benchmark an object store")
    p.add_argument("storage_uri", help="e.g. file:///tmp/blobs, mem://")
    p.add_argument("--block-size", type=int, default=4, help="MiB per object")
    p.add_argument("--big-object-size", type=int, default=64, help="total MiB")
    p.add_argument("--small-objects", type=int, default=64)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--compress", default="", choices=["", "none", "lz4", "zstd"],
                   help="compress each object in the put path")
    p.add_argument("--hash-backend", default="",
                   help="cpu|xla|pallas: fingerprint each block in the put "
                        "path and report hash MiB/s (tpu, xla and pallas "
                        "hash on the CUDA card)")
    p.set_defaults(func=run)


def functional(store) -> list[str]:
    failures = []

    def check(name, cond):
        if not cond:
            failures.append(name)

    key = "objbench/probe"
    store.put(key, b"hello world")
    check("get", bytes(store.get(key)) == b"hello world")
    check("ranged get", bytes(store.get(key, 6, 5)) == b"world")
    check("head size", store.head(key).size == 11)
    check("list", any(o.key == key for o in store.list_all("objbench/")))
    store.put(key, b"")
    check("empty object", bytes(store.get(key)) == b"")
    # multipart API, when the store supports it (reference objbench.go
    # functional suite covers UploadPart/CompleteUpload). "Unsupported" is
    # signalled by returning None; a RAISING create is a real failure.
    up = store.create_multipart_upload(key + ".mp")
    if up is not None:
        parts = [
            store.upload_part(key + ".mp", up.upload_id, i + 1,
                              bytes([i]) * max(up.min_part_size, 1024))
            for i in range(3)
        ]
        store.complete_upload(key + ".mp", up.upload_id, parts)
        want = b"".join(
            bytes([i]) * max(up.min_part_size, 1024) for i in range(3)
        )
        check("multipart", bytes(store.get(key + ".mp")) == want)
        store.delete(key + ".mp")
        up2 = store.create_multipart_upload(key + ".mp2")
        part = store.upload_part(key + ".mp2", up2.upload_id, 1, b"x" * 1024)
        store.abort_upload(key + ".mp2", up2.upload_id)
        # the abort must actually discard the upload: completing it
        # afterwards has to fail, and no object may appear
        try:
            store.complete_upload(key + ".mp2", up2.upload_id, [part])
            aborted = False
        except Exception:
            aborted = True
        try:
            store.get(key + ".mp2")
            exists = True
        except Exception:
            exists = False
        check("multipart abort", aborted and not exists)
    store.delete(key)
    try:
        store.get(key)
        check("get-after-delete", False)
    except NotFoundError:
        pass
    try:
        store.delete(key)  # idempotent delete
    except Exception:
        failures.append("delete-idempotent")
    return failures


def run(args) -> int:
    from ..object.resilient import RetryPolicy, resilient

    # the resilience wrapper is part of every production stack, so the
    # benchmark measures through it (hedging off: a benchmark must not
    # double its own GETs; single attempt: retries would hide tail cost)
    store = resilient(create_storage(args.storage_uri),
                      policy=RetryPolicy(max_attempts=1), hedge=False)
    store.create()
    failures = functional(store)
    if failures:
        print(f"FUNCTIONAL FAILURES: {failures}")
    else:
        print("functional: all checks passed")

    bs = args.block_size << 20
    n = max(1, (args.big_object_size << 20) // bs)
    keys = [f"objbench/big/{i}" for i in range(n)]
    # distinct payloads: identical blocks would make compression and the
    # dedup-style hash stream unrealistically cheap; generated per put so
    # the 10 GiB config never holds the data set in memory
    seed = os.urandom(bs)

    def payload(i: int) -> bytes:
        r = i % bs
        return seed[r:] + seed[:r]

    compressor = None
    if args.compress and args.compress != "none":
        from ..compress import new_compressor

        compressor = new_compressor(args.compress)
    indexer = None
    if args.hash_backend:
        from ..chunk.indexer import BlockIndexer, pipeline_backend

        indexer = BlockIndexer(
            meta=None, backend=pipeline_backend(args.hash_backend), block_size=bs
        )

    def put_one(item):
        """The full write-path block pipeline: fingerprint -> compress ->
        PUT (role-match to chunk/cached_store._put_block)."""
        i, k = item
        data = payload(i)
        if indexer is not None:
            indexer.submit_raw(0, i, bs, data)
        if compressor is not None:
            data = compressor.compress(data)
        store.put(k, data)

    def get_one(k):
        data = bytes(store.get(k))
        if compressor is not None:
            data = compressor.decompress(data, bs)
        return len(data)

    # BACKGROUND class on the scheduler's bulk lane: the bench
    # measures the shaped, scheduled object plane — the same path real
    # bulk traffic takes
    with global_scheduler().executor(
        "bulk", IOClass.BACKGROUND, width=args.threads
    ) as pool:
        t0 = time.perf_counter()
        list(pool.map(put_one, enumerate(keys)))
        if indexer is not None:
            indexer.flush()
        put_dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        list(pool.map(get_one, keys))
        get_dt = time.perf_counter() - t0
        list(pool.map(store.delete, keys))

    small = os.urandom(128 << 10)
    skeys = [f"objbench/small/{i}" for i in range(args.small_objects)]
    with global_scheduler().executor(
        "bulk", IOClass.BACKGROUND, width=args.threads
    ) as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda k: store.put(k, small), skeys))
        sput_dt = time.perf_counter() - t0
        list(pool.map(store.delete, skeys))

    result = {
        "put_MiB_s": round(n * bs / (1 << 20) / put_dt, 2),
        "get_MiB_s": round(n * bs / (1 << 20) / get_dt, 2),
        "small_put_objs_s": round(len(skeys) / sput_dt, 1),
        "functional_failures": failures,
    }
    if args.compress and args.compress != "none":
        result["compress"] = args.compress
    if indexer is not None:
        result["hash"] = indexer.stats()
        indexer.close()
    print(json.dumps(result))
    return 1 if failures else 0
