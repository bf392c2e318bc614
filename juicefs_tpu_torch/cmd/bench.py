"""`bench`: filesystem micro-benchmark (a copy of juicefs_tpu/cmd/bench.py;
reference cmd/bench.go:35-330).

Big-file sequential write/read, small-file write/read, and stat rounds
against a mounted path (any mount — ours or a foreign fs), reporting
MiB/s and files/s like the reference's pretty table.
"""

from __future__ import annotations

import json
import os
import shutil
import time


def add_parser(sub):
    p = sub.add_parser("bench", help="benchmark a mounted file system")
    p.add_argument("path", help="directory on the mounted volume")
    p.add_argument("--big-file-size", type=int, default=128, help="MiB")
    p.add_argument("--small-file-size", type=int, default=128, help="KiB")
    p.add_argument("--small-file-count", type=int, default=100)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--json", action="store_true")
    p.set_defaults(func=run)


def _timeit(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def run(args) -> int:
    base = os.path.join(args.path, f"__bench_{os.getpid()}")
    os.makedirs(base, exist_ok=True)
    results = {}
    try:
        big = os.path.join(base, "bigfile")
        size = args.big_file_size << 20
        buf = os.urandom(1 << 20)

        def write_big():
            with open(big, "wb") as f:
                for _ in range(args.big_file_size):
                    f.write(buf)
                f.flush()
                os.fsync(f.fileno())

        dt = _timeit(write_big)
        results["big_write_MiB_s"] = round(size / (1 << 20) / dt, 2)

        def read_big():
            with open(big, "rb") as f:
                while f.read(1 << 20):
                    pass

        dt = _timeit(read_big)
        results["big_read_MiB_s"] = round(size / (1 << 20) / dt, 2)

        small = os.urandom(args.small_file_size << 10)
        names = [os.path.join(base, f"small_{i}") for i in range(args.small_file_count)]

        def write_small():
            for n in names:
                with open(n, "wb") as f:
                    f.write(small)

        dt = _timeit(write_small)
        results["small_write_files_s"] = round(len(names) / dt, 1)

        def read_small():
            for n in names:
                with open(n, "rb") as f:
                    f.read()

        dt = _timeit(read_small)
        results["small_read_files_s"] = round(len(names) / dt, 1)

        def stat_files():
            for n in names:
                os.stat(n)

        dt = _timeit(stat_files)
        results["stat_files_s"] = round(len(names) / dt, 1)
    finally:
        shutil.rmtree(base, ignore_errors=True)

    if args.json:
        print(json.dumps(results))
    else:
        width = max(len(k) for k in results)
        for k, v in results.items():
            print(f"  {k:<{width}} : {v}")
    return 0
