"""`quota` / `mdtest` (a copy of juicefs_tpu/cmd/quota.py; reference
cmd/quota.go, cmd/mdtest.go).

quota: set/get/delete/list directory quotas (space/inode limits with
usage tracked transactionally up the ancestor chain).
mdtest: built-in metadata benchmark — tree create/stat/readdir/unlink
rates straight against the meta engine (reference mdtest.go:100,145).
"""

from __future__ import annotations

import json
import time

from ..meta.context import BACKGROUND
from ..utils import get_logger

logger = get_logger("cmd.quota")


def add_parser(sub):
    q = sub.add_parser("quota", help="manage directory quotas")
    q.add_argument("action", choices=["set", "get", "del", "list", "check"])
    q.add_argument("meta_url")
    q.add_argument("path", nargs="?", default="")
    q.add_argument("--space", type=float, default=0, help="space limit GiB (0=unlimited)")
    q.add_argument("--inodes", type=int, default=0, help="inode limit (0=unlimited)")
    q.add_argument("--repair", action="store_true",
                   help="with 'check': write recomputed usage back")
    q.set_defaults(func=run_quota)

    m = sub.add_parser("mdtest", help="metadata micro-benchmark")
    m.add_argument("meta_url")
    m.add_argument("--dirs", type=int, default=10)
    m.add_argument("--files", type=int, default=100, help="files per dir")
    m.add_argument("--via-vfs", action="store_true",
                   help="also measure stat rate through the VFS attr cache")
    m.set_defaults(func=run_mdtest)


def run_quota(args) -> int:
    from . import open_meta

    m, fmt = open_meta(args.meta_url)
    if args.action == "list":
        quotas = m.list_dir_quotas()
        for ino, (sl, il, us, ui) in sorted(quotas.items()):
            paths = m.get_paths(ino)
            print(json.dumps({
                "inode": ino, "path": paths[0] if paths else "?",
                "space_limit": sl, "inode_limit": il,
                "used_space": us, "used_inodes": ui,
            }))
        return 0

    st, ino, attr = m.resolve(BACKGROUND, args.path or "/")
    if st:
        print(f"resolve {args.path}: errno {st}")
        return 1
    if args.action == "set":
        st = m.set_dir_quota(
            BACKGROUND, ino, int(args.space * (1 << 30)), args.inodes
        )
        if st:
            print(f"set quota: errno {st}")
            return 1
        print(f"quota set on {args.path}")
    elif args.action == "check":
        # recompute true usage; --repair heals hint-window drift. EAGAIN =
        # usage changed during the walk; retry a few times.
        import errno as _errno

        for _ in range(5):
            st, stored, actual = m.check_dir_quota(BACKGROUND, ino, args.repair)
            if st != _errno.EAGAIN:
                break
        if st:
            print(f"check quota: errno {st}")
            return 1
        drifted = stored != actual
        print(json.dumps({
            "path": args.path,
            "stored_space": stored[0], "stored_inodes": stored[1],
            "actual_space": actual[0], "actual_inodes": actual[1],
            "drifted": drifted, "repaired": bool(args.repair and drifted),
        }))
        return 1 if (drifted and not args.repair) else 0
    elif args.action == "get":
        rec = m.get_dir_quota(ino)
        if rec is None:
            print(f"no quota on {args.path}")
            return 1
        sl, il, us, ui = rec
        print(json.dumps({
            "path": args.path, "space_limit": sl, "inode_limit": il,
            "used_space": us, "used_inodes": ui,
            "space_pct": round(us / sl * 100, 1) if sl else 0,
        }))
    elif args.action == "del":
        m.del_dir_quota(ino)
        print(f"quota removed from {args.path}")
    return 0


def run_mdtest(args) -> int:
    from ..meta.types import ROOT_INODE
    from . import open_meta

    m, fmt = open_meta(args.meta_url)
    m.new_session()
    base_name = f"__mdtest_{int(time.time())}".encode()
    st, base, _ = m.mkdir(BACKGROUND, ROOT_INODE, base_name, 0o755)
    if st:
        print(f"mkdir: errno {st}")
        return 1
    results = {}

    t0 = time.perf_counter()
    dirs = []
    for d in range(args.dirs):
        st, dino, _ = m.mkdir(BACKGROUND, base, f"d{d}".encode(), 0o755)
        dirs.append(dino)
    results["dir_create_per_s"] = round(args.dirs / (time.perf_counter() - t0), 1)

    t0 = time.perf_counter()
    inos = []
    for dino in dirs:
        for f in range(args.files):
            st, ino, _ = m.create(BACKGROUND, dino, f"f{f}".encode(), 0o644)
            inos.append(ino)
            m.close(BACKGROUND, ino)
    n = len(inos)
    results["file_create_per_s"] = round(n / (time.perf_counter() - t0), 1)

    t0 = time.perf_counter()
    for ino in inos:
        m.getattr(BACKGROUND, ino)
    results["file_stat_per_s"] = round(n / (time.perf_counter() - t0), 1)

    if getattr(args, "via_vfs", False):
        # Same stats through the VFS entry/attr TTL cache:
        # cold pass pays the meta RTT and populates; warm pass shows the
        # cached rate kernels/gateways see on repeated stats.
        from ..chunk import CachedStore, ChunkConfig
        from ..object import create_storage
        from ..vfs import VFS, VFSConfig

        # the store only backs the VFS and never moves a block: it
        # stays on the host, so mdtest needs no card
        v = VFS(m, CachedStore(create_storage("mem://"),
                               ChunkConfig(compress_backend="cpu", device="cpu")),
                VFSConfig(attr_timeout=5.0, entry_timeout=5.0))
        t0 = time.perf_counter()
        for ino in inos:
            v.getattr(BACKGROUND, ino)
        results["vfs_stat_cold_per_s"] = round(n / (time.perf_counter() - t0), 1)
        t0 = time.perf_counter()
        for ino in inos:
            v.getattr(BACKGROUND, ino)
        results["vfs_stat_warm_per_s"] = round(n / (time.perf_counter() - t0), 1)

    t0 = time.perf_counter()
    for dino in dirs:
        m.readdir(BACKGROUND, dino, want_attr=True)
    results["readdir_per_s"] = round(args.dirs / (time.perf_counter() - t0), 1)

    t0 = time.perf_counter()
    for dino in dirs:
        for f in range(args.files):
            m.unlink(BACKGROUND, dino, f"f{f}".encode(), skip_trash=True)
    results["file_unlink_per_s"] = round(n / (time.perf_counter() - t0), 1)

    m.remove_recursive(BACKGROUND, ROOT_INODE, base_name, skip_trash=True)
    m.close_session()
    print(json.dumps(results))
    return 0
