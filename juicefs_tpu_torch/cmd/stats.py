"""`stats` / `profile` / `debug` / `clone` / `restore` / `destroy` (a copy
of juicefs_tpu/cmd/stats.py; reference cmd/stats.go, cmd/profile.go,
cmd/debug.go, cmd/clone.go, cmd/restore.go, cmd/destroy.go).

stats/profile consume the mount's virtual files (.stats Prometheus dump,
.accesslog trace) exactly like the reference; clone goes through the
.control protocol when given a mount path, or straight to meta.

Changes from the reference: `clone MOUNTPOINT SRC DST` does go through the
mount's `.control` file (the reference's always opens meta), and `destroy`
deletes through the volume's object stack alone, so it builds no chunk
store and needs no card for a compressed or device-hashed volume.
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import defaultdict

from ..meta.context import BACKGROUND
from ..meta.types import TRASH_INODE
from ..utils import get_logger

logger = get_logger("cmd.stats")


def add_parser(sub):
    s = sub.add_parser("stats", help="show metrics of a mounted volume")
    s.add_argument("mountpoint")
    s.add_argument("--filter", default="",
                   help="regular expression matched against metric lines "
                        "(reference --filter semantics); lines without a "
                        "match are hidden")
    s.set_defaults(func=run_stats)

    p = sub.add_parser("profile", help="aggregate live op latencies from a mount")
    p.add_argument("mountpoint")
    p.add_argument("--duration", type=float, default=2.0, help="seconds to sample")
    p.add_argument("--trace", default="", metavar="DIR",
                   help="sample span events from the mount's .trace stream "
                        "instead of .accesslog and write a chrome://tracing-"
                        "loadable trace_event JSON into DIR")
    p.set_defaults(func=run_profile)

    d = sub.add_parser("debug", help="collect diagnostics from a mount")
    d.add_argument("mountpoint")
    d.add_argument("--out", default="", help="output directory (default: stdout)")
    d.set_defaults(func=run_debug)

    c = sub.add_parser("clone", help="server-side O(meta) copy")
    c.add_argument("meta_url", help="meta URL, or the mountpoint of a "
                                    "mounted volume")
    c.add_argument("src", help="volume-absolute source path")
    c.add_argument("dst", help="volume-absolute destination path")
    c.set_defaults(func=run_clone)

    r = sub.add_parser("restore", help="restore entries from trash")
    r.add_argument("meta_url")
    r.add_argument("hour", nargs="?", default="",
                   help="trash hour dir (YYYY-MM-DD-HH); default: list trash")
    r.set_defaults(func=run_restore)

    x = sub.add_parser("destroy", help="destroy a volume: all data + metadata")
    x.add_argument("meta_url")
    x.add_argument("--yes", action="store_true", help="required confirmation")
    x.set_defaults(func=run_destroy)


def run_stats(args) -> int:
    pat = None
    if args.filter:
        try:
            pat = re.compile(args.filter)
        except re.error as e:
            print(f"stats: invalid --filter regex {args.filter!r}: {e}")
            return 1
    with open(os.path.join(args.mountpoint, ".stats"), "rb") as f:
        text = f.read().decode()
    for line in text.splitlines():
        if pat is not None and not pat.search(line):
            continue
        if line and not line.startswith("#"):
            print(line)
    return 0


_LOG_RE = re.compile(r"\[uid:\d+,gid:\d+,pid:\d+\] (\w+) \(.*\): (\S+).* <([0-9.]+)>")


def open_stream(path: str) -> int:
    """Open a live virtual stream (.accesslog / .trace) uncached.

    O_DIRECT first: kernels that ignore the server's FOPEN_DIRECT_IO
    (gVisor-style FUSE) would otherwise serve a stream through the page
    cache, replaying stale pages instead of fresh lines. FUSE imposes no
    O_DIRECT alignment constraints; fall back to a plain open where
    O_DIRECT is unsupported."""
    try:
        return os.open(path, os.O_RDONLY | getattr(os, "O_DIRECT", 0))
    except OSError:
        return os.open(path, os.O_RDONLY)


# event keys that are structure, not user attrs, when converting to the
# Chrome trace_event format
_SPAN_FIELDS = ("ts", "dur", "trace", "id", "parent", "layer", "op", "stage")


def _chrome_event(ev: dict) -> dict:
    """One .trace span event -> one Chrome trace_event 'X' entry
    (loadable in chrome://tracing and Perfetto)."""
    name = str(ev.get("op", "?"))
    if ev.get("stage"):
        name += ":" + str(ev["stage"])
    args = {k: v for k, v in ev.items() if k not in _SPAN_FIELDS}
    args["span_id"] = ev.get("id", 0)
    args["parent_id"] = ev.get("parent", 0)
    return {
        "name": name,
        "cat": str(ev.get("layer", "?")),
        "ph": "X",
        "ts": float(ev.get("ts", 0.0)) * 1e6,
        "dur": max(float(ev.get("dur", 0.0)) * 1e6, 0.1),
        "pid": 1,
        "tid": int(ev.get("trace", 0)),
        "args": args,
    }


def run_trace_profile(args) -> int:
    """`profile --trace DIR`: sample the mount's .trace span stream for
    --duration seconds and write a chrome://tracing JSON into DIR."""
    events: list[dict] = []
    deadline = time.time() + args.duration
    buf = b""
    fd = open_stream(os.path.join(args.mountpoint, ".trace"))
    try:
        while time.time() < deadline:
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                # EOF (size-clamping kernel exhausted STREAM_LENGTH, or
                # unmounted): don't spin hot on instant empty reads
                time.sleep(0.05)
                continue
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if isinstance(ev, dict):
                    events.append(ev)
    finally:
        os.close(fd)
    os.makedirs(args.trace, exist_ok=True)
    path = os.path.join(args.trace, "juicefs-trace.json")
    with open(path, "w") as out:
        json.dump(
            {
                "traceEvents": [_chrome_event(ev) for ev in events],
                "displayTimeUnit": "ms",
            },
            out,
        )
    per_layer: dict[str, int] = defaultdict(int)
    for ev in events:
        per_layer[str(ev.get("layer", "?"))] += 1
    summary = ", ".join(f"{k}:{v}" for k, v in sorted(per_layer.items()))
    print(f"sampled {len(events)} spans ({summary or 'none'}) -> {path}")
    return 0


def run_profile(args) -> int:
    if getattr(args, "trace", ""):
        return run_trace_profile(args)
    stats: dict[str, list[float]] = defaultdict(list)
    deadline = time.time() + args.duration
    fd = open_stream(os.path.join(args.mountpoint, ".accesslog"))
    try:
        while time.time() < deadline:
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                time.sleep(0.05)  # EOF: see run_trace_profile
                continue
            for line in chunk.decode(errors="replace").splitlines():
                m = _LOG_RE.search(line)
                if m:
                    stats[m.group(1)].append(float(m.group(3)))
    finally:
        os.close(fd)
    print(f"{'op':<16}{'count':>8}{'avg_ms':>10}{'total_ms':>10}")
    for op, durs in sorted(stats.items(), key=lambda kv: -sum(kv[1])):
        total = sum(durs)
        print(f"{op:<16}{len(durs):>8}{total / len(durs) * 1e3:>10.3f}"
              f"{total * 1e3:>10.1f}")
    return 0


def run_debug(args) -> int:
    out = {}
    for name in (".config", ".stats"):
        try:
            with open(os.path.join(args.mountpoint, name), "rb") as f:
                out[name] = f.read().decode()
        except OSError as e:
            out[name] = f"<unreadable: {e}>"
    try:
        sv = os.statvfs(args.mountpoint)
        out["statvfs"] = {
            "blocks": sv.f_blocks, "bavail": sv.f_bavail, "files": sv.f_files,
        }
    except OSError:
        pass
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for name, content in out.items():
            with open(os.path.join(args.out, name.lstrip(".") + ".txt"), "w") as f:
                f.write(content if isinstance(content, str) else json.dumps(content))
        print(f"diagnostics written to {args.out}")
    else:
        print(json.dumps(out, indent=2)[:4000])
    return 0


def _clone_on_mount(args) -> int:
    """clone through the mount's `.control` file: write the JSON request,
    read the JSON reply back from the same handle."""
    mp = args.meta_url
    src = os.path.join(mp, args.src.lstrip("/"))
    parent_path, _, name = args.dst.rstrip("/").rpartition("/")
    parent_dir = os.path.join(mp, parent_path.lstrip("/"))
    try:
        src_ino = os.stat(src).st_ino
        parent = os.stat(parent_dir).st_ino
    except OSError as e:
        print(f"resolve: {e}")
        return 1
    fd = os.open(os.path.join(mp, ".control"), os.O_RDWR)
    try:
        os.write(fd, json.dumps({"op": "clone", "inode": src_ino,
                                 "parent": parent, "name": name}).encode())
        out = json.loads(os.pread(fd, 1 << 20, 0))
    finally:
        os.close(fd)
    if out.get("errno"):
        print(f"clone failed: errno {out['errno']}")
        return 1
    print(f"cloned {args.src} -> {args.dst} (inode {out['inode']})")
    return 0


def run_clone(args) -> int:
    from . import open_meta

    if os.path.isfile(os.path.join(args.meta_url, ".control")):
        return _clone_on_mount(args)
    m, fmt = open_meta(args.meta_url)
    if not hasattr(m, "clone"):
        print("meta engine does not support clone")
        return 1
    st, src_ino, _ = m.resolve(BACKGROUND, args.src)
    if st:
        print(f"resolve {args.src}: errno {st}")
        return 1
    parent_path, _, name = args.dst.rstrip("/").rpartition("/")
    st, parent, _ = m.resolve(BACKGROUND, parent_path or "/")
    if st:
        print(f"resolve {parent_path}: errno {st}")
        return 1
    st, new_ino = m.clone(BACKGROUND, src_ino, parent, name.encode())
    if st:
        print(f"clone failed: errno {st}")
        return 1
    print(f"cloned {args.src} -> {args.dst} (inode {new_ino})")
    return 0


def run_restore(args) -> int:
    from . import open_meta

    m, fmt = open_meta(args.meta_url)
    st, hours = m.readdir(BACKGROUND, TRASH_INODE)
    if st:
        print("no trash")
        return 0
    hours = [e for e in hours if e.name not in (b".", b"..")]
    if not args.hour:
        for e in hours:
            st, entries = m.readdir(BACKGROUND, e.inode)
            n = len([x for x in entries if x.name not in (b".", b"..")])
            print(f"{e.name.decode()}: {n} entries")
        return 0
    hour_ino = next((e.inode for e in hours if e.name.decode() == args.hour), 0)
    if not hour_ino:
        print(f"no trash dir {args.hour}")
        return 1
    st, entries = m.readdir(BACKGROUND, hour_ino)
    restored = skipped = 0
    for e in entries:
        if e.name in (b".", b".."):
            continue
        try:
            parent_s, _, orig = e.name.split(b"-", 2)
            parent = int(parent_s)
        except ValueError:
            skipped += 1
            continue
        st, _, _ = m.rename(BACKGROUND, hour_ino, e.name, parent, orig)
        if st:
            logger.warning("restore %s: errno %d", e.name.decode(), st)
            skipped += 1
        else:
            restored += 1
    print(f"restored {restored}, skipped {skipped}")
    return 0


def run_destroy(args) -> int:
    from ..object.resilient import resilient
    from . import open_meta, storage_for

    if not args.yes:
        print("refusing to destroy without --yes")
        return 1
    m, fmt = open_meta(args.meta_url)
    # every object of the volume lies under its prefix: blocks, the
    # leaders that content refs alias, and the metadata backups
    storage = resilient(storage_for(fmt))
    n = 0
    try:
        for obj in list(storage.list_all("")):
            try:
                storage.delete(obj.key)
                n += 1
            except Exception as e:
                logger.warning("delete %s: %s", obj.key, e)
    finally:
        storage.close()
    m.reset()
    print(f"destroyed volume {fmt.name}: {n} objects removed, metadata wiped")
    return 0
