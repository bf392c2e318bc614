"""`status` / `info` / `summary` / `rmr`: volume and path inspection tools
(a copy of juicefs_tpu/cmd/info.py; reference cmd/status.go, cmd/info.go,
cmd/summary.go, cmd/rmr.go)."""

from __future__ import annotations

import json

from ..meta.context import BACKGROUND
from ..meta.types import CHUNK_SIZE, TYPE_DIRECTORY


def add_parser(sub):
    s = sub.add_parser("status", help="show volume status")
    s.add_argument("meta_url")
    s.set_defaults(func=run_status)

    i = sub.add_parser("info", help="show file/dir internals")
    i.add_argument("meta_url")
    i.add_argument("path")
    i.set_defaults(func=run_info)

    m = sub.add_parser("summary", help="du-like tree summary")
    m.add_argument("meta_url")
    m.add_argument("path")
    m.set_defaults(func=run_summary)

    r = sub.add_parser("rmr", help="remove a tree recursively (server-side)")
    r.add_argument("meta_url")
    r.add_argument("path")
    r.add_argument("--skip-trash", action="store_true")
    r.set_defaults(func=run_rmr)


def run_status(args) -> int:
    from . import open_meta

    m, fmt = open_meta(args.meta_url)
    sessions = m.do_list_sessions()
    total, avail, iused, iavail = m.statfs(BACKGROUND)
    print(json.dumps({
        "format": json.loads(fmt.remove_secret().to_json()),
        "sessions": [json.loads(s.to_json()) for s in sessions],
        "used_space": total - avail,
        "inodes_used": iused,
        "object_plane": _object_plane_status(fmt),
    }, indent=2, default=str))
    return 0


def _object_plane_status(fmt) -> dict:
    """Probe the volume's storage stack once from THIS process and report
    the resilience configuration.  Deliberately NOT a breaker snapshot: a
    freshly built stack always starts CLOSED/empty, and presenting that
    as health would contradict a mount mid-outage.  Live breaker/ladder
    state belongs to the mount's `.status` internal file."""
    try:
        from ..object.interface import NotFoundError
        from ..object.resilient import resilient
        from . import storage_for

        store = resilient(storage_for(fmt))
        try:
            try:
                store._s.head(".jfs-status-probe")  # direct: one attempt
                probe = "ok"
            except NotFoundError:
                probe = "ok"
            except Exception as e:
                probe = f"unreachable: {e}"
            h = store.health()
            return {
                "backend": h["backend"],
                "probe": probe,
                "policy": h["policy"],
                "hedge": h["hedge"],
                "live_state": "read <mountpoint>/.status on an active "
                              "mount for breaker/ladder state",
            }
        finally:
            store.close()
    except Exception as e:  # status must never fail on a broken stack
        return {"error": str(e)}


def run_info(args) -> int:
    from . import open_meta

    m, fmt = open_meta(args.meta_url)
    st, ino, attr = m.resolve(BACKGROUND, args.path)
    if st:
        print(f"resolve {args.path}: errno {st}")
        return 1
    out = {
        "path": args.path,
        "inode": ino,
        "type": attr.typ,
        "mode": oct(attr.mode),
        "uid": attr.uid,
        "gid": attr.gid,
        "length": attr.length,
        "nlink": attr.nlink,
    }
    if attr.typ != TYPE_DIRECTORY:
        chunks = []
        for indx in range((attr.length + CHUNK_SIZE - 1) // CHUNK_SIZE):
            st, slices = m.read_chunk(ino, indx)
            if st == 0 and slices:
                chunks.append({
                    "index": indx,
                    "slices": [
                        {"pos": s.pos, "id": s.id, "size": s.size,
                         "off": s.off, "len": s.len}
                        for s in slices
                    ],
                })
        out["chunks"] = chunks
    print(json.dumps(out, indent=2))
    return 0


def run_summary(args) -> int:
    from . import open_meta

    m, fmt = open_meta(args.meta_url)
    st, ino, attr = m.resolve(BACKGROUND, args.path)
    if st:
        print(f"resolve {args.path}: errno {st}")
        return 1
    st, s = m.summary(BACKGROUND, ino)
    if st:
        return 1
    print(json.dumps({
        "path": args.path, "files": s.files, "dirs": s.dirs,
        "length": s.length, "size": s.size,
    }, indent=2))
    return 0


def run_rmr(args) -> int:
    from . import open_meta

    m, fmt = open_meta(args.meta_url)
    parent_path, _, name = args.path.rstrip("/").rpartition("/")
    st, parent, _ = m.resolve(BACKGROUND, parent_path or "/")
    if st:
        print(f"resolve {parent_path}: errno {st}")
        return 1
    st, removed = m.remove_recursive(
        BACKGROUND, parent, name.encode(), skip_trash=args.skip_trash
    )
    print(f"removed {removed} entries (errno {st})")
    return 0 if st == 0 else 1
