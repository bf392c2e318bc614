"""Internal virtual files (a copy of juicefs_tpu/vfs/internal.py; reference
pkg/vfs/internal.go:78-105).

Six virtual inodes live at the volume root, invisible to readdir:

  .control    write a JSON command, read back streamed JSON result
              (reference writes binary op+args and reads progress
              frames, internal.go:294 handleInternalMsg — same protocol
              role, JSON encoding). Ops: info, summary, rmr, warmup,
              compact, clone.
  .accesslog  live op trace; lines materialize only while open
  .trace      live span-event stream (JSON lines, metric/trace.py);
              spans materialize only while open, like .accesslog
  .stats      point-in-time Prometheus text dump of the registry
  .config     the volume's runtime VFSConfig + Format as JSON
  .status     object-plane health JSON: breaker state / degradation
              ladder rung, retry/hedge/abandon counters, staging backlog
              (object/resilient.py; surfaced by `juicefs status`)

Inode numbers sit at the top of the 31-bit space like the reference's
(internal.go MinInternalNode), far above allocated inodes.
"""

from __future__ import annotations

import errno as _errno
import json
import time

from ..meta.context import Context
from ..meta.types import Attr, TYPE_FILE
from ..metric.trace import global_tracer

CONTROL_INO = 0x7FFFFFFF
LOG_INO = 0x7FFFFFFE
STATS_INO = 0x7FFFFFFD
CONFIG_INO = 0x7FFFFFFC
TRACE_INO = 0x7FFFFFFB
STATUS_INO = 0x7FFFFFFA
MIN_INTERNAL_INO = STATUS_INO

INTERNAL_NAMES = {
    b".control": CONTROL_INO,
    b".accesslog": LOG_INO,
    b".stats": STATS_INO,
    b".config": CONFIG_INO,
    b".trace": TRACE_INO,
    b".status": STATUS_INO,
}


# Advertised length of the virtual files. The reference reports 0 and
# relies on FOPEN_DIRECT_IO to keep the kernel reading past "EOF", but
# some kernels (gVisor-style 4.4 emulation) ignore the flag and clamp
# reads at i_size — making every virtual file read empty. A modest fake
# length keeps both behaviors working: direct-io kernels ignore it,
# clamping kernels keep issuing reads (a stream reader there gets at most
# this many bytes per open). Kept small enough that a buffered read()
# sizing its buffer from st_size stays cheap.
STREAM_LENGTH = 4 << 20


def internal_attr(ino: int) -> Attr:
    now = int(time.time())
    return Attr(
        typ=TYPE_FILE, mode=0o400 if ino != CONTROL_INO else 0o600,
        uid=0, gid=0, nlink=1, length=STREAM_LENGTH,
        atime=now, mtime=now, ctime=now, full=True,
    )


def is_internal(ino: int) -> bool:
    return ino >= MIN_INTERNAL_INO


class ControlHandler:
    """Executes .control commands against the live mount
    (reference internal.go handleInternalMsg; consumed by info/rmr/
    warmup/compact/clone CLIs through the mounted fs)."""

    def __init__(self, vfs):
        self.vfs = vfs

    def handle(self, ctx: Context, cmd: dict) -> dict:
        op = cmd.get("op", "")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            return {"errno": _errno.EINVAL, "error": f"unknown op {op!r}"}
        try:
            return fn(ctx, cmd)
        except Exception as e:  # never kill the mount from a control op
            return {"errno": _errno.EIO, "error": str(e)}

    def _op_info(self, ctx, cmd):
        ino = int(cmd["inode"])
        st, attr = self.vfs.meta.getattr(ctx, ino)
        if st:
            return {"errno": st}
        out = {
            "errno": 0, "inode": ino, "type": attr.typ, "length": attr.length,
            "nlink": attr.nlink, "paths": self.vfs.meta.get_paths(ino),
        }
        if attr.typ == TYPE_FILE:
            from ..meta.types import CHUNK_SIZE

            chunks = []
            for indx in range((attr.length + CHUNK_SIZE - 1) // CHUNK_SIZE):
                st, slices = self.vfs.meta.read_chunk(ino, indx)
                if st == 0:
                    chunks.append([
                        [s.pos, s.id, s.size, s.off, s.len] for s in slices
                    ])
            out["chunks"] = chunks
        return out

    def _op_summary(self, ctx, cmd):
        st, s = self.vfs.meta.summary(ctx, int(cmd["inode"]))
        if st:
            return {"errno": st}
        return {"errno": 0, "files": s.files, "dirs": s.dirs,
                "length": s.length, "size": s.size}

    def _op_rmr(self, ctx, cmd):
        st, removed = self.vfs.meta.remove_recursive(
            ctx, int(cmd["parent"]), cmd["name"].encode(),
            skip_trash=bool(cmd.get("skip_trash")),
        )
        # bulk namespace change bypassed the per-op invalidation hooks
        self.vfs.cache.clear()
        return {"errno": st, "removed": removed}

    def _op_warmup(self, ctx, cmd):
        from ..meta.types import CHUNK_SIZE

        ino = int(cmd["inode"])
        st, attr = self.vfs.meta.getattr(ctx, ino)
        if st:
            return {"errno": st}
        slices = 0
        for indx in range((attr.length + CHUNK_SIZE - 1) // CHUNK_SIZE):
            st, slcs = self.vfs.meta.read_chunk(ino, indx)
            for s in slcs:
                if s.id:
                    self.vfs.store.fill_cache(s.id, s.size)
                    slices += 1
        return {"errno": 0, "slices": slices}

    def _op_compact(self, ctx, cmd):
        from ..meta.types import CHUNK_SIZE
        from .compact import compact_chunk

        ino = int(cmd["inode"])
        st, attr = self.vfs.meta.getattr(ctx, ino)
        if st:
            return {"errno": st}
        done = 0
        for indx in range((attr.length + CHUNK_SIZE - 1) // CHUNK_SIZE):
            if compact_chunk(self.vfs.meta, self.vfs.store, ino, indx):
                done += 1
        return {"errno": 0, "compacted": done}

    def _op_epoch_plan(self, ctx, cmd):
        """Dataset-manifest epoch hint: the training
        loader knows its exact shard order for the next epoch, so it
        hands the reader's sequential-EOF hook a precise next-shard plan
        instead of the name-order readdir guess.

            {"op": "epoch_plan", "dir": <dir inode>,
             "shards": ["shard-007", "shard-002", ...]}   # epoch order

        Each shard's EOF then warms its successor in THIS list (the last
        wraps to the first — the next epoch's opening shard).  An empty
        list clears the plan and restores the readdir guess."""
        names = [n.encode() if isinstance(n, str) else bytes(n)
                 for n in cmd.get("shards", [])]
        if not names:
            self.vfs.reader.set_epoch_plan({})
            return {"errno": 0, "planned": 0}
        dir_ino = int(cmd.get("dir", 1))
        inos = []
        for nm in names:
            st, ino, _ = self.vfs.meta.lookup(ctx, dir_ino, nm)
            if st:
                return {"errno": st,
                        "error": f"shard {nm.decode(errors='replace')!r} "
                                 "not found"}
            inos.append(ino)
        plan = {inos[i]: inos[(i + 1) % len(inos)] for i in range(len(inos))}
        self.vfs.reader.set_epoch_plan(plan)
        return {"errno": 0, "planned": len(plan)}

    def _op_clone(self, ctx, cmd):
        if not hasattr(self.vfs.meta, "clone"):
            return {"errno": _errno.ENOSYS}
        st, new_ino = self.vfs.meta.clone(
            ctx, int(cmd["inode"]), int(cmd["parent"]), cmd["name"].encode()
        )
        if st == 0:
            self.vfs.cache.invalidate_attr(int(cmd["parent"]))
        return {"errno": st, "inode": new_ino}


class InternalFiles:
    """Open-handle state for the virtual files."""

    def __init__(self, vfs):
        self.vfs = vfs
        self.control = ControlHandler(vfs)
        self._bufs: dict[int, bytes] = {}  # fh -> pending read data

    def lookup(self, name: bytes):
        ino = INTERNAL_NAMES.get(name)
        if ino is None:
            return None
        return ino, internal_attr(ino)

    def open(self, ino: int, fh: int) -> None:
        if ino == LOG_INO:
            self.vfs.accesslog.open_reader(fh)
        elif ino == TRACE_INO:
            # the tracer is process-global: key the reader by this mount
            # too, so two mounts' fh counters cannot collide
            global_tracer().open_reader((id(self), fh))
        elif ino == STATS_INO:
            from ..metric import global_registry

            self._bufs[fh] = global_registry().render().encode()
        elif ino == CONFIG_INO:
            conf = {
                "readonly": self.vfs.conf.readonly,
                "max_readahead": self.vfs.conf.max_readahead,
                "attr_timeout": self.vfs.conf.attr_timeout,
            }
            if self.vfs.fmt is not None:
                conf["format"] = json.loads(self.vfs.fmt.remove_secret().to_json())
            self._bufs[fh] = json.dumps(conf, indent=2).encode()
        elif ino == STATUS_INO:
            self._bufs[fh] = json.dumps(self._status_payload(), indent=2,
                                        default=str).encode()
        else:
            self._bufs[fh] = b""

    def _status_payload(self) -> dict:
        """Object-plane health for `.status` / `juicefs status`: which
        ladder rung the mount is on, breaker state, resilience activity,
        and the writeback/degraded staging backlog."""
        from ..object.resilient import resilience_snapshot

        from ..chunk.cached_store import _staged_len

        store = self.vfs.store
        health = getattr(store.storage, "health", None)
        with store._pending_lock:
            staged_blocks = len(store._pending_staged)
            # entries past the RAM cap are spilled refs, not bytes
            staged_bytes = sum(_staged_len(v)
                               for v in store._pending_staged.values())
            staged_mem = store._staged_mem
        out = {
            "object_plane": health() if callable(health) else {
                "resilient": False},
            "degraded": bool(getattr(store, "degraded", False)),
            "staging": {"blocks": staged_blocks, "bytes": staged_bytes,
                        "mem_bytes": staged_mem},
            "resilience_counters": resilience_snapshot(),
        }
        group = getattr(store, "cache_group", None)
        if group is not None:
            # ring membership + per-peer breaker state
            out["cache_group"] = group.health()
        # epoch-streaming read path: live window/streaming
        # state plus the prefetch used/issued effectiveness counters
        reader = getattr(self.vfs, "reader", None)
        if reader is not None:
            out["readahead"] = reader.stats()
        # checkpoint write plane: group-commit batching state —
        # queue depth, drains vs batched mutations, sticky deferred errors
        meta = getattr(self.vfs, "meta", None)
        wb = getattr(meta, "wbatch", None)
        if wb is not None:
            out["wbatch"] = wb.stats()
        # meta-plane fault contract: breaker state + probe
        # age, stale-served count, replica role — the meta twin of the
        # object_plane snapshot above (a blackout must be OBSERVABLE
        # here, not just inferable from EIOs)
        res = getattr(meta, "resilience", None)
        if res is not None:
            mp = res.health()
            if mp.get("enabled"):
                mp["lease"] = meta.lease.stats()
                mp["session"] = {"sid": meta.sid,
                                 "beat_failures": meta._beat_failures}
            out["meta_plane"] = mp
        # gateway serving plane: admission gate occupancy,
        # shed count, per-tenant request rates, streaming-buffer bounds —
        # present only when a gateway adapter serves this vfs
        try:
            from ..gateway.serve import status_for

            gw = status_for(self.vfs)
            if gw is not None:
                out["gateway"] = gw
        except Exception:
            pass  # a torn-down adapter must never break a status read
        # unified I/O scheduler + bandwidth budget: lane/queue
        # occupancy per class and token-bucket levels
        sched = getattr(store, "scheduler", None)
        if sched is not None:
            out["qos"] = sched.snapshot()
        limiter = getattr(store, "limiter", None)
        if limiter is not None:
            out.setdefault("qos", {})["limiter"] = limiter.snapshot()
        return out

    def read(self, ino: int, fh: int, off: int, size: int) -> tuple[int, bytes]:
        if ino == LOG_INO:
            return 0, self.vfs.accesslog.read(fh, size)
        if ino == TRACE_INO:
            return 0, global_tracer().read((id(self), fh), size)
        buf = self._bufs.get(fh, b"")
        return 0, buf[off : off + size]

    def write(self, ctx: Context, ino: int, fh: int, data: bytes) -> int:
        if ino != CONTROL_INO:
            return _errno.EACCES
        try:
            # bytes() first: the FUSE path delivers memoryviews, which
            # json.loads rejects with TypeError
            cmd = json.loads(bytes(data))
        except (ValueError, TypeError):
            return _errno.EINVAL
        result = self.control.handle(ctx, cmd)
        self._bufs[fh] = json.dumps(result).encode()
        return 0

    def release(self, ino: int, fh: int) -> None:
        if ino == LOG_INO:
            self.vfs.accesslog.close_reader(fh)
        elif ino == TRACE_INO:
            global_tracer().close_reader((id(self), fh))
        self._bufs.pop(fh, None)
