"""`sync`: bulk object copy between stores (a copy of
juicefs_tpu/cmd/sync.py; reference pkg/sync + cmd/sync.go).

Producer/consumer layout mirroring the reference: both sides stream sorted
listings, an ordered-merge diff decides what to copy/delete (sync.go:777),
a worker pool moves the objects (worker :616), include/exclude rules filter
keys (:881-1076), and --check-new/--check-all content-compare (doCheckSum
:232 — here a streaming ranged compare, constant memory).

Large objects are partitioned into ranged GET + multipart-upload parts
(reference copyData sync.go:440-587) so a 5 GiB object moves through a
fixed-size buffer instead of resident memory.

Cluster mode (reference pkg/sync/cluster.go:132,237): `--manager-listen`
turns this process into an HTTP task server feeding the ordered diff to
any number of `--worker --manager host:port` processes (launched by the
operator or an external scheduler; the reference bootstraps them via ssh),
which pull task batches, copy with their own store clients, and push
stats back.

Changes from the JAX package's copy:

- Bootstrapped workers run `python -m juicefs_tpu_torch.cmd`, this
  package, not the JAX package's CLI.
- A straggler that reaches the manager after the queue is exhausted and
  every registered worker has reported exits 0 with zero tasks. Once it is
  done the manager answers `/register` and `/fetch` with `done` while its
  bootstrapped workers exit, and for `LINGER` seconds for workers it did
  not start itself; the reference shuts its listener at once, and such a
  worker's `/register` is refused. The completion check is as strict as
  the reference's: a worker that dies mid-batch still fails the sync.
"""

from __future__ import annotations

import fnmatch
import json
import threading
import time

from ..object import create_storage
from ..object.resilient import RetryPolicy, resilient
from ..qos import IOClass, global_scheduler
from ..utils import get_logger

logger = get_logger("cmd.sync")


def _open_store(uri: str):
    """Sync endpoints go through the resilience wrapper (no bare-store
    escapes): classified retries per object op, per-backend
    breaker.  Hedging stays off — bulk copy already runs `--threads`
    wide, and doubling GETs there is bandwidth, not tail latency.  The
    wall deadline is effectively unbounded: a multi-GiB part on a slow
    link may LEGITIMATELY take many minutes, and the wrapper cannot
    know object sizes — the pre-existing contract (ops run to
    completion, failed objects retry on later passes) stays intact."""
    return resilient(create_storage(uri),
                     policy=RetryPolicy(deadline=7 * 86400.0,
                                        max_attempts=5),
                     hedge=False)

CMP_CHUNK = 8 << 20  # streaming-compare window


def add_parser(sub):
    p = sub.add_parser("sync", help="sync objects between two stores")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--start", default="", help="first key (inclusive)")
    p.add_argument("--end", default="", help="last key (exclusive)")
    p.add_argument("--threads", type=int, default=10)
    p.add_argument("--update", action="store_true",
                   help="overwrite when src is newer (default: size/name diff)")
    p.add_argument("--force-update", action="store_true")
    p.add_argument("--check-new", action="store_true",
                   help="content-compare objects copied this run")
    p.add_argument("--check-all", action="store_true",
                   help="content-compare every object pair")
    p.add_argument("--delete-dst", action="store_true")
    p.add_argument("--delete-src", action="store_true")
    p.add_argument("--include", action="append", default=[])
    p.add_argument("--exclude", action="append", default=[])
    p.add_argument("--dry", action="store_true")
    p.add_argument("--big-threshold", type=int, default=32,
                   help="MiB; objects at least this big copy via ranged "
                        "multipart parts (reference sync.go:440)")
    p.add_argument("--part-size", type=int, default=8, help="MiB per part")
    p.add_argument("--bwlimit", type=int, default=0,
                   help="aggregate copy bandwidth cap in Mbps (0=unlimited; "
                        "reference sync.go bwlimit token bucket)")
    # cluster mode (reference cluster.go)
    p.add_argument("--manager-listen", default="",
                   help="host:port — serve the diff as an HTTP task queue "
                        "instead of copying locally")
    p.add_argument("--worker", action="store_true",
                   help="pull task batches from --manager and execute them")
    p.add_argument("--manager", default="", help="manager host:port")
    p.add_argument("--worker-hosts", default="",
                   help="comma-separated hosts: the manager BOOTSTRAPS one "
                        "worker per host via --worker-launch (reference "
                        "cluster.go:237 ssh bootstrap)")
    p.add_argument("--worker-launch", default="",
                   help="launch template with {host} and {cmd} placeholders "
                        "run through the shell, e.g. 'ssh {host} {cmd}'; "
                        "default: run {cmd} as a local subprocess")
    p.set_defaults(func=run)


def _match(key: str, includes: list[str], excludes: list[str]) -> bool:
    """Rule filter (reference sync.go:918 matchKey; first match wins)."""
    for pat in excludes:
        if fnmatch.fnmatch(key, pat):
            return False
    if includes:
        return any(fnmatch.fnmatch(key, pat) for pat in includes)
    return True


def _diff(src_iter, dst_iter, args):
    """Ordered-merge diff of two sorted listings (reference produce :777).

    Yields ("copy" | "del-dst" | "del-src" | "check", src_obj, dst_obj).
    """
    def nxt(it):
        return next(it, None)

    s, d = nxt(src_iter), nxt(dst_iter)
    while s is not None or d is not None:
        if d is None or (s is not None and s.key < d.key):
            yield "copy", s, None
            s = nxt(src_iter)
        elif s is None or d.key < s.key:
            if args.delete_dst:
                yield "del-dst", None, d
            d = nxt(dst_iter)
        else:
            if args.force_update:
                yield "copy", s, d
            elif s.size != d.size:
                yield "copy", s, d
            elif args.update and s.mtime > d.mtime:
                yield "copy", s, d
            elif args.check_all:
                yield "check", s, d
            elif args.delete_src:
                yield "del-src", s, None
            s, d = nxt(src_iter), nxt(dst_iter)


def _content_equal(src, dst, key: str, size: int) -> bool:
    """Streaming ranged compare: constant memory for any object size
    (replaces whole-object loads; reference doCheckSum streams too)."""
    if size <= 0:
        return bytes(src.get(key)) == bytes(dst.get(key))
    off = 0
    while off < size:
        n = min(CMP_CHUNK, size - off)
        if bytes(src.get(key, off, n)) != bytes(dst.get(key, off, n)):
            return False
        off += n
    return True


class _TokenBucket:
    """Aggregate bandwidth cap shared by all copy workers
    (reference pkg/sync bwlimit via juju/ratelimit)."""

    def __init__(self, mbps: int):
        self.rate = mbps * 125_000  # bytes/s
        self._avail = float(self.rate)  # 1s burst
        self._last = time.monotonic()
        self._mu = threading.Lock()

    def take(self, nbytes: int) -> None:
        while nbytes > 0:
            with self._mu:
                now = time.monotonic()
                self._avail = min(
                    float(self.rate), self._avail + (now - self._last) * self.rate
                )
                self._last = now
                grant = min(nbytes, self._avail)
                self._avail -= grant
                nbytes -= int(grant)
                if nbytes <= 0:
                    return
                wait = nbytes / self.rate
            time.sleep(min(wait, 0.5))


def _copy_object(src, dst, obj, args, stats) -> None:
    """Move one object; big objects go part-by-part through a fixed buffer
    (reference copyData sync.go:440-587 single-PUT vs UploadPart split)."""
    threshold = args.big_threshold << 20
    part_size = max(1 << 20, args.part_size << 20)
    up = None
    if obj.size >= threshold:
        try:
            up = dst.create_multipart_upload(obj.key)
        except Exception:
            up = None
    if up is None:
        data = bytes(src.get(obj.key))
        dst.put(obj.key, data)
        stats.add("copied_bytes", len(data))
        return
    part_size = max(part_size, up.min_part_size)
    n_parts = (obj.size + part_size - 1) // part_size
    if n_parts > up.max_count:  # few huge parts beat failing outright
        part_size = (obj.size + up.max_count - 1) // up.max_count
        n_parts = (obj.size + part_size - 1) // part_size
    parts = []
    try:
        for i in range(n_parts):
            off = i * part_size
            n = min(part_size, obj.size - off)
            data = bytes(src.get(obj.key, off, n))
            parts.append(dst.upload_part(obj.key, up.upload_id, i + 1, data))
            stats.add("copied_bytes", n)
        dst.complete_upload(obj.key, up.upload_id, parts)
    except BaseException:
        try:
            dst.abort_upload(obj.key, up.upload_id)
        except Exception:
            pass
        raise


def _make_executor(src, dst, args, stats):
    """The per-task state machine shared by local and worker modes."""
    bucket = _TokenBucket(args.bwlimit) if getattr(args, "bwlimit", 0) else None

    def do(task):
        op, s, d = task
        try:
            if op == "copy":
                if args.dry:
                    stats.add("copied")
                else:
                    if bucket is not None:
                        bucket.take(s.size)
                    _copy_object(src, dst, s, args, stats)
                    stats.add("copied")
                    if args.check_new and not _content_equal(
                            src, dst, s.key, s.size):
                        stats.add("mismatch")
                        logger.error("verify failed after copy: %s", s.key)
                    if args.delete_src:
                        src.delete(s.key)
                        stats.add("deleted")
            elif op == "del-dst":
                if not args.dry:
                    dst.delete(d.key)
                stats.add("deleted")
            elif op == "del-src":
                if not args.dry:
                    src.delete(s.key)
                stats.add("deleted")
            elif op == "check":
                stats.add("checked")
                if not _content_equal(src, dst, s.key, s.size):
                    stats.add("mismatch")
                    logger.error("content mismatch: %s", s.key)
            # counted only on full execution: a BaseException (interrupt)
            # skips this, so the manager sees the task as unaccounted
            stats.add("tasks_done")
        except Exception as e:
            logger.error("%s %s: %s", op, (s or d).key, e)
            stats.add("skipped")
            stats.add("tasks_done")

    return do


class _Stats(dict):
    """Counter dict updated concurrently by pool workers; the bare
    `d[k] += 1` read-modify-write loses updates under threads, and a lost
    tasks_done makes the cluster manager report a spurious partial sync."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.lock = threading.Lock()

    def add(self, key: str, n: int = 1) -> None:
        with self.lock:
            self[key] = self.get(key, 0) + n


def _new_stats() -> _Stats:
    # tasks_done counts tasks that ran to completion (including skips):
    # the manager's completion check compares it against dispatched count
    return _Stats({"copied": 0, "copied_bytes": 0, "deleted": 0, "checked": 0,
                   "mismatch": 0, "skipped": 0, "tasks_done": 0})


def run(args) -> int:
    if args.worker:
        return run_worker(args)

    src = _open_store(args.src)
    dst = _open_store(args.dst)
    dst.create()

    def filtered(store):
        for obj in store.list_all("", args.start):
            if args.end and obj.key >= args.end:
                break
            if obj.is_dir:
                continue  # folder markers are not copyable objects
            if _match(obj.key, args.include, args.exclude):
                yield obj

    tasks = _diff(filtered(src), filtered(dst), args)
    if args.manager_listen:
        return run_manager(args, tasks)

    stats = _new_stats()
    do = _make_executor(src, dst, args, stats)
    t0 = time.perf_counter()
    # BACKGROUND class: bulk replication yields to any
    # foreground traffic sharing the process and its bandwidth budget
    with global_scheduler().executor(
        "bulk", IOClass.BACKGROUND, width=args.threads
    ) as pool:
        list(pool.map(do, tasks))
    stats["seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(stats))
    return 1 if stats["mismatch"] else 0


# -- cluster mode ----------------------------------------------------------
# Wire protocol (JSON over HTTP, reference gob-over-HTTP cluster.go):
#   POST /fetch {"n": N}   -> {"tasks": [[op, obj|null, obj|null], ...],
#                              "done": bool}   (obj = [key, size, mtime])
#   POST /stats {<stats>}  -> {}
#   POST /register {}      -> {"done": bool}   (done: nothing left to do)

_BATCH = 256
# seconds a finished manager keeps answering `done` for workers it did not
# start itself (operator-launched, or behind a --worker-launch template)
LINGER = 5.0


def _obj_wire(o):
    return None if o is None else [o.key, o.size, o.mtime]


def _obj_unwire(v):
    from ..object.interface import Obj

    return None if v is None else Obj(key=v[0], size=v[1], mtime=v[2])


def _launch_workers(args, addr: str, flags: list[str]) -> list:
    """Bootstrap one worker per --worker-hosts entry (reference
    cluster.go:237, which ssh-launches workers).  The launch template gets
    {host} and {cmd}; the default runs {cmd} as a local subprocess — the
    hermetic analog of `ssh localhost {cmd}` — so a single command drives
    a whole localhost cluster end to end."""
    import shlex
    import subprocess
    import sys

    hosts = [h.strip() for h in
             getattr(args, "worker_hosts", "").split(",") if h.strip()]
    if not hosts:
        return []
    worker_argv = ["sync", args.src, args.dst, *flags,
                   "--worker", "--manager", addr,
                   "--threads", str(args.threads)]
    template = getattr(args, "worker_launch", "")
    procs = []
    for host in hosts:
        if template:
            # remote form: the template decides the transport and the
            # remote entrypoint; {cmd} is the bare subcommand string
            shell_cmd = template.format(
                host=host, cmd=shlex.join(worker_argv))
            procs.append(subprocess.Popen(
                shell_cmd, shell=True,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        else:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "juicefs_tpu_torch.cmd", *worker_argv],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        logger.info("launched worker on %s", host)
    return procs


def _reap_workers(procs: list, timeout: float = 30.0) -> bool:
    """Collect bootstrapped workers; True when any failed (nonzero exit
    or had to be killed) — the manager must not report a clean sync."""
    import subprocess

    failed = False
    for p in procs:
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = -9
        if rc != 0:
            logger.error("bootstrapped worker exited %s", rc)
            failed = True
    return failed


def run_manager(args, tasks) -> int:
    """Serve the ordered diff as a task queue (reference startManager
    cluster.go:132); aggregate worker stats.

    Completion integrity: the manager counts every task it hands out and
    requires the workers' aggregated stats to account for all of them —
    a worker that dies mid-batch (tasks fetched but never reported) turns
    into a nonzero exit, never a silent partial sync. A worker that dies
    without even posting stats is caught by the idle timeout instead of
    hanging the manager forever. Once finished, the manager answers late
    workers with `done` (see the module docstring) before it shuts.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    it = iter(tasks)
    lock = threading.Lock()
    totals = _new_stats()
    done = threading.Event()
    state = {"busy": 0, "dispatched": 0, "exhausted": False, "finished": False,
             "last_activity": time.monotonic()}

    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length") or 0)
            req = json.loads(self.rfile.read(n) or b"{}")
            with lock:
                state["last_activity"] = time.monotonic()
            if self.path == "/fetch":
                batch = []
                with lock:
                    for _ in range(0 if state["finished"] else
                                   min(int(req.get("n", _BATCH)), _BATCH)):
                        t = next(it, None)
                        if t is None:
                            state["exhausted"] = True
                            break
                        batch.append([t[0], _obj_wire(t[1]), _obj_wire(t[2])])
                    state["dispatched"] += len(batch)
                self._json({"tasks": batch, "done": not batch})
            elif self.path == "/stats":
                with lock:
                    for k, v in req.items():
                        if k in totals:
                            totals[k] += v
                    if not state["finished"]:
                        state["busy"] -= 1
                        if state["busy"] <= 0:
                            # under the lock with the count: no /register
                            # slips in between the last report and done
                            state["finished"] = True
                            done.set()
                self._json({})
            elif self.path == "/register":
                with lock:
                    late = state["finished"]
                    if not late:
                        state["busy"] += 1
                self._json({"done": late})
            elif self.path == "/ping":
                self._json({})  # worker heartbeat (long in-batch copies)
            else:
                self.send_error(404)

        def log_message(self, *a):
            pass

    host, _, port = args.manager_listen.rpartition(":")
    httpd = ThreadingHTTPServer((host or "127.0.0.1", int(port or 0)), Handler)
    addr = f"{httpd.server_address[0]}:{httpd.server_address[1]}"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    # the hint must carry every execution flag: a worker missing --dry
    # would really copy, missing --delete-src would skip deletions, etc.
    flags = []
    for f in ("dry", "check_new", "check_all", "delete_src", "delete_dst",
              "update", "force_update"):
        if getattr(args, f):
            flags.append("--" + f.replace("_", "-"))
    flags += ["--big-threshold", str(args.big_threshold),
              "--part-size", str(args.part_size)]
    if args.bwlimit:
        flags += ["--bwlimit", str(args.bwlimit)]  # per-worker cap
    print(json.dumps({"manager": addr,
                      "worker_cmd": f"sync {args.src} {args.dst} "
                                    f"{' '.join(flags)} --worker "
                                    f"--manager {addr}"}), flush=True)
    workers = _launch_workers(args, addr, flags)
    idle_limit = 300.0
    timed_out = False
    while not done.wait(timeout=5.0):
        with lock:
            started = state["busy"] > 0 or state["dispatched"] > 0
            busy = state["busy"]
            idle = time.monotonic() - state["last_activity"]
        if started and idle > idle_limit:
            logger.error("no worker activity for %.0fs; giving up", idle)
            timed_out = True
            break
        if workers and busy <= 0 \
                and all(p.poll() is not None for p in workers):
            if not args.worker_launch:
                # every bootstrapped worker already exited and none is
                # still registered: nothing will ever drain the queue —
                # fail now instead of waiting out the idle limit
                logger.error("all bootstrapped workers exited prematurely")
                timed_out = True
                break
            if state["dispatched"] == 0 \
                    and all(p.returncode != 0 for p in workers):
                # custom template: a detaching launcher (ssh -f, tmux)
                # exiting 0 says nothing about the worker, so the idle
                # limit is the backstop there — but every LAUNCH command
                # failing outright before any work is a dead cluster
                logger.error("every worker launch command failed")
                timed_out = True
                break
    with lock:
        state["finished"] = True  # a late /register or /fetch gets done
    # the listener answers while the bootstrapped workers exit, and for
    # LINGER more seconds when workers this process did not start may
    # still be on their way
    worker_failed = _reap_workers(workers)
    if not timed_out and (args.worker_launch or not workers):
        time.sleep(LINGER)
    httpd.shutdown()
    httpd.server_close()
    # every dispatched task must come back as a completed task: a worker
    # killed mid-batch reports fewer tasks_done than it fetched.  A
    # bootstrapped worker's nonzero exit matters only when the accounting
    # is ALSO short — a worker that failed after a sibling completed every
    # task (a launcher that exits nonzero, a straggler past LINGER) must
    # not fail a sync whose every task completed.
    incomplete = (timed_out or not state["exhausted"]
                  or totals["tasks_done"] < state["dispatched"])
    if worker_failed and not incomplete:
        logger.warning("a bootstrapped worker exited nonzero after the "
                       "sync completed (late straggler); result unaffected")
    if incomplete and not timed_out:
        logger.error(
            "workers completed %d of %d dispatched tasks — partial sync",
            totals["tasks_done"], state["dispatched"],
        )
    totals["dispatched"] = state["dispatched"]
    print(json.dumps(totals))
    return 1 if (totals["mismatch"] or incomplete) else 0


def run_worker(args) -> int:
    """Pull task batches from the manager and execute them
    (reference cluster.go:340 fetchJobs / :90 sendStats)."""
    import urllib.request

    if not args.manager:
        logger.error("--worker requires --manager host:port")
        return 2
    base = args.manager if "://" in args.manager else f"http://{args.manager}"

    def post(path, payload):
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read() or b"{}")

    src = _open_store(args.src)
    dst = _open_store(args.dst)
    stats = _new_stats()
    do = _make_executor(src, dst, args, stats)
    if post("/register", {}).get("done"):
        # a straggler: the queue is exhausted and every registered worker
        # has reported, so there is nothing to fetch and nothing to report
        print(json.dumps(stats))
        return 0
    # heartbeat: a batch of large multipart copies can run far longer than
    # the manager's idle timeout between /fetch posts
    stop_ping = threading.Event()

    def ping():
        while not stop_ping.wait(30.0):
            try:
                post("/ping", {})
            except Exception:
                pass

    pinger = threading.Thread(target=ping, daemon=True)
    pinger.start()
    try:
        with global_scheduler().executor(
            "bulk", IOClass.BACKGROUND, width=args.threads
        ) as pool:
            while True:
                out = post("/fetch", {"n": _BATCH})
                tasks = [
                    (t[0], _obj_unwire(t[1]), _obj_unwire(t[2]))
                    for t in out.get("tasks", [])
                ]
                if tasks:
                    list(pool.map(do, tasks))
                if out.get("done"):
                    break
    finally:
        stop_ping.set()
        post("/stats", stats)
    print(json.dumps(stats))
    return 1 if stats["mismatch"] else 0
