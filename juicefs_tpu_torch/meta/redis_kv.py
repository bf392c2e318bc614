"""Networked ordered-KV meta engine over the Redis protocol.

This is the distribution backbone the reference gets from Redis/TiKV/etcd
(pkg/meta/redis.go, tkv.go): any number of clients on any number of hosts
mount one volume by pointing `redis://host:port/db` at a shared server —
the bundled `meta-server` (redis_server.py) or a real Redis.

Layout inside Redis (binary-safe):
    <raw key>          -> value (string key per KV pair)
    !idx               -> zset of all keys (lexicographic scan index)

Transactions are real optimistic concurrency — the path local engines
could never exercise: every read WATCHes its
key, the buffered writes commit under MULTI/EXEC, and a concurrent
conflicting writer causes EXEC to return nil, which surfaces as
ConflictError and retries with backoff (reference redis.go txn over
WATCH, tkv.go txn retry loop).
"""

from __future__ import annotations

import bisect
import socket
import threading
import time
from typing import Iterator, Optional

from ..utils import get_logger, txnwatch
from .tkv_client import ConflictError, KVTxn, TKVClient, next_key

logger = get_logger("meta.redis_kv")

IDX_KEY = b"!idx"
SCAN_PAGE = 2048


class MetaNetworkError(ConnectionError):
    """Socket-level failure talking to the meta server.

    Distinct from the OSError-with-errno values the meta layer raises for
    POSIX results (ENOENT, EEXIST, ...) so reconnect logic can never swallow
    a real file-system errno (redis_kv reconnect).
    """


class MetaCommitUnknownError(MetaNetworkError):
    """The connection died AFTER the commit pipeline was fully sent: the
    transaction may or may not have been applied.  Classified AMBIGUOUS
    by the fault contract — never blindly retried, because a
    rerun of a read-modify-write that DID land would double-apply."""


class RespConnection:
    """One RESP2 connection (binary-safe, minimal)."""

    def __init__(self, host: str, port: int, db: int = 0, timeout: float = 30.0):
        try:
            self.sock = socket.create_connection((host, port), timeout=timeout)
        except OSError as e:
            raise MetaNetworkError(f"meta server connect failed: {e}") from e
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = self.sock.makefile("rb")
        if db:
            self.execute(b"SELECT", str(db).encode())

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    # -- pipeline ----------------------------------------------------------
    def send(self, *cmds: tuple) -> None:
        buf = bytearray()
        for cmd in cmds:
            buf += b"*" + str(len(cmd)).encode() + b"\r\n"
            for arg in cmd:
                if isinstance(arg, str):
                    arg = arg.encode()
                elif isinstance(arg, int):
                    arg = str(arg).encode()
                buf += b"$" + str(len(arg)).encode() + b"\r\n" + arg + b"\r\n"
        try:
            self.sock.sendall(bytes(buf))
        except OSError as e:
            raise MetaNetworkError(f"meta server send failed: {e}") from e

    def read_reply(self):
        try:
            line = self.rfile.readline()
        except OSError as e:
            raise MetaNetworkError(f"meta server read failed: {e}") from e
        if not line:
            raise MetaNetworkError("meta server closed connection")
        t, rest = line[:1], line[1:-2]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RedisError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n < 0:
                return None
            try:
                data = self.rfile.read(n + 2)
            except OSError as e:
                raise MetaNetworkError(f"meta server read failed: {e}") from e
            if len(data) != n + 2:
                raise MetaNetworkError("meta server closed mid bulk reply")
            return data[:-2]
        if t == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self.read_reply() for _ in range(n)]
        raise ValueError(f"bad RESP type byte {t!r}")

    def execute(self, *args):
        self.send(args)
        return self.read_reply()


class RedisError(Exception):
    pass


class _RedisTxn(KVTxn):
    """Snapshot-ish reads (WATCH+GET) with buffered writes (tkv.go kvTxn)."""

    def __init__(self, client: "RedisKV", conn: RespConnection):
        self._client = client
        self._conn = conn
        self._writes: dict[bytes, Optional[bytes]] = {}
        self._read_cache: dict[bytes, Optional[bytes]] = {}
        # txnwatch read-set: scans are not in _read_cache, but the rerun
        # harness needs everything the closure OBSERVED to judge whether
        # divergent writes mean impurity or just a concurrent writer
        self._scan_log: list = []

    def get(self, key: bytes) -> Optional[bytes]:
        if key in self._writes:
            return self._writes[key]
        if key in self._read_cache:
            return self._read_cache[key]
        # WATCH before read: any later concurrent write aborts our EXEC
        self._conn.send((b"WATCH", key), (b"GET", key))
        self._conn.read_reply()
        val = self._conn.read_reply()
        self._read_cache[key] = val
        return val

    def gets(self, *keys):
        """One WATCH + one MGET round trip for a batch of point reads
        (readdirplus attr assembly: per-entry GETs dominate first-listing
        latency on a networked engine)."""
        missing = [
            k for k in keys
            if k not in self._writes and k not in self._read_cache
        ]
        if missing:
            self._conn.send([b"WATCH"] + missing, [b"MGET"] + missing)
            self._conn.read_reply()
            vals = self._conn.read_reply()
            for k, v in zip(missing, vals):
                self._read_cache[k] = v
        return [
            self._writes[k] if k in self._writes else self._read_cache[k]
            for k in keys
        ]

    def set(self, key: bytes, value: bytes) -> None:
        self._writes[key] = bytes(value)

    def delete(self, key: bytes) -> None:
        self._writes[key] = None

    def scan(self, begin, end, keys_only=False, limit=-1):
        # Server range WITHOUT conflict detection: neither the scanned keys
        # nor the !idx index are WATCHed, so EXEC can commit a decision
        # based on a stale range read. This is safe under the
        # meta schema's invariant that every namespace mutation also writes
        # the parent directory's attr key (A{ino}I): range-dependent
        # decisions (e.g. rmdir's emptiness scan) always also GET+WATCH
        # that attr key in the same closure, so a competing create/unlink
        # invalidates the txn through it. Keep that invariant when adding
        # ops whose correctness depends on a scan.
        names = self._client._range(self._conn, begin, end)
        merged: dict[bytes, Optional[bytes]] = {}
        if not keys_only and names:
            self._conn.send([b"MGET"] + names)
            vals = self._conn.read_reply()
            for k, v in zip(names, vals):
                merged[k] = v
        else:
            for k in names:
                merged[k] = b""
        if txnwatch.active():
            # read-set recording for the rerun harness only: a sorted
            # full copy per scan is pure waste on production listings
            self._scan_log.append(
                (begin, end, tuple(sorted((k, merged[k]) for k in merged))))
        for k, v in self._writes.items():
            if begin <= k < end:
                merged[k] = v
        n = 0
        for k in sorted(merged):
            v = merged[k]
            if v is None:
                continue
            yield (k, b"" if keys_only else v)
            n += 1
            if limit >= 0 and n >= limit:
                return


class _WriteInReadTxn(Exception):
    """A simple_txn closure tried to write: rerun it under the full
    WATCH-backed transaction (read closures are pure, so the rerun is
    safe)."""


class _ReadTxn(KVTxn):
    """Read-only transaction for `simple_txn`: plain GET/MGET, no WATCH,
    no UNWATCH — a point read is ONE round trip instead of the write
    path's two — and routable to a replica connection.

    Replica reads are guarded by the volume change-epoch: every committed
    write transaction bumps the `!epoch` counter inside its MULTI/EXEC
    and raises this client's floor from the commit reply, so the floor
    covers the client's OWN writes exactly (read-your-own-writes across
    the replica boundary — a create must never come back ENOENT from a
    lagging replica).  The first read of a transaction pipelines
    `GET !epoch` with its own MGET (no extra round trip); a replica whose
    applied epoch trails the floor demotes the whole transaction to the
    primary.  The connection choice is pinned for the transaction, so a
    scan + gets closure never mixes replica and primary snapshots.
    """

    def __init__(self, client: "RedisKV"):
        self._client = client
        self._cache: dict[bytes, Optional[bytes]] = {}
        self._conn: Optional[RespConnection] = None

    def _ensure_conn(self, first_cmd: Optional[tuple] = None):
        """Pick and pin the connection, riding the epoch guard on
        `first_cmd`'s pipeline when the replica is a candidate.  Returns
        first_cmd's reply (or None when called without one)."""
        from .cache import _REPLICA_READS, _REPLICA_STALE

        cl = self._client
        if self._conn is None and cl.replica_host is not None:
            try:
                conn = cl._replica_conn()
                if first_cmd is not None:
                    conn.send((b"GET", cl.EPOCH_KEY), first_cmd)
                    raw = conn.read_reply()
                    reply = conn.read_reply()
                else:
                    raw = conn.execute(b"GET", cl.EPOCH_KEY)
                    reply = None
                if cl._epoch_of(raw) >= cl._epoch_floor:
                    _REPLICA_READS.inc()
                    self._conn = conn
                    return reply
                _REPLICA_STALE.inc()  # lagging: demote to the primary
            except MetaNetworkError:
                cl._drop_replica_conn()
        if self._conn is None:
            if cl.primary_down:
                # failover mode: the breaker already knows
                # the primary is dark — fail fast instead of paying a
                # connect timeout per read that the replica refused
                raise MetaNetworkError(
                    "primary down and replica refused (lagging/dead)")
            self._conn = cl._conn()
        if first_cmd is None:
            return None
        self._conn.send(first_cmd)
        return self._conn.read_reply()

    def get(self, key: bytes) -> Optional[bytes]:
        return self.gets(key)[0]

    def gets(self, *keys):
        missing = [k for k in keys if k not in self._cache]
        if missing:
            vals = self._ensure_conn(tuple([b"MGET"] + missing))
            for k, v in zip(missing, vals):
                self._cache[k] = v
        return [self._cache[k] for k in keys]

    def set(self, key: bytes, value: bytes) -> None:
        raise _WriteInReadTxn

    def delete(self, key: bytes) -> None:
        raise _WriteInReadTxn

    def scan(self, begin, end, keys_only=False, limit=-1):
        self._ensure_conn()
        conn = self._conn
        names = self._client._range(conn, begin, end)
        vals: dict[bytes, bytes] = {}
        if not keys_only and names:
            conn.send(tuple([b"MGET"] + names))
            for k, v in zip(names, conn.read_reply()):
                vals[k] = v
        n = 0
        for k in names:
            v = b"" if keys_only else vals.get(k)
            if v is None:
                continue
            yield (k, v)
            n += 1
            if limit >= 0 and n >= limit:
                return


class RedisKV(TKVClient):
    """TKVClient over the Redis protocol (multi-host capable)."""

    name = "redis"

    def __init__(self, addr: str):
        # addr: host[:port][/db][?replica=host[:port]]
        replica = ""
        if "?" in addr:
            addr, query = addr.split("?", 1)
            for part in query.split("&"):
                if part.startswith("replica="):
                    replica = part[len("replica="):]
        host, port, db = "127.0.0.1", 6379, 0
        if "/" in addr:
            addr, dbs = addr.rsplit("/", 1)
            if dbs:
                db = int(dbs)
        if addr:
            if ":" in addr:
                host, ps = addr.rsplit(":", 1)
                port = int(ps)
            else:
                host = addr
        self.host, self.port, self.db = host or "127.0.0.1", port, db
        self._local = threading.local()
        # read-replica routing: WATCH-backed txns stay pinned to
        # the primary; _ReadTxn point reads go to the replica while its
        # applied change-epoch has caught up with this client's floor
        self.replica_host: Optional[str] = None
        self.replica_port: int = 0
        self._epoch_floor = 0
        # FAILOVER flag: set by the meta breaker's on_open —
        # read transactions stop dialing the dead primary (the replica
        # serves everything the epoch guard admits; past the guard they
        # fail fast instead of paying a connect to a dead host)
        self.primary_down = False
        if replica:
            self.configure_replica(replica)
        self.execute(b"PING")  # fail fast on a bad address

    # -- connections (one per thread, like SqliteKV) -----------------------
    def _conn(self) -> RespConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = RespConnection(self.host, self.port, self.db)
            self._local.conn = conn
        return conn

    def _drop_conn(self) -> None:
        """Discard this thread's connection so the next use redials.

        Without this a single socket error poisoned the thread-local
        connection forever: every later meta op on the
        thread failed on the same dead socket.
        """
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    # -- read replica --------------------------------------------
    # The volume change-epoch: every committed write transaction bumps
    # this counter inside its MULTI/EXEC, so it advances with the
    # mutation stream itself (replicated in order with it).  The commit
    # reply raises the local floor, which is exactly the
    # read-your-own-writes bound a replica read must satisfy.
    EPOCH_KEY = b"!epoch"

    def configure_replica(self, addr: str) -> None:
        """Route read-only transactions to `host[:port]` (same db). The
        primary remains the truth for every WATCH-backed transaction and
        non-txn command."""
        host, port = addr, self.port
        if ":" in addr:
            host, ps = addr.rsplit(":", 1)
            port = int(ps)
        self.replica_host, self.replica_port = host or "127.0.0.1", port
        # prime the floor from the primary's CURRENT epoch: a read-only
        # client (the dataloader case) never writes, so without this its
        # floor would stay 0 and a still-syncing/lagging replica would
        # pass the guard — serving ENOENT for files that exist
        try:
            self.advance_epoch(
                self._epoch_of(self.execute(b"GET", self.EPOCH_KEY)))
        except MetaNetworkError:
            pass  # primary unreachable: the PING/first op will surface it

    def advance_epoch(self, v: int) -> None:
        """Monotonically raise the replica-read floor to an epoch this
        client has observed on the primary."""
        if v and v > self._epoch_floor:
            self._epoch_floor = v

    def reprime_epoch_floor(self) -> None:
        """Re-read the primary's CURRENT epoch and raise the floor to it
        (heal chain).  A client that rode out an outage on the
        replica has a floor frozen at its last observed epoch; the
        primary may have committed far past it before dying, and the
        replica re-SYNCs asynchronously — without this re-prime the
        stale floor would let the still-catching-up replica serve
        pre-outage state as fresh."""
        self.advance_epoch(
            self._epoch_of(self.execute(b"GET", self.EPOCH_KEY)))

    def on_primary_heal(self) -> None:
        """Breaker heal hook: drop failover mode and re-prime the floor.
        The dead thread-local sockets redial lazily on next use."""
        self.primary_down = False
        try:
            self.reprime_epoch_floor()
        except MetaNetworkError:
            # healed-then-flapped: the next op re-trips the breaker
            logger.warning("epoch floor re-prime failed; replica reads "
                           "stay guarded by the old floor")

    @staticmethod
    def _epoch_of(raw) -> int:
        if not raw:
            return 0
        try:
            return int(raw)
        except ValueError:
            return int.from_bytes(raw, "big", signed=True)

    def _replica_conn(self) -> RespConnection:
        conn = getattr(self._local, "rconn", None)
        if conn is None:
            conn = RespConnection(self.replica_host, self.replica_port, self.db)
            self._local.rconn = conn
        return conn

    def _drop_replica_conn(self) -> None:
        conn = getattr(self._local, "rconn", None)
        if conn is not None:
            conn.close()
            self._local.rconn = None

    # Commands execute() may transparently re-send after a network error:
    # re-running any of these converges to the same end state. Anything not
    # listed (a hypothetical INCR/APPEND) fails fast instead, because the
    # server may already have applied it before the reply was lost.
    _IDEMPOTENT = frozenset({
        b"GET", b"MGET", b"EXISTS", b"PING", b"SELECT", b"ZRANGEBYLEX",
        b"SET", b"DEL", b"ZREM", b"ZADD", b"UNWATCH", b"FLUSHDB",
    })

    def execute(self, *args):
        cmd = args[0] if isinstance(args[0], bytes) else str(args[0]).encode()
        if cmd.upper() in self._IDEMPOTENT:
            return self._retry_io(lambda: self._conn().execute(*args))
        try:
            return self._conn().execute(*args)
        except MetaNetworkError:
            self._drop_conn()
            raise

    def in_txn(self) -> bool:
        return getattr(self._local, "tx", None) is not None

    def simple_txn(self, fn):
        """Read-mostly transaction on the cheap path: no WATCH (a point
        read is ONE round trip, with no trailing UNWATCH), replica-routable.
        A closure that unexpectedly writes reruns under the
        full WATCH-backed txn — read closures are pure, so that is safe."""
        active = getattr(self._local, "tx", None)
        if active is not None:
            return fn(active)  # nested: join the enclosing transaction
        for attempt in range(1 + self._NET_RETRIES):
            tx = _ReadTxn(self)
            self._local.tx = tx
            try:
                return fn(tx)
            except _WriteInReadTxn:
                break  # writer closure: run it under the real txn below
            except MetaNetworkError:
                self._drop_conn()
                self._drop_replica_conn()
                if attempt >= self._NET_RETRIES:
                    raise
            finally:
                self._local.tx = None
        return self.txn(fn)

    # -- range helper ------------------------------------------------------
    @staticmethod
    def _range(conn: RespConnection, begin: bytes, end: bytes) -> list[bytes]:
        out: list[bytes] = []
        lo = b"[" + begin
        while True:
            page = conn.execute(
                b"ZRANGEBYLEX", IDX_KEY, lo, b"(" + end, b"LIMIT", 0, SCAN_PAGE
            )
            out.extend(page)
            if len(page) < SCAN_PAGE:
                return out
            lo = b"(" + page[-1]

    # -- transactions ------------------------------------------------------
    def _unwatch_quiet(self, conn: RespConnection) -> None:
        """Best-effort UNWATCH that can never mask the primary exception."""
        try:
            conn.execute(b"UNWATCH")
        except Exception:
            self._drop_conn()  # dead socket: uncache so next use redials

    # Socket failures get their own small retry budget: conflict retries
    # are cheap and frequent under contention (budget 50), but each network
    # redial can block for a full connect timeout, so reusing the conflict
    # budget could stall a single meta op for many minutes.
    _NET_RETRIES = 3

    def txn(self, fn, retries: int = 50):
        active = getattr(self._local, "tx", None)
        if active is not None:
            return fn(active)  # nested: join (single atomic commit)
        last: Exception | None = None
        net_failures = 0
        for attempt in range(retries):
            committing = False
            try:
                conn = self._conn()

                # txn-rerun harness seam: under JUICEFS_TXN_RERUN the
                # closure runs twice against fresh write buffers (reads
                # re-WATCH the same keys, so the conflict guard is
                # unchanged); redis is registered RACY — a concurrent
                # writer between the runs triggers a triple-check, not
                # a false violation
                def run_once():
                    tx = _RedisTxn(self, conn)
                    self._local.tx = tx
                    try:
                        r = fn(tx)
                    except BaseException:
                        self._unwatch_quiet(conn)
                        raise
                    finally:
                        self._local.tx = None
                    # 4th element = the read set: divergent writes only
                    # count as impurity when both runs read the same state
                    return (r, tx._writes, tx._discarded,
                            (tx._read_cache, tuple(tx._scan_log)))

                result, writes, discarded = txnwatch.double_run(
                    "redis", fn, run_once)
                if discarded or not writes:
                    self._unwatch_quiet(conn)
                    return result
                cmds: list[tuple] = [(b"MULTI",)]
                adds = [k for k, v in writes.items() if v is not None]
                dels = [k for k, v in writes.items() if v is None]
                for k in adds:
                    cmds.append((b"SET", k, writes[k]))
                if dels:
                    cmds.append(tuple([b"DEL"] + dels))
                    cmds.append(tuple([b"ZREM", IDX_KEY] + dels))
                if adds:
                    zadd: list = [b"ZADD", IDX_KEY]
                    for k in adds:
                        zadd += [b"0", k]
                    cmds.append(tuple(zadd))
                # the epoch bump rides the transaction itself, queued LAST
                # (its value is EXEC's final reply): commit order and
                # epoch order can never diverge, and the reply raises this
                # client's replica-read floor (read-your-own-writes)
                cmds.append((b"INCRBY", self.EPOCH_KEY, b"1"))
                cmds.append((b"EXEC",))
                conn.send(*cmds)
                # send() raising means EXEC (the pipeline tail) never fully
                # reached the server, so that is still a safe retry; only
                # after a complete send is the commit outcome ambiguous.
                committing = True
                replies = [conn.read_reply() for _ in cmds]
                if replies[-1] is not None:
                    exec_replies = replies[-1]
                    if isinstance(exec_replies, list) and exec_replies \
                            and isinstance(exec_replies[-1], int):
                        self.advance_epoch(exec_replies[-1])
                    return result  # committed
                last = ConflictError(f"txn conflict (attempt {attempt})")
            except MetaNetworkError as e:
                # Connection died mid-attempt: redial.
                # Before the commit pipeline goes out nothing can have been
                # applied (reads only WATCH), so the closure retries safely.
                # Once EXEC may have reached the server the outcome is
                # unknowable — a blind retry could double-apply a
                # read-modify-write — so surface the error to the caller.
                self._drop_conn()
                if committing:
                    raise MetaCommitUnknownError(
                        "connection lost while committing; outcome unknown"
                    ) from e
                net_failures += 1
                if net_failures >= self._NET_RETRIES:
                    raise
                last = e
            except RedisError:
                # Server-side command error mid-pipeline: later replies are
                # unread, so the connection is desynced — drop it.
                self._drop_conn()
                raise
            time.sleep(min(0.0005 * (1 << min(attempt, 8)), 0.05))
        raise last  # type: ignore[misc]

    # -- non-txn bulk scan (gc/fsck/dump sweeps) ---------------------------
    def _retry_io(self, op):
        """Run op(); on a network error redial once and rerun (reads only)."""
        try:
            return op()
        except MetaNetworkError:
            self._drop_conn()
            if self.in_txn():
                raise
            return op()

    def scan(self, begin, end) -> Iterator[tuple[bytes, bytes]]:
        names = self._retry_io(lambda: self._range(self._conn(), begin, end))

        def mget(chunk):
            conn = self._conn()
            conn.send([b"MGET"] + chunk)
            return conn.read_reply()

        for i in range(0, len(names), SCAN_PAGE):
            chunk = names[i:i + SCAN_PAGE]
            vals = self._retry_io(lambda: mget(chunk))
            for k, v in zip(chunk, vals):
                if v is not None:
                    yield (k, v)

    def reset(self) -> None:
        self.execute(b"FLUSHDB")

    # -- pub/sub (cross-client lock wake) -------------------
    def publish(self, channel: bytes, message: bytes) -> None:
        """Fire-and-forget push to every subscriber of `channel`."""
        try:
            self.execute(b"PUBLISH", channel, message)
        except Exception:
            pass  # push is an acceleration; the poll cadence still covers

    def subscribe(self, channel: bytes, callback) -> None:
        """Spawn a daemon listener: callback(payload) per pushed message.
        Reconnects on error; stops when close() is called."""
        stop = getattr(self, "_sub_stop", None)
        if stop is None:
            stop = self._sub_stop = threading.Event()
        if not hasattr(self, "_sub_conns"):
            self._sub_conns: list = []
            self._sub_mu = threading.Lock()

        def loop():
            while not stop.is_set():
                conn = None
                try:
                    # timeout=None: pub/sub channels are mostly idle; the
                    # default 30s recv timeout would churn a reconnect (and
                    # a deaf window) every 30s forever. Registered under a
                    # lock so close() can sever EVERY parked listener, and
                    # re-checked after registration to close the race with
                    # a concurrent close().
                    conn = RespConnection(self.host, self.port, timeout=None)
                    with self._sub_mu:
                        self._sub_conns.append(conn)
                    if stop.is_set():
                        conn.close()
                        return
                    conn.send((b"SUBSCRIBE", channel))
                    conn.read_reply()
                    while not stop.is_set():
                        msg = conn.read_reply()
                        if (isinstance(msg, list) and len(msg) == 3
                                and msg[0] == b"message"):
                            try:
                                callback(bytes(msg[2]))
                            except Exception:
                                pass
                except Exception:
                    if not stop.is_set():
                        time.sleep(0.5)
                finally:
                    if conn is not None:
                        conn.close()
                        with self._sub_mu:
                            if conn in self._sub_conns:
                                self._sub_conns.remove(conn)

        t = threading.Thread(target=loop, daemon=True,
                             name=f"sub-{channel.decode(errors='replace')}")
        t.start()

    def close(self) -> None:
        stop = getattr(self, "_sub_stop", None)
        if stop is not None:
            stop.set()
        if hasattr(self, "_sub_conns"):
            with self._sub_mu:
                subs, self._sub_conns = list(self._sub_conns), []
            for c in subs:
                c.close()  # unblocks listeners parked in read_reply
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
        self._drop_replica_conn()
