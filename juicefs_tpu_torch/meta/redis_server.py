"""Bundled Redis-protocol (RESP2) server — the networked meta transport
(a copy of juicefs_tpu/meta/redis_server.py).

The reference's distribution story is many clients coordinating through a
shared network DB (pkg/meta/redis.go, tkv.go over TiKV/etcd). This module
provides that transport without external dependencies: a TCP server
speaking the Redis wire protocol with exactly the command subset the
RedisKV engine needs — strings, a lexicographic index (zset subset),
and optimistic WATCH/MULTI/EXEC transactions with per-key versioning.

It is wire-compatible with real Redis for these commands, so production
deployments can point meta at an actual Redis/KeyDB cluster while tests
and single-host setups use this in-process server (`juicefs-tpu-torch
meta-server` serves it standalone for true multi-host volumes).

Concurrency model: thread per connection; one process-wide lock around
command execution (Redis itself is single-threaded for commands); WATCH
records per-key versions, EXEC validates them under the lock — the same
optimistic scheme as Redis WATCH (redis.io/topics/transactions).
"""

from __future__ import annotations

import bisect
import os
import socket
import socketserver
import threading
from typing import Optional

from ..utils import get_logger

logger = get_logger("meta.redis_server")


class _DB:
    def __init__(self):
        self.data: dict[bytes, bytes] = {}
        self.versions: dict[bytes, int] = {}
        self.zsets: dict[bytes, list[bytes]] = {}  # name -> sorted members

    def bump(self, key: bytes) -> None:
        self.versions[key] = self.versions.get(key, 0) + 1


class RedisServer:
    """Minimal RESP2 server. start() returns the bound port.

    Durability (role-match to Redis AOF): with data_path set, every
    mutating command is appended to an append-only file (RESP-encoded,
    replayable by the same parser) and replayed on start; after replay
    the file is rewritten as a compact snapshot so it never grows
    unboundedly across restarts. fsync="always" makes every mutation
    durable before its reply; "everysec" batches fsyncs (Redis's
    default trade-off).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, n_dbs: int = 16,
                 data_path: Optional[str] = None, fsync: str = "everysec",
                 replica_of: Optional[str] = None):
        self.host, self.port = host, port
        self.dbs = [_DB() for _ in range(n_dbs)]
        self.lock = threading.RLock()
        # replication: a replica dials the primary, sends SYNC,
        # and applies the streamed command log forever. The primary sends
        # a consistent snapshot first (encoded as ordinary SELECT/FLUSHDB/
        # SET/ZADD commands, same framing as the AOF) and then forwards
        # every mutation in commit order. Delivery rides a dedicated queue
        # + thread so a slow replica never blocks the dispatch lock.
        self.replica_of = replica_of  # "host:port" when this IS a replica
        self.replicas: list = []      # live replica conns (primary side)
        self._repl_q = None
        self._repl_thread: Optional[threading.Thread] = None
        self._repl_stop = threading.Event()
        self._repl_pull_conn = None
        # pub/sub (SUBSCRIBE/PUBLISH subset): channel -> live subscriber
        # conns. Ephemeral — never AOF'd. Powers cross-client lock wake
        # and any future push channel. One long-lived
        # delivery thread drains the queue: publishes never block the
        # dispatch lock, per-channel ordering is preserved, and no thread
        # is spawned per PUBLISH.
        self.subscribers: dict[bytes, set] = {}
        import queue as _queue

        self._pub_q: "_queue.Queue" = _queue.Queue()
        self._pub_thread = threading.Thread(
            target=self._pub_loop, daemon=True, name="pubsub-deliver"
        )
        self._pub_thread.start()
        self._srv: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None
        # live client connections: stop() hard-closes them so a stopped
        # server goes DARK (blackout drills).  Without this, established handler
        # threads keep serving the in-memory dbs after "stop" and a
        # simulated primary kill kills nothing.
        self._conns: set = set()
        self.data_path = data_path
        self.fsync = fsync
        self._aof = None
        self._aof_db = -1  # db of the last logged SELECT (-1 = none yet)
        self._aof_txn = 0  # EXEC nesting: defer fsync to the txn end
        self._aof_stop = threading.Event()

    def _pub_loop(self) -> None:
        while True:
            item = self._pub_q.get()
            if item is None:  # stop() sentinel
                return
            ch, push, conns = item
            for c in conns:
                try:
                    c._send_push(push)
                except OSError:
                    with self.lock:
                        self.subscribers.get(ch, set()).discard(c)

    # ---- replication (primary side) --------------------------------------
    def _ensure_repl_thread(self) -> None:
        """Caller holds self.lock."""
        if self._repl_thread is not None and self._repl_thread.is_alive():
            return
        import queue as _queue

        if self._repl_q is None:
            self._repl_q = _queue.Queue()
        self._repl_thread = threading.Thread(
            target=self._repl_loop, daemon=True, name="repl-deliver"
        )
        self._repl_thread.start()

    def _repl_loop(self) -> None:
        while True:
            item = self._repl_q.get()
            if item is None:  # stop() sentinel
                return
            payload, conns = item
            for c in conns:
                try:
                    c._send_push(payload)
                except OSError:
                    with self.lock:
                        if c in self.replicas:
                            self.replicas.remove(c)
                    # a timed-out sendall may have written a PARTIAL
                    # frame: close the socket so the replica's pull loop
                    # (parked in read_reply) gets EOF and re-SYNCs
                    # instead of hanging on the torn stream forever
                    try:
                        c.sock.close()
                    except OSError:
                        pass

    def repl_append(self, db_idx: int, parts: list) -> None:
        """Forward one mutating command to every replica (caller holds
        self.lock, so forwards are enqueued in commit order)."""
        if not self.replicas:
            return
        payload = _Conn._enc([b"SELECT", str(db_idx).encode()]) + _Conn._enc(
            [p if isinstance(p, bytes) else bytes(p) for p in parts]
        )
        self._repl_q.put((payload, list(self.replicas)))

    def _snapshot_payload(self) -> bytes:
        """Full-state snapshot as replayable commands (caller holds
        self.lock). EVERY db is FLUSHDB'd — including ones empty on the
        primary — so a re-SYNC after a replication gap cannot leave
        ghosts on the replica (a db flushed on the primary while the
        replica was away must be flushed there too).

        The whole snapshot is framed MULTI..EXEC so the replica's pull
        loop applies it under ONE lock hold: applied
        command-by-command, a reader attached mid-re-SYNC could observe
        the FLUSHDB-to-repopulated window — and because dict order puts
        the !epoch key EARLY (it is written by the first commit), the
        epoch lag guard would PASS while most of the namespace was still
        missing, serving ENOENT for files that exist as if fresh."""
        buf = bytearray()
        buf += _Conn._enc([b"MULTI"])
        for i, db in enumerate(self.dbs):
            buf += _Conn._enc([b"SELECT", str(i).encode()])
            buf += _Conn._enc([b"FLUSHDB"])
            for k, v in db.data.items():
                buf += _Conn._enc([b"SET", k, v])
            for name, members in db.zsets.items():
                for m in members:
                    buf += _Conn._enc([b"ZADD", name, b"0", m])
        buf += _Conn._enc([b"EXEC"])
        return bytes(buf)

    # ---- replication (replica side) --------------------------------------
    @staticmethod
    def _parse_primary(addr: str) -> tuple[str, int]:
        """Validate --replica-of eagerly: a malformed address must fail
        startup, not spin the pull loop's reconnect-forever path."""
        host, sep, ps = addr.rpartition(":")
        if not sep or not ps.isdigit():
            raise ValueError(
                f"--replica-of expects host:port, got {addr!r}")
        return host or "127.0.0.1", int(ps)

    def _replica_pull_loop(self) -> None:
        from .redis_kv import RespConnection

        host, port = self._parse_primary(self.replica_of)
        while not self._repl_stop.is_set():
            conn = None
            try:
                conn = RespConnection(host, port, timeout=None)
                self._repl_pull_conn = conn
                if self._repl_stop.is_set():
                    return
                conn.send((b"SYNC",))
                apply_conn = self._replay_conn()

                def apply(parts) -> None:
                    name = parts[0].upper().decode("ascii", "replace").lower()
                    handler = getattr(apply_conn, "cmd_" + name, None)
                    if handler is not None:
                        handler(parts[1:])

                # MULTI/EXEC markers bracket the primary's transactions:
                # the whole batch applies under ONE lock hold, so a
                # replica reader can never observe a half-applied meta
                # transaction (the epoch bump inside it would otherwise
                # outrun the data writes and defeat the lag guard)
                txn_buf: Optional[list] = None
                while not self._repl_stop.is_set():
                    parts = conn.read_reply()
                    if not isinstance(parts, list) or not parts:
                        continue
                    op = parts[0].upper()
                    if op == b"MULTI":
                        txn_buf = []
                    elif op == b"EXEC":
                        with self.lock:
                            for rec in txn_buf or ():
                                apply(rec)
                        txn_buf = None
                    elif txn_buf is not None:
                        txn_buf.append(parts)
                    else:
                        with self.lock:
                            apply(parts)
            except Exception:
                if self._repl_stop.is_set():
                    return
                self._repl_stop.wait(0.3)  # primary gone: retry with re-SYNC
            finally:
                self._repl_pull_conn = None
                if conn is not None:
                    conn.close()

    # ---- persistence -----------------------------------------------------
    def aof_append(self, db_idx: int, parts: list) -> None:
        """Log one mutating command (caller holds self.lock)."""
        if self._aof is None:
            if self.data_path and not getattr(self, "_replaying", False):
                logger.warning("aof closed: mutation not logged (shutdown?)")
            return
        buf = b""
        if db_idx != self._aof_db:
            buf += _Conn._enc([b"SELECT", str(db_idx).encode()])
            self._aof_db = db_idx
        buf += _Conn._enc([p if isinstance(p, bytes) else bytes(p) for p in parts])
        self._aof.write(buf)
        if self.fsync == "always" and self._aof_txn == 0:
            self._aof.flush()
            os.fsync(self._aof.fileno())

    def aof_txn_begin(self, db_idx: int) -> None:
        if self._aof is None:
            return
        self.aof_append(db_idx, [b"MULTI"])
        self._aof_txn += 1

    def aof_txn_end(self) -> None:
        if self._aof is None:
            return
        self.aof_append(self._aof_db, [b"EXEC"])  # still in-txn: no fsync yet
        self._aof_txn -= 1
        if self.fsync == "always":
            self._aof.flush()
            os.fsync(self._aof.fileno())

    def _replay_conn(self) -> "_Conn":
        conn = object.__new__(_Conn)
        conn.server = self
        conn.db = self.dbs[0]
        conn.db_idx = 0
        conn.watched = {}
        conn.in_multi = False
        conn.queue = []
        conn.multi_err = False
        return conn

    def _load_aof(self) -> None:
        try:
            f = open(self.data_path, "rb")
        except FileNotFoundError:
            return
        conn = self._replay_conn()
        n = 0
        txn_buf: Optional[list] = None  # records between MULTI and EXEC

        def apply(parts) -> None:
            nonlocal n
            name = parts[0].upper().decode("ascii", "replace").lower()
            handler = getattr(conn, "cmd_" + name, None)
            if handler is not None:
                handler(parts[1:])
                n += 1

        with f:
            while True:
                try:
                    line = f.readline()
                    if not line:
                        break
                    if not line.startswith(b"*"):
                        logger.warning("aof: garbled record; stopping replay")
                        break
                    parts = []
                    for _ in range(int(line[1:])):
                        hdr = f.readline()
                        ln = int(hdr[1:])
                        data = f.read(ln + 2)[:-2]
                        if len(data) != ln:
                            raise EOFError
                        parts.append(data)
                    if not parts:
                        raise ValueError("empty record")
                except Exception:
                    # torn/garbled tail (crash mid-append): keep the
                    # consistent prefix, never refuse to boot
                    logger.warning("aof: torn tail record ignored")
                    break
                op = parts[0].upper()
                if op == b"MULTI":
                    txn_buf = []
                elif op == b"EXEC":
                    for rec in txn_buf or ():
                        apply(rec)
                    txn_buf = None
                elif txn_buf is not None:
                    txn_buf.append(parts)
                else:
                    apply(parts)
        if txn_buf is not None:
            # crash mid-transaction: the whole txn is discarded, keeping
            # metadata invariants (no half-applied mkdir/rename)
            logger.warning("aof: unterminated transaction of %d records "
                           "discarded", len(txn_buf))
        if n:
            logger.info("aof: replayed %d mutations from %s", n, self.data_path)

    def _rewrite_aof(self) -> None:
        """Compact the log into a snapshot of current state."""
        tmp = self.data_path + ".tmp"
        with open(tmp, "wb") as f:
            for i, db in enumerate(self.dbs):
                if not db.data and not db.zsets:
                    continue
                f.write(_Conn._enc([b"SELECT", str(i).encode()]))
                for k, v in db.data.items():
                    f.write(_Conn._enc([b"SET", k, v]))
                for name, members in db.zsets.items():
                    for m in members:
                        f.write(_Conn._enc([b"ZADD", name, b"0", m]))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.data_path)
        self._aof = open(self.data_path, "ab")
        # the snapshot may end in any db: -1 forces the next append to
        # emit its own SELECT (0 here would mis-route db-0 writes into
        # whatever db the snapshot finished on at replay time)
        self._aof_db = -1

    def _fsync_loop(self) -> None:
        while not self._aof_stop.wait(1.0):
            fd = -1
            with self.lock:  # flush the buffered writer under the lock...
                if self._aof is not None:
                    self._aof.flush()
                    fd = self._aof.fileno()
            if fd >= 0:  # ...but fsync outside it: a slow disk must not
                try:     # stall every client command for the fsync
                    os.fsync(fd)
                except OSError:
                    pass

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> int:
        if not self._pub_thread.is_alive():  # re-start after a stop()
            self._pub_thread = threading.Thread(
                target=self._pub_loop, daemon=True, name="pubsub-deliver"
            )
            self._pub_thread.start()
        if self.data_path:
            with self.lock:
                self._replaying = True
                try:
                    self._load_aof()
                finally:
                    self._replaying = False
                self._rewrite_aof()
            if self.fsync != "always":
                threading.Thread(
                    target=self._fsync_loop, name="aof-fsync", daemon=True
                ).start()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                _Conn(outer, self.request).serve()

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Srv((self.host, self.port), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="redis-server", daemon=True
        )
        self._thread.start()
        if self.replica_of:
            self._parse_primary(self.replica_of)  # fail fast on bad addr
            self._repl_stop.clear()
            threading.Thread(
                target=self._replica_pull_loop, daemon=True,
                name="repl-pull",
            ).start()
        return self.port

    def stop(self) -> None:
        self._repl_stop.set()
        pull = self._repl_pull_conn
        if pull is not None:
            pull.close()  # unblocks a replica parked in read_reply
        if self._repl_thread is not None and self._repl_thread.is_alive():
            self._repl_q.put(None)
            self._repl_thread.join(timeout=10.0)
            self._repl_thread = None
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
        with self.lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                # shutdown, not just close: the handler's makefile reader
                # holds the fd, so close() alone would leave the TCP
                # stream fully functional until the handler exits
                c.sock.shutdown(socket.SHUT_RDWR)
                c.sock.close()
            except OSError:
                logger.debug("stale conn close raced its own teardown")
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._pub_thread.is_alive():
            # sentinel: drain then exit the delivery loop.  Guarded so a
            # second stop() cannot park a stale sentinel in the queue
            # that would kill the freshly re-spawned loop on restart.
            self._pub_q.put(None)
            self._pub_thread.join(timeout=10.0)
        self._aof_stop.set()
        with self.lock:
            if self._aof is not None:
                self._aof.flush()
                try:
                    os.fsync(self._aof.fileno())
                except OSError:
                    pass
                self._aof.close()
                self._aof = None

    def wait(self) -> None:
        """Block until the server stops (or interrupt → stop)."""
        try:
            if self._thread is not None:
                self._thread.join()
        except KeyboardInterrupt:
            self.stop()

    def serve_forever(self) -> None:
        """Blocking standalone serve (CLI `meta-server`)."""
        self.start()
        self.wait()


class _Conn:
    """One client connection: RESP parsing + command dispatch."""

    def __init__(self, server: RedisServer, sock: socket.socket):
        self.server = server
        self.sock = sock
        # without NODELAY every pipelined reply pair costs a ~40ms
        # Nagle/delayed-ACK stall
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = sock.makefile("rb")
        self.db = server.dbs[0]
        self.db_idx = 0
        self.watched: dict[bytes, int] = {}
        self.in_multi = False
        self.queue: list[list[bytes]] = []
        self.multi_err = False
        self.subscribed: set[bytes] = set()
        self.wlock = threading.Lock()  # replies vs async pub/sub pushes

    # ---- RESP ------------------------------------------------------------
    def _read_cmd(self) -> Optional[list[bytes]]:
        line = self.rfile.readline()
        if not line:
            return None
        if not line.startswith(b"*"):
            # inline command (telnet-style); not used by our client
            return line.strip().split()
        n = int(line[1:])
        parts = []
        for _ in range(n):
            hdr = self.rfile.readline()
            if not hdr.startswith(b"$"):
                raise ValueError("protocol error")
            ln = int(hdr[1:])
            data = self.rfile.read(ln + 2)[:-2]
            parts.append(data)
        return parts

    def _send(self, payload: bytes) -> None:
        with self.wlock:
            self.sock.sendall(payload)

    def _send_push(self, payload: bytes) -> None:
        """Async pub/sub push with a send timeout: a subscriber with a
        full receive buffer is dropped, not waited on."""
        with self.wlock:
            old = self.sock.gettimeout()
            self.sock.settimeout(1.0)
            try:
                self.sock.sendall(payload)
            finally:
                try:
                    self.sock.settimeout(old)
                except OSError:
                    pass

    @staticmethod
    def _enc(obj) -> bytes:
        if obj is None:
            return b"$-1\r\n"
        if isinstance(obj, _Raw):
            return obj.payload
        if isinstance(obj, _Err):
            return b"-" + obj.msg.encode() + b"\r\n"
        if isinstance(obj, _Status):
            return b"+" + obj.msg.encode() + b"\r\n"
        if isinstance(obj, int):
            return b":" + str(obj).encode() + b"\r\n"
        if isinstance(obj, bytes):
            return b"$" + str(len(obj)).encode() + b"\r\n" + obj + b"\r\n"
        if isinstance(obj, (list, tuple)):
            if obj is NIL_ARRAY:
                return b"*-1\r\n"
            return b"*" + str(len(obj)).encode() + b"\r\n" + b"".join(
                _Conn._enc(o) for o in obj
            )
        raise TypeError(f"cannot encode {type(obj)}")

    # ---- serve loop ------------------------------------------------------
    def serve(self) -> None:
        with self.server.lock:
            self.server._conns.add(self)
        try:
            while True:
                cmd = self._read_cmd()
                if cmd is None or not cmd:
                    return
                name = cmd[0].upper()
                if name == b"QUIT":
                    self._send(b"+OK\r\n")
                    return
                out = self.dispatch(name, cmd[1:])
                self._send(self._enc(out))
        except (ConnectionError, ValueError, OSError):
            pass
        finally:
            with self.server.lock:
                self.server._conns.discard(self)
                for ch in self.subscribed:
                    conns = self.server.subscribers.get(ch)
                    if conns is not None:
                        conns.discard(self)
                        if not conns:
                            self.server.subscribers.pop(ch, None)
                if self in self.server.replicas:
                    self.server.replicas.remove(self)
            try:
                self.sock.close()
            except OSError:
                pass

    def dispatch(self, name: bytes, args: list[bytes]):
        if self.in_multi and name not in (b"EXEC", b"DISCARD", b"MULTI", b"WATCH"):
            self.queue.append([name] + args)
            return _Status("QUEUED")
        handler = getattr(self, "cmd_" + name.decode().lower(), None)
        if handler is None:
            return _Err(f"ERR unknown command '{name.decode()}'")
        with self.server.lock:
            # a command short of its arguments, or with a number that is
            # not one, is answered as Redis answers it; the reference's
            # server drops the connection on either
            try:
                return handler(args)
            except IndexError:
                return _Err("ERR wrong number of arguments for "
                            f"'{name.decode().lower()}' command")
            except ValueError:
                return _Err("ERR value is not an integer or out of range")

    # ---- commands --------------------------------------------------------
    def cmd_ping(self, args):
        return _Status("PONG") if not args else args[0]

    # ---- pub/sub (ephemeral; reference redis pub/sub subset) -------------
    def cmd_subscribe(self, args):
        out = []
        for ch in args:
            self.server.subscribers.setdefault(ch, set()).add(self)
            self.subscribed.add(ch)
            out.append(_Raw(_Conn._enc([b"subscribe", ch, len(self.subscribed)])))
        return _Raw(b"".join(r.payload for r in out))

    def cmd_unsubscribe(self, args):
        out = b""
        for ch in (args or list(self.subscribed)):
            conns = self.server.subscribers.get(ch)
            if conns is not None:
                conns.discard(self)
                if not conns:
                    self.server.subscribers.pop(ch, None)
            self.subscribed.discard(ch)
            out += _Conn._enc([b"unsubscribe", ch, len(self.subscribed)])
        return _Raw(out)

    def cmd_publish(self, args):
        ch, msg = args[0], args[1]
        conns = list(self.server.subscribers.get(ch, ()))
        if conns:
            # enqueue for the single delivery thread: never blocks the
            # dispatch lock, preserves per-channel ordering
            push = _Conn._enc([b"message", ch, msg])
            self.server._pub_q.put((ch, push, conns))
        return len(conns)

    def cmd_echo(self, args):
        return args[0]

    def _log(self, name: bytes, args) -> None:
        self.server.aof_append(self.db_idx, [name] + list(args))
        self.server.repl_append(self.db_idx, [name] + list(args))

    def cmd_sync(self, args):
        """Register this connection as a replica: a consistent snapshot is
        queued first (same delivery queue as live forwards, so ordering
        holds), then every committed mutation streams as plain commands."""
        srv = self.server
        srv._ensure_repl_thread()
        payload = srv._snapshot_payload()
        srv.replicas.append(self)
        srv._repl_q.put((payload, [self]))
        return _Raw(b"")  # the stream itself is the reply

    def cmd_select(self, args):
        idx = int(args[0])
        if not 0 <= idx < len(self.server.dbs):
            return _Err("ERR DB index is out of range")
        self.db = self.server.dbs[idx]
        self.db_idx = idx
        return _Status("OK")

    def cmd_flushdb(self, args):
        self.db.data.clear()
        self.db.zsets.clear()
        # bump everything watched so concurrent txns abort
        for k in list(self.db.versions):
            self.db.bump(k)
        self._log(b"FLUSHDB", [])
        return _Status("OK")

    def cmd_dbsize(self, args):
        return len(self.db.data)

    def cmd_get(self, args):
        return self.db.data.get(args[0])

    def cmd_mget(self, args):
        return [self.db.data.get(k) for k in args]

    def cmd_set(self, args):
        self.db.data[args[0]] = args[1]
        self.db.bump(args[0])
        self._log(b"SET", args[:2])
        return _Status("OK")

    def cmd_del(self, args):
        n = 0
        for k in args:
            if k in self.db.data:
                del self.db.data[k]
                n += 1
            self.db.bump(k)
        self._log(b"DEL", args)
        return n

    def cmd_exists(self, args):
        return sum(1 for k in args if k in self.db.data)

    def cmd_incrby(self, args):
        cur = int(self.db.data.get(args[0], b"0"))
        cur += int(args[1])
        self.db.data[args[0]] = str(cur).encode()
        self.db.bump(args[0])
        # logged as the absolute SET: replay is idempotent
        self._log(b"SET", [args[0], str(cur).encode()])
        return cur

    def cmd_zadd(self, args):
        # subset: ZADD key 0 member [0 member ...]
        zs = self.db.zsets.setdefault(args[0], [])
        added = 0
        for i in range(1, len(args), 2):
            member = args[i + 1]
            j = bisect.bisect_left(zs, member)
            if j >= len(zs) or zs[j] != member:
                zs.insert(j, member)
                added += 1
        self.db.bump(args[0])
        self._log(b"ZADD", args)
        return added

    def cmd_zrem(self, args):
        zs = self.db.zsets.get(args[0], [])
        removed = 0
        for member in args[1:]:
            j = bisect.bisect_left(zs, member)
            if j < len(zs) and zs[j] == member:
                zs.pop(j)
                removed += 1
        self.db.bump(args[0])
        self._log(b"ZREM", args)
        return removed

    def cmd_zcard(self, args):
        return len(self.db.zsets.get(args[0], []))

    def cmd_zrangebylex(self, args):
        zs = self.db.zsets.get(args[0], [])
        lo = self._lex_bound(args[1], zs, True)
        hi = self._lex_bound(args[2], zs, False)
        out = zs[lo:hi]
        if len(args) >= 6 and args[3].upper() == b"LIMIT":
            off, cnt = int(args[4]), int(args[5])
            out = out[off:] if cnt < 0 else out[off:off + cnt]
        return list(out)

    @staticmethod
    def _lex_bound(spec: bytes, zs: list[bytes], is_min: bool) -> int:
        if spec == b"-":
            return 0
        if spec == b"+":
            return len(zs)
        if spec.startswith(b"["):
            v = spec[1:]
            return bisect.bisect_left(zs, v) if is_min else bisect.bisect_right(zs, v)
        if spec.startswith(b"("):
            v = spec[1:]
            return bisect.bisect_right(zs, v) if is_min else bisect.bisect_left(zs, v)
        raise ValueError("bad lex range")

    # ---- transactions ----------------------------------------------------
    def cmd_watch(self, args):
        if self.in_multi:
            return _Err("ERR WATCH inside MULTI is not allowed")
        for k in args:
            self.watched[k] = self.db.versions.get(k, 0)
        return _Status("OK")

    def cmd_unwatch(self, args):
        self.watched.clear()
        return _Status("OK")

    def cmd_multi(self, args):
        if self.in_multi:
            return _Err("ERR MULTI calls can not be nested")
        self.in_multi = True
        self.queue = []
        return _Status("OK")

    def cmd_discard(self, args):
        self.in_multi = False
        self.queue = []
        self.watched.clear()
        return _Status("OK")

    def cmd_exec(self, args):
        if not self.in_multi:
            return _Err("ERR EXEC without MULTI")
        self.in_multi = False
        queue, self.queue = self.queue, []
        with self.server.lock:
            for k, ver in self.watched.items():
                if self.db.versions.get(k, 0) != ver:
                    self.watched.clear()
                    return NIL_ARRAY  # conflict: txn aborted
            self.watched.clear()
            # AOF atomicity: the queued mutations log between MULTI/EXEC
            # markers; replay applies them all-or-nothing, so a crash can
            # never persist half a metadata transaction (Redis AOF wraps
            # transactions the same way). fsync happens once, after EXEC.
            # Replication gets the same markers: replicas apply the whole
            # batch atomically, so their readers never see a torn txn.
            self.server.aof_txn_begin(self.db_idx)
            self.server.repl_append(self.db_idx, [b"MULTI"])
            try:
                out = []
                for q in queue:
                    handler = getattr(self, "cmd_" + q[0].decode().lower(), None)
                    out.append(
                        handler(q[1:]) if handler else _Err("ERR unknown command")
                    )
            finally:
                self.server.aof_txn_end()
                self.server.repl_append(self.db_idx, [b"EXEC"])
            return out


class _Raw:
    """Pre-encoded RESP payload (pub/sub confirmations are multi-reply)."""

    def __init__(self, payload: bytes):
        self.payload = payload


class _Status:
    __slots__ = ("msg",)

    def __init__(self, msg: str):
        self.msg = msg


class _Err(_Status):
    pass


NIL_ARRAY: list = []


def main(argv=None) -> int:
    """Delegates to the one canonical arg parser (cmd/meta_server.py) so
    the two entry points can never drift."""
    from ..cmd import main as cmd_main

    return cmd_main(["meta-server"] + list(argv or []))


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
