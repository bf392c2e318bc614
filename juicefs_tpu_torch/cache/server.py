"""Peer block server: serve the local block cache to cache-group peers
(a copy of juicefs_tpu/cache/server.py; the wire format is the same, so
either package's CacheGroup reads from either package's server).

A deliberately tiny read-only HTTP surface (stdlib http.server, JSON/raw
bytes — the same dependency posture as the sync cluster manager):

    GET  /block/{key}   raw cached block bytes; 404 when not cached
    HEAD /block/{key}   presence probe: size + digest headers, no body
    GET  /ring          membership/identity snapshot (debugging, and the
                        target of peer-breaker half-open probes)
    POST /warm/{key}    ring-aware warm hint: enqueue `key` on
                        THIS member's prefetch stage (PREFETCH class,
                        bounded, sheddable) so the ring owner fills its
                        own cache from the object store; 202 = accepted.
                        No request body is honored — a peer can ask this
                        node to warm a block, never to store peer bytes.

Every block response carries `X-Block-Crc32` (crc32 of the payload) so a
client can reject a wrong-block serve during membership churn — a peer
with a stale ring may be asked for a key it legitimately has, but a
corrupt or mismatched payload must never enter the reader's cache.

Serves from the DiskCache/MemCache raw tier AND from writeback staging
(`_pending_staged`): a block a peer wrote but has not uploaded yet is
exactly the block the object store cannot serve.  Peers can never write
data into each other's caches — the only mutation a peer can cause is a
warm hint, which makes this node fetch its OWN verified copy from the
object store through its bounded prefetch stage.
"""

from __future__ import annotations

import json
import socket
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer that can hard-close its live connections.
    Clients hold keep-alive sockets; a plain shutdown() only stops the
    accept loop, leaving handler threads serving those sockets — a
    stopped peer must actually go dark (tests kill it to drill the
    fall-through path, and a real unmount must not linger)."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._conns: set = set()
        self._conns_mu = threading.Lock()

    def process_request(self, request, client_address):
        with self._conns_mu:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        # normal connection teardown (miss responses send Connection:
        # close, so peers reconnect often): forget the socket, or the
        # tracking set grows one dead object per served connection
        with self._conns_mu:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self) -> None:
        with self._conns_mu:
            conns, self._conns = list(self._conns), set()
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

from ..metric import global_registry
from ..utils import get_logger

logger = get_logger("cache.server")

_reg = global_registry()
_SERVED = _reg.counter(
    "juicefs_cache_group_served",
    "Peer block requests answered from the local cache",
    ("op",),
)
_SERVED_BYTES = _reg.counter(
    "juicefs_cache_group_served_bytes",
    "Bytes served to cache-group peers from the local cache",
)
_SERVE_MISSES = _reg.counter(
    "juicefs_cache_group_serve_misses",
    "Peer block requests this node could not serve (not cached here)",
)
_WARM_REQS = _reg.counter(
    "juicefs_cache_group_warm_requests",
    "Warm hints accepted from peers (enqueued on the local prefetch "
    "stage; rejected malformed hints are not counted)",
)


class PeerBlockServer:
    """HTTP server exporting one CachedStore's block cache to the group."""

    def __init__(self, store, group: str = ""):
        self.store = store
        self.group = group
        self.addr = ""
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lookup ------------------------------------------------------------
    def _lookup(self, key: str) -> bytes | None:
        from ..chunk.cached_store import parse_block_key

        if parse_block_key(key) is None:
            return None  # only well-formed block keys; no path games
        data = self.store.cache.load(key, count_miss=False)
        if data is None:
            # spilled staged entries (past the RAM cap) re-read their file
            data = self.store._staged_lookup(key)
        return data

    def _warm(self, key: str) -> bool:
        """Ring-aware warm hint: enqueue `key` on the local prefetch
        stage.  The block size rides in the key itself (block keys are
        `{id}_{indx}_{bsize}`), so a hint can never make this node fetch
        at a size the key does not pin.  Bounded + sheddable: a flood of
        hints degrades to later demand reads, never to foreground work.

        A hint for a key THIS node's ring view does not place here is
        absorbed (202, no enqueue): during membership churn two members
        can each believe the other owns a key, and enqueueing it would
        make `_prefetch_block` forward the hint straight back — a
        self-sustaining ping-pong per key for as long as the views
        diverge."""
        from ..chunk.cached_store import parse_block_key

        parsed = parse_block_key(key)
        if parsed is None or parsed[2] <= 0:
            return False  # only well-formed block keys; no path games
        try:
            group = getattr(self.store, "cache_group", None)
            if group is not None and not group.owns(key):
                return True  # stale-ring hint: absorb, never bounce it back
            _WARM_REQS.inc()
            self.store.prefetcher.fetch((key, parsed[2]))
            return True
        except Exception as e:
            # a hint is advisory: an internal error must neither kill the
            # handler thread nor desync the keep-alive socket — answer
            # 400 (the sender's breaker sees a sick peer) and move on
            logger.warning("warm hint %s degraded: %s", key, e)
            return False

    def ring_view(self) -> dict:
        group = getattr(self.store, "cache_group", None)
        view = {"group": self.group, "addr": self.addr}
        if group is not None:
            view.update(ring_size=len(group.ring),
                        members=group.ring.members)
        return view

    # -- lifecycle ---------------------------------------------------------
    def start(self, listen: str = "127.0.0.1:0") -> str:
        """Bind + serve on a daemon thread; returns the bound host:port
        (port 0 auto-picks, the address peers will dial)."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _block(self, send_body: bool) -> None:
                key = self.path[len("/block/"):].split("?", 1)[0]
                data = server._lookup(key)
                if data is None:
                    _SERVE_MISSES.inc()
                    self.send_error(404)
                    return
                data = bytes(data)
                _SERVED.labels("get" if send_body else "head").inc()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-Block-Crc32", str(zlib.crc32(data)))
                # echo the key the server RESOLVED: the client rejects a
                # mismatched echo (routing mix-up = wrong-block serve)
                self.send_header("X-Block-Key", key)
                self.end_headers()
                if send_body:
                    _SERVED_BYTES.inc(len(data))
                    self.wfile.write(data)

            def _json(self, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path.startswith("/block/"):
                    self._block(send_body=True)
                elif self.path.split("?", 1)[0] == "/ring":
                    self._json(server.ring_view())
                else:
                    self.send_error(404)

            def do_HEAD(self):  # noqa: N802
                if self.path.startswith("/block/"):
                    self._block(send_body=False)
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802
                # drain any body first: a keep-alive connection with an
                # unread body would desync the next request on the socket
                try:
                    ln = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    self.send_error(400)
                    self.close_connection = True
                    return
                if ln > 1 << 20:
                    # oversized body: a partial drain would desync the
                    # socket — refuse and drop the connection instead
                    self.send_error(413)
                    self.close_connection = True
                    return
                if ln:
                    self.rfile.read(ln)
                if self.path.startswith("/warm/"):
                    key = self.path[len("/warm/"):].split("?", 1)[0]
                    if server._warm(key):
                        self.send_response(202)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                    else:
                        self.send_error(400)
                else:
                    self.send_error(404)

            def log_message(self, *a):
                pass

        host, _, port = listen.rpartition(":")
        self._httpd = _Server((host or "127.0.0.1", int(port or 0)), Handler)
        self.addr = (f"{self._httpd.server_address[0]}:"
                     f"{self._httpd.server_address[1]}")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"peer-cache-{self.addr}",
        )
        self._thread.start()
        logger.info("cache-group %r peer server on %s", self.group, self.addr)
        return self.addr

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.close_all_connections()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
