"""HTTP presentation adapters (a copy of juicefs_tpu/gateway; reference:
pkg/gateway + pkg/fs/http.go).

Serves the volume over the S3 REST API (buckets = top-level directories;
reference gateway.go:65 NewJFSGateway) and WebDAV (`webdav.py`). Shared
here: the request-handler base (body/empty-response helpers) and the
threaded server lifecycle both adapters use.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..metric.trace import global_tracer

_TR = global_tracer()


class BaseHandler(BaseHTTPRequestHandler):
    """Common helpers for the S3 and WebDAV handlers."""

    protocol_version = "HTTP/1.1"

    def parse_request(self):
        """Open the gateway root span only once a request line has been
        parsed — the keep-alive idle wait before it must not be timed,
        and a client disconnect must not emit a phantom span."""
        ok = super().parse_request()
        if ok and _TR.active:
            self._gw_span = _TR.span(
                "gateway", (self.command or "request").lower(),
                path=self.path, adapter=type(self).__name__,
            )
            self._gw_span.__enter__()
        return ok

    def handle_one_request(self):
        self._gw_span = None
        self._consumed = 0  # request-body bytes already read off rfile
        try:
            super().handle_one_request()
        finally:
            sp = self._gw_span
            self._gw_span = None
            if sp is not None:
                sp.__exit__(None, None, None)

    def _remaining(self) -> int:
        n = int(self.headers.get("Content-Length", 0) or 0)
        return max(0, n - getattr(self, "_consumed", 0))

    def _note_consumed(self, n: int) -> None:
        """Credit body bytes a streaming helper read off rfile."""
        self._consumed += n

    def _body(self) -> bytes:
        """Buffer the (remaining) request body — control payloads only;
        object data paths stream through gateway/serve.py instead."""
        remaining, chunks = self._remaining(), []
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, 1 << 20))
            if not chunk:
                break
            chunks.append(chunk)
            self._consumed += len(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def _drain(self) -> None:
        """Discard the unread body so an error reply does not desync the
        keep-alive stream (idempotent: already-streamed bytes count)."""
        remaining = self._remaining()
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, 1 << 20))
            if not chunk:
                break
            self._consumed += len(chunk)
            remaining -= len(chunk)

    def _empty(self, code: int = 200, headers: dict | None = None):
        headers = headers or {}
        self.send_response(code)
        for k, v in headers.items():
            self.send_header(k, v)
        if "Content-Length" not in headers:
            self.send_header("Content-Length", "0")
        self.end_headers()


class HTTPAdapter:
    """start()/stop() lifecycle shared by the S3 gateway and WebDAV."""

    _name = "http"

    def __init__(self, address: str, port: int):
        self.address = address
        self.port = port
        self._server: ThreadingHTTPServer | None = None
        self._handler_cls: type | None = None

    def start(self) -> int:
        self._server = ThreadingHTTPServer((self.address, self.port), self._handler_cls)
        self.port = self._server.server_address[1]
        threading.Thread(
            target=self._server.serve_forever, daemon=True, name=self._name
        ).start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


from .s3 import S3Gateway  # noqa: E402

__all__ = ["S3Gateway", "BaseHandler", "HTTPAdapter"]
