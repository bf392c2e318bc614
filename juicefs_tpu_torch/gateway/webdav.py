"""WebDAV server over the FileSystem SDK (a copy of
juicefs_tpu/gateway/webdav.py; reference pkg/fs/http.go:84 webdavFS over
golang.org/x/net/webdav).

Class-1 DAV: OPTIONS, PROPFIND (depth 0/1), GET/HEAD/PUT/DELETE, MKCOL,
MOVE, COPY — the operations litmus and common DAV clients (davfs2, cadaver,
macOS Finder) use for file management.
"""

from __future__ import annotations

import errno as _errno
import posixpath
import urllib.parse
from xml.sax.saxutils import escape

from ..meta.types import TYPE_DIRECTORY
from ..utils import get_logger
from ..fs import FSError, FileSystem
from . import BaseHandler, HTTPAdapter
from .serve import UNSATISFIABLE, parse_range, stream_body_in, stream_file_out

logger = get_logger("gateway.webdav")


class WebDAVServer(HTTPAdapter):
    _name = "webdav"

    def __init__(self, fs: FileSystem, address: str = "127.0.0.1", port: int = 9007):
        super().__init__(address, port)
        self.fs = fs
        dav = self

        class Handler(BaseHandler):
            def log_message(self, fmt, *args):
                logger.debug(fmt, *args)

            def _path(self) -> str:
                return urllib.parse.unquote(
                    urllib.parse.urlsplit(self.path).path
                ) or "/"

            def _err(self, e: FSError):
                code = {
                    _errno.ENOENT: 404,
                    _errno.EEXIST: 405,
                    _errno.ENOTEMPTY: 409,
                    _errno.EACCES: 403,
                    _errno.EPERM: 403,
                    _errno.EISDIR: 405,
                    _errno.ENOTDIR: 409,
                }.get(e.errno, 500)
                self._empty(code)

            def do_OPTIONS(self):
                self._empty(200, {"DAV": "1,2", "Allow":
                                  "OPTIONS, PROPFIND, GET, HEAD, PUT, DELETE, "
                                  "MKCOL, MOVE, COPY"})

            def do_PROPFIND(self):
                self._body()
                path = self._path()
                depth = self.headers.get("Depth", "1")
                try:
                    items = dav._propfind(path, depth)
                except FSError as e:
                    return self._err(e)
                body = ('<?xml version="1.0" encoding="utf-8"?>'
                        '<D:multistatus xmlns:D="DAV:">' + "".join(items) +
                        "</D:multistatus>").encode()
                self.send_response(207)
                self.send_header("Content-Type", 'application/xml; charset="utf-8"')
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                """Streaming GET on the same read path as the S3 gateway:
                block-sized spans ride the vfs
                streaming reader — never one whole-object RAM buffer —
                and Range semantics come from the ONE shared parser
                (gateway/serve.py parse_range)."""
                try:
                    attr = dav.fs.stat(self._path())
                    if attr.typ == TYPE_DIRECTORY:
                        return self._empty(405)
                except FSError as e:
                    return self._err(e)
                total = attr.length
                rng = parse_range(self.headers.get("Range", ""), total)
                if rng is UNSATISFIABLE:
                    return self._empty(416)
                if rng is None:
                    start, end, code = 0, total - 1, 200
                else:
                    (start, end), code = rng, 206
                length = end - start + 1 if total else 0
                if not length:
                    self.send_response(code)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                # first span BEFORE the headers commit: a failing read
                # still maps to a clean error; only a mid-stream failure
                # degrades to a closed connection
                try:
                    with dav.fs.open(self._path()) as f:
                        span = dav._span()
                        first = f.pread(start, min(span, length))
                        self.send_response(code)
                        if code == 206:
                            self.send_header(
                                "Content-Range",
                                f"bytes {start}-{end}/{total}")
                        self.send_header("Content-Length", str(length))
                        self.end_headers()
                        self.wfile.write(first)
                        sent = len(first)
                        if sent == len(first) and sent < length:
                            try:
                                sent += stream_file_out(
                                    self.wfile, f, start + sent,
                                    length - sent, span)
                            except OSError:
                                pass  # headers committed: close below
                except FSError as e:
                    return self._err(e)
                if sent < length:
                    self.close_connection = True  # truncated mid-stream

            def do_HEAD(self):
                try:
                    attr = dav.fs.stat(self._path())
                except FSError as e:
                    return self._err(e)
                self._empty(200, {"Content-Length": str(attr.length)})

            def do_PUT(self):
                """Streaming PUT: the body flows into the vfs writer in
                block-sized pieces (ingest/dedup/compress engage), same
                data path as S3 PUT — including the temp+rename publish,
                so a failed overwrite never destroys the previous
                version of the resource."""
                import uuid as _uuid

                path = self._path()
                length = self._remaining()
                tmp = f"/.sys/tmp/{_uuid.uuid4().hex}"
                try:
                    parent = posixpath.dirname(path.rstrip("/"))
                    if parent and parent != "/" and not dav.fs.exists(parent):
                        self._drain()
                        return self._empty(409)  # RFC: no implicit collections
                    dav.fs.makedirs("/.sys/tmp")
                    with dav.fs.create(tmp) as f:
                        _et, got, _ok = stream_body_in(
                            self.rfile, f, length, dav._span(),
                            consumed=self._note_consumed)
                except FSError as e:
                    self._drain()
                    dav._discard(tmp)
                    return self._err(e)
                if got < length:
                    # client truncated the body: drop the temp and the
                    # (desynced) connection — the live resource, if
                    # any, is untouched
                    dav._discard(tmp)
                    self.close_connection = True
                    return self._empty(400)
                try:
                    dav.fs.rename(tmp, path)
                except FSError as e:
                    dav._discard(tmp)
                    return self._err(e)
                self._empty(201)

            def do_DELETE(self):
                path = self._path()
                try:
                    if not dav.fs.exists(path):
                        return self._empty(404)  # RFC 4918: missing -> 404
                    dav.fs.remove_all(path)
                except FSError as e:
                    return self._err(e)
                self._empty(204)

            def do_MKCOL(self):
                if self._body():
                    return self._empty(415)
                try:
                    dav.fs.mkdir(self._path().rstrip("/"))
                except FSError as e:
                    if e.errno == _errno.ENOENT:
                        return self._empty(409)  # missing parent (RFC 4918)
                    if e.errno == _errno.EEXIST:
                        return self._empty(405)  # already exists (RFC 4918)
                    return self._err(e)
                self._empty(201)

            def _dest(self) -> str | None:
                dst = self.headers.get("Destination")
                if not dst:
                    return None
                return urllib.parse.unquote(urllib.parse.urlsplit(dst).path)

            def do_MOVE(self):
                dst = self._dest()
                if not dst:
                    return self._empty(400)
                try:
                    overwrote = dav.fs.exists(dst)
                    if overwrote:
                        if self.headers.get("Overwrite", "T") == "F":
                            return self._empty(412)
                        dav.fs.remove_all(dst)
                    dav.fs.rename(self._path().rstrip("/"), dst.rstrip("/"))
                except FSError as e:
                    return self._err(e)
                self._empty(204 if overwrote else 201)

            def do_COPY(self):
                dst = self._dest()
                if not dst:
                    return self._empty(400)
                try:
                    attr = dav.fs.stat(self._path())
                    if attr.typ == TYPE_DIRECTORY:
                        return self._empty(403)  # file copies only
                    overwrote = dav.fs.exists(dst)
                    if overwrote and self.headers.get("Overwrite", "T") == "F":
                        return self._empty(412)
                    if dst == self._path():
                        # copy onto itself: truncating the destination
                        # would destroy the source — a no-op replace
                        return self._empty(204)
                    # server-side slice share: no data bytes move
                    with dav.fs.create(dst):
                        pass
                    dav.fs.copy_range(self._path(), dst)
                except FSError as e:
                    return self._err(e)
                self._empty(204 if overwrote else 201)

        self._handler_cls = Handler

    def _span(self) -> int:
        """Streaming span: one block per piece, the same granularity the
        chunk store caches and the readahead window grows by."""
        return int(self.fs.vfs.store.conf.block_size)

    def _discard(self, path: str) -> None:
        try:
            self.fs.unlink(path)
        except FSError:
            pass  # unwind of a failed PUT: the temp may never have landed

    def _propfind(self, path: str, depth: str) -> list[str]:
        attr = self.fs.stat(path)
        items = [self._propstat(path, attr)]
        if depth != "0" and attr.typ == TYPE_DIRECTORY:
            for e in self.fs.listdir(path, want_attr=True):
                child = posixpath.join(path, e.name.decode())
                if e.attr is not None:
                    items.append(self._propstat(child, e.attr))
        return items

    @staticmethod
    def _propstat(path: str, attr) -> str:
        is_dir = attr.typ == TYPE_DIRECTORY
        href = urllib.parse.quote(path + ("/" if is_dir and path != "/" else ""))
        rtype = "<D:collection/>" if is_dir else ""
        length = "" if is_dir else f"<D:getcontentlength>{attr.length}</D:getcontentlength>"
        return (f"<D:response><D:href>{escape(href)}</D:href><D:propstat><D:prop>"
                f"<D:resourcetype>{rtype}</D:resourcetype>{length}"
                f"</D:prop><D:status>HTTP/1.1 200 OK</D:status></D:propstat>"
                f"</D:response>")

