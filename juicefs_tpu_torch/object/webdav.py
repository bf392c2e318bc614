"""WebDAV object storage driver (a copy of juicefs_tpu/object/webdav.py;
reference pkg/object/webdav.go).

Speaks Class-1 DAV over HTTP: GET (with Range, falling back to a full
read when the server ignores it), PUT (creating missing parent
collections on 409), DELETE, HEAD, and recursive Depth-1 PROPFIND for
listings. Tested against this framework's own WebDAV gateway and any
RFC 4918 server. URI: webdav://host:port/base/path
"""

from __future__ import annotations

import http.client
import posixpath
import urllib.parse
import xml.etree.ElementTree as ET
from email.utils import parsedate_to_datetime

from .interface import NotFoundError, Obj, ObjectStorage

_DAV = "{DAV:}"


class WebDAVStorage(ObjectStorage):
    def __init__(self, addr: str):
        # host[:port][/base]
        hostpart, _, base = addr.partition("/")
        host, _, port = hostpart.partition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 80)
        self.base = "/" + base.strip("/")
        if self.base != "/":
            self.base += "/"
        import threading

        self._local = threading.local()  # per-thread keep-alive connection

    def string(self) -> str:
        return f"webdav://{self.host}:{self.port}{self.base}"

    # -- plumbing ----------------------------------------------------------
    def _url(self, key: str) -> str:
        return self.base + urllib.parse.quote(key)

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self.host, self.port, timeout=60)
            self._local.conn = conn
        return conn

    def _request(self, method: str, key: str, body: bytes | None = None,
                 headers: dict | None = None):
        return self._do(method, self._url(key), body, headers)

    def _request_abs(self, method: str, abspath: str,
                     body: bytes | None = None, headers: dict | None = None):
        """Like _request but with a server-absolute path (no base prefix)."""
        return self._do(method, urllib.parse.quote(abspath), body, headers)

    def _do(self, method: str, quoted_path: str, body, headers):
        """Keep-alive request with one redial on a broken connection
        (same pattern as S3Storage._conn — a fresh TCP handshake per
        block op would dominate small-op latency)."""
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request(method, quoted_path, body=body,
                             headers=headers or {})
                resp = conn.getresponse()
                data = resp.read()
                return resp.status, dict(resp.getheaders()), data
            except (http.client.HTTPException, OSError):
                conn.close()
                self._local.conn = None
                if attempt:
                    raise

    def _check(self, status: int, key: str, ok=(200, 201, 204, 206, 207)):
        if status == 404:
            raise NotFoundError(key)
        if status not in ok:
            raise IOError(f"webdav {key}: HTTP {status}")

    # -- ObjectStorage -----------------------------------------------------
    def create(self) -> None:
        self._mkcols("")  # ensure the base collection exists

    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        headers = {}
        ranged = off > 0 or limit >= 0
        if ranged:
            end = "" if limit < 0 else str(off + limit - 1)
            headers["Range"] = f"bytes={off}-{end}"
        status, _, data = self._request("GET", key, headers=headers)
        if status == 416:
            return b""  # at/past EOF: match every other driver's b""
        self._check(status, key)
        if ranged and status == 200:
            # server ignored the Range header: slice client-side
            data = data[off:] if limit < 0 else data[off:off + limit]
        return data

    def put(self, key: str, data) -> None:
        # data passes through unchanged: http.client takes bytes-like
        # bodies, and copying every 4 MiB block costs real bandwidth
        status, _, _ = self._request("PUT", key, body=data)
        if status == 409:  # missing parent collections (RFC 4918)
            self._mkcols(posixpath.dirname(key) + "/")
            status, _, _ = self._request("PUT", key, body=data)
        self._check(status, key)

    def _mkcols(self, dirpath: str) -> None:
        """Create every collection from the server root down: the base may
        itself be multi-segment (webdav://host/a/b), and each segment's
        MKCOL only succeeds once its parent exists — so 409 here is a
        REAL failure, never 'already exists' (that is 405)."""
        conn_path = self.base.strip("/") + "/" + dirpath
        segs = [p for p in conn_path.split("/") if p]
        cur = "/"
        for p in segs:
            cur += p + "/"
            status, _, _ = self._request_abs("MKCOL", cur)
            if status not in (201, 405):
                raise IOError(f"webdav MKCOL {cur}: HTTP {status}")

    def delete(self, key: str) -> None:
        status, _, _ = self._request("DELETE", key)
        if status not in (200, 204, 404):
            raise IOError(f"webdav DELETE {key}: HTTP {status}")

    def head(self, key: str) -> Obj:
        status, headers, _ = self._request("HEAD", key)
        self._check(status, key)
        hdrs = {k.lower(): v for k, v in headers.items()}
        mtime = 0.0
        if hdrs.get("last-modified"):
            try:
                mtime = parsedate_to_datetime(hdrs["last-modified"]).timestamp()
            except (TypeError, ValueError):
                pass
        return Obj(key=key, size=int(hdrs.get("content-length", 0)), mtime=mtime)

    def list_all(self, prefix: str = "", marker: str = ""):
        for obj in sorted(self._walk(""), key=lambda o: o.key):
            if prefix and not obj.key.startswith(prefix):
                continue
            if marker and obj.key <= marker:
                continue
            yield obj

    def _walk(self, rel: str):
        """Depth-1 PROPFIND recursion (Depth: infinity is optional in
        RFC 4918 and many servers refuse it)."""
        status, _, data = self._request(
            "PROPFIND", rel, headers={"Depth": "1"},
            body=b'<?xml version="1.0"?><D:propfind xmlns:D="DAV:">'
                 b"<D:allprop/></D:propfind>",
        )
        if status == 404:
            return
        self._check(status, rel or "/")
        base_path = urllib.parse.unquote(self._url(rel))
        for resp in ET.fromstring(data).findall(f"{_DAV}response"):
            raw_href = resp.findtext(f"{_DAV}href") or ""
            # RFC 4918 allows absolute URIs in href: keep only the path
            href = urllib.parse.unquote(urllib.parse.urlsplit(raw_href).path)
            href_rel = href[len(self.base):] if href.startswith(self.base) else href.lstrip("/")
            if urllib.parse.unquote(self._url(href_rel)).rstrip("/") == base_path.rstrip("/"):
                continue  # the collection itself
            prop = resp.find(f"{_DAV}propstat/{_DAV}prop")
            is_dir = (prop is not None and
                      prop.find(f"{_DAV}resourcetype/{_DAV}collection") is not None)
            if is_dir:
                yield from self._walk(href_rel.rstrip("/") + "/")
                continue
            size = int((prop.findtext(f"{_DAV}getcontentlength") or 0)
                       if prop is not None else 0)
            mtime = 0.0
            lm = prop.findtext(f"{_DAV}getlastmodified") if prop is not None else None
            if lm:
                try:
                    mtime = parsedate_to_datetime(lm).timestamp()
                except (TypeError, ValueError):
                    pass
            yield Obj(key=href_rel, size=size, mtime=mtime)

    def copy(self, dst: str, src: str) -> None:
        status, _, _ = self._request(
            "COPY", src,
            headers={"Destination": self._url(dst), "Overwrite": "T"},
        )
        self._check(status, src)
