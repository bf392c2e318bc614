"""Google Cloud Storage driver — JSON API over HTTP, no SDK (a copy of
juicefs_tpu/object/gs.py).

Reference: pkg/object/gs.go (the `gs://` driver over the Google SDK).
This rebuild speaks the JSON API directly (cloud.google.com/storage/
docs/json_api): media upload/download (with Range), object metadata,
prefix listing with pageToken pagination, server-side copyTo, and
multipart via temp objects + `compose` (GCS's native way to assemble
large objects from up to 32 components).

Auth is an OAuth2 bearer token:
    gs://TOKEN@host:port/bucket[/prefix]     explicit (tests/emulator)
    gs://bucket[/prefix]                     token from $GOOGLE_OAUTH_TOKEN,
                                             endpoint storage.googleapis.com
The bundled emulator (tests/gs_emulator.py) serves the same subset with
bearer verification so the driver is hermetically tested.
"""

from __future__ import annotations

import json
import http.client
import os
import threading
import urllib.parse
from typing import Iterator, Optional

from ..utils import get_logger
from .interface import MultipartUpload, NotFoundError, Obj, ObjectStorage, Part

logger = get_logger("object.gs")


class GSStorage(ObjectStorage):
    def __init__(self, addr: str):
        token, _, rest = addr.rpartition("@")
        token = token or os.environ.get("GOOGLE_OAUTH_TOKEN", "")
        host_and_path = rest
        if ":" in host_and_path.split("/", 1)[0]:
            hostport, _, bpath = host_and_path.partition("/")
            h, _, p = hostport.partition(":")
            self.host, self.port, self.tls = h, int(p), int(p) == 443
        else:
            self.host, self.port, self.tls = "storage.googleapis.com", 443, True
            bpath = host_and_path
        self.bucket, _, prefix = bpath.partition("/")
        self.prefix = prefix.strip("/")
        self.token = token
        self._local = threading.local()

    def string(self) -> str:
        return f"gs://{self.bucket}/"

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (http.client.HTTPSConnection if self.tls
                   else http.client.HTTPConnection)
            conn = cls(self.host, self.port, timeout=60)
            self._local.conn = conn
        return conn

    def _request(self, method: str, path: str,
                 query: dict[str, str] | None = None,
                 headers: dict[str, str] | None = None,
                 body: bytes = b"") -> tuple[int, bytes, dict]:
        headers = dict(headers or {})
        headers["Authorization"] = f"Bearer {self.token}"
        headers.setdefault("Content-Length", str(len(body)))
        qs = urllib.parse.urlencode(query or {})
        url = path + ("?" + qs if qs else "")
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request(method, url, body=body or None, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                return resp.status, data, dict(resp.getheaders())
            except (http.client.HTTPException, OSError):
                self._local.conn = None
                if attempt:
                    raise
        raise IOError("unreachable")

    def _k(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def _opath(self, key: str) -> str:
        return (f"/storage/v1/b/{self.bucket}/o/"
                + urllib.parse.quote(self._k(key), safe=""))

    @staticmethod
    def _check(status: int, data: bytes, what: str) -> None:
        if status == 404:
            raise NotFoundError(what)
        if status >= 300:
            raise IOError(f"gs {what}: HTTP {status} {data[:200]!r}")

    def create(self) -> None:
        project = os.environ.get("GOOGLE_PROJECT_ID", "default")
        st, data, _ = self._request(
            "POST", "/storage/v1/b", {"project": project},
            headers={"Content-Type": "application/json"},
            body=json.dumps({"name": self.bucket}).encode(),
        )
        if st not in (200, 409):
            raise IOError(f"gs create bucket: HTTP {st} {data[:200]!r}")

    def put(self, key: str, data: bytes) -> None:
        st, body, _ = self._request(
            "POST", f"/upload/storage/v1/b/{self.bucket}/o",
            {"uploadType": "media", "name": self._k(key)},
            headers={"Content-Type": "application/octet-stream"},
            body=bytes(data),
        )
        self._check(st, body, key)

    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        if limit == 0:
            return b""
        headers = {}
        if off or limit >= 0:
            end = "" if limit < 0 else str(off + limit - 1)
            headers["Range"] = f"bytes={off}-{end}"
        st, data, _ = self._request("GET", self._opath(key), {"alt": "media"},
                                    headers=headers)
        self._check(st, data, key)
        return data

    def delete(self, key: str) -> None:
        st, data, _ = self._request("DELETE", self._opath(key))
        if st not in (204, 404):
            raise IOError(f"gs delete {key}: HTTP {st}")

    def head(self, key: str) -> Obj:
        st, data, _ = self._request("GET", self._opath(key))
        self._check(st, data, key)
        meta = json.loads(data)
        mtime = 0.0
        if meta.get("updated"):
            import datetime

            mtime = datetime.datetime.fromisoformat(
                meta["updated"].replace("Z", "+00:00")
            ).timestamp()
        return Obj(key=key, size=int(meta.get("size", 0)), mtime=mtime,
                   is_dir=False)

    def copy(self, dst: str, src: str) -> None:
        st, data, _ = self._request(
            "POST",
            self._opath(src) + "/copyTo/b/" + self.bucket + "/o/"
            + urllib.parse.quote(self._k(dst), safe=""),
        )
        self._check(st, data, dst)

    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        import datetime

        full_prefix = self._k(prefix) if prefix or self.prefix else ""
        strip = len(self.prefix) + 1 if self.prefix else 0
        token = ""
        while True:
            q = {"maxResults": "1000"}
            if full_prefix:
                q["prefix"] = full_prefix
            if marker:
                # server-side resume (GCS startOffset is inclusive; the
                # contract is strictly-after, filtered below) — one page,
                # not a client-side rescan of the whole bucket
                q["startOffset"] = self._k(marker)
            if token:
                q["pageToken"] = token
            st, data, _ = self._request(
                "GET", f"/storage/v1/b/{self.bucket}/o", q
            )
            self._check(st, data, "list")
            doc = json.loads(data)
            for item in doc.get("items", []):
                key = item["name"][strip:]
                if marker and key <= marker:
                    continue
                mtime = 0.0
                if item.get("updated"):
                    mtime = datetime.datetime.fromisoformat(
                        item["updated"].replace("Z", "+00:00")
                    ).timestamp()
                yield Obj(key=key, size=int(item.get("size", 0)),
                          mtime=mtime, is_dir=False)
            token = doc.get("nextPageToken", "")
            if not token:
                return

    # -- multipart via temp objects + compose ------------------------------
    # upload_id and part keys are RELATIVE (under the volume prefix), so
    # orphaned parts remain visible to prefix-scoped listing and cleanup.
    def create_multipart_upload(self, key: str) -> Optional[MultipartUpload]:
        # GCS compose merges <= 32 components per call; chained composes
        # could exceed that, but 32 parts covers the framework's usage
        return MultipartUpload(min_part_size=1 << 20, max_count=32,
                               upload_id=f".compose/{key}")

    def upload_part(self, key: str, upload_id: str, num: int,
                    data: bytes) -> Part:
        part_key = f"{upload_id}/{num:05d}"
        self.put(part_key, data)
        return Part(num=num, etag=part_key, size=len(data))

    def complete_upload(self, key: str, upload_id: str,
                        parts: list[Part]) -> None:
        body = json.dumps({
            "sourceObjects": [
                {"name": self._k(p.etag)}
                for p in sorted(parts, key=lambda p: p.num)
            ],
            "destination": {"contentType": "application/octet-stream"},
        }).encode()
        st, data, _ = self._request(
            "POST",
            f"/storage/v1/b/{self.bucket}/o/"
            + urllib.parse.quote(self._k(key), safe="") + "/compose",
            headers={"Content-Type": "application/json"}, body=body,
        )
        self._check(st, data, key)
        for p in parts:  # temp components are no longer needed
            self.delete(p.etag)

    def abort_upload(self, key: str, upload_id: str) -> None:
        for o in list(self.list_all(upload_id + "/")):
            try:
                self.delete(o.key)
            except Exception as e:
                # best-effort cleanup on the abort retry path: a leaked
                # temp component must at least be traceable
                logger.warning("abort_upload: stale part %s not "
                               "deleted: %s", o.key, e)

    def limits(self) -> dict:
        return {"min_part_size": 1 << 20, "max_part_count": 32}
