"""S3(-compatible) object-storage driver — REST + AWS SigV4, no SDK (a
copy of juicefs_tpu/object/s3.py; reference pkg/object/s3.go, registered
`s3://` and `minio://`).

It speaks the wire protocol directly over http.client so any
S3-compatible endpoint works (AWS, MinIO, Ceph RGW, or this framework's
own S3 gateway), with zero external dependencies.

URI forms (path-style addressing):
    s3://ACCESS:SECRET@host:port/bucket[/prefix]
    s3://host:port/bucket            (creds from AWS_ACCESS_KEY_ID /
                                      AWS_SECRET_ACCESS_KEY env)
TLS: https when the port is 443 or JFS_S3_TLS=1.

Implements get (ranged) / put / delete / head / ListObjectsV2 with
continuation tokens / server-side copy / multipart upload.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import os
import threading
import urllib.parse
import xml.etree.ElementTree as ET
from collections import deque
from typing import Iterator, Optional

from ..utils import get_logger
from .interface import (
    MultipartUpload,
    NotFoundError,
    Obj,
    ObjectStorage,
    Part,
    PermanentError,
    ThrottleError,
)

logger = get_logger("object.s3")

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _uri_escape(s: str, keep_slash: bool) -> str:
    safe = "/-_.~" if keep_slash else "-_.~"
    return urllib.parse.quote(s, safe=safe)


class _ConnPool:
    """Bounded per-backend keep-alive connection pool.

    Object-op attempts run on the resilience layer's ELASTIC threads
    (object/resilient.py), so a purely thread-local connection re-pays
    the TCP(+TLS) handshake whenever the elastic pool grows, rotates, or
    abandons a hung attempt. A small cross-thread free-list keeps
    connections hot: callers check out around one request/response and
    check back in only after the body is fully read (http.client cannot
    interleave).  Broken or `Connection: close`d sockets are discarded,
    as a keep-alive HTTP client must."""

    def __init__(self, factory, limit: int = 16):
        self._factory = factory
        self._limit = max(1, limit)
        self._free: deque = deque()
        self._lock = threading.Lock()
        self.created = 0
        self.reused = 0

    def acquire(self):
        with self._lock:
            if self._free:
                self.reused += 1
                return self._free.pop()
            self.created += 1
        return self._factory()

    def release(self, conn) -> None:
        with self._lock:
            if len(self._free) < self._limit:
                self._free.append(conn)
                return
        try:
            conn.close()
        except OSError:
            pass  # socket already dead: exactly why it was released

    def discard(self, conn) -> None:
        try:
            conn.close()
        except OSError:
            pass  # stale socket being discarded: already broken

    def close(self) -> None:
        with self._lock:
            conns, self._free = list(self._free), deque()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass  # pool teardown of an already-dead socket


class SigV4:
    """AWS Signature Version 4 for the S3 service (sign + server verify)."""

    def __init__(self, access_key: str, secret_key: str, region: str = "us-east-1"):
        self.ak, self.sk, self.region = access_key, secret_key, region

    def _signature(
        self,
        method: str,
        path: str,
        query: dict[str, str],
        headers: dict[str, str],
        signed_list: list[str],
        amz_date: str,
    ) -> str:
        datestamp = amz_date[:8]
        canonical_query = "&".join(
            f"{_uri_escape(k, False)}={_uri_escape(v, False)}"
            for k, v in sorted(query.items())
        )
        canonical = "\n".join([
            method,
            _uri_escape(path, True),
            canonical_query,
            "".join(f"{k}:{headers.get(k, '').strip()}\n" for k in signed_list),
            ";".join(signed_list),
            headers.get("x-amz-content-sha256", _EMPTY_SHA256),
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        sts = "\n".join([
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical.encode()).hexdigest(),
        ])
        key = f"AWS4{self.sk}".encode()
        for part in (datestamp, self.region, "s3", "aws4_request"):
            key = hmac.new(key, part.encode(), hashlib.sha256).digest()
        return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()

    def sign(
        self,
        method: str,
        host: str,
        path: str,
        query: dict[str, str],
        payload_hash: str,
        extra_headers: Optional[dict[str, str]] = None,
        now: Optional[datetime.datetime] = None,
    ) -> dict[str, str]:
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        # all x-amz-* request headers must be signed (AWS requirement)
        for k, v in (extra_headers or {}).items():
            if k.lower().startswith("x-amz-"):
                headers[k.lower()] = v
        signed_list = sorted(headers)
        sig = self._signature(method, path, query, headers, signed_list, amz_date)
        scope = f"{amz_date[:8]}/{self.region}/s3/aws4_request"
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.ak}/{scope}, "
            f"SignedHeaders={';'.join(signed_list)}, Signature={sig}"
        )
        del headers["host"]  # http.client sets it; it is still signed
        return headers

    def verify(
        self,
        method: str,
        path: str,
        query: dict[str, str],
        headers: dict[str, str],
        authorization: str,
    ) -> bool:
        """Server-side check: recompute the signature from the raw request.

        `headers` must be lowercase-keyed and include host/x-amz-date/
        x-amz-content-sha256 as received on the wire.
        """
        try:
            parts = dict(
                p.strip().split("=", 1)
                for p in authorization.split(" ", 1)[1].split(",")
            )
            cred = parts["Credential"].split("/")
            signed_list = parts["SignedHeaders"].split(";")
            sig = parts["Signature"]
        except (KeyError, IndexError, ValueError):
            return False
        if cred[0] != self.ak:
            return False
        amz_date = headers.get("x-amz-date", "")
        if not amz_date:
            return False
        want = self._signature(method, path, query, headers, signed_list, amz_date)
        return hmac.compare_digest(want, sig)


class S3Storage(ObjectStorage):
    def __init__(self, addr: str):
        creds = ""
        if "@" in addr:
            creds, addr = addr.rsplit("@", 1)
        hostport, _, rest = addr.partition("/")
        bucket, _, prefix = rest.partition("/")
        if not bucket:
            raise ValueError(f"s3 uri needs a bucket: s3://{addr}")
        self.host = hostport
        self.bucket = bucket
        self.prefix = prefix.lstrip("/")
        if self.prefix and not self.prefix.endswith("/"):
            self.prefix += "/"
        ak, _, sk = creds.partition(":")
        ak = ak or os.environ.get("AWS_ACCESS_KEY_ID", "")
        sk = sk or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        region = os.environ.get("AWS_REGION", "us-east-1")
        self.signer = SigV4(ak, sk, region) if ak else None
        port = int(hostport.rsplit(":", 1)[1]) if ":" in hostport else 80
        self.tls = port == 443 or os.environ.get("JFS_S3_TLS") == "1"
        self._pool = _ConnPool(self._new_conn)

    def string(self) -> str:
        return f"s3://{self.host}/{self.bucket}/{self.prefix}"

    # ---- plumbing --------------------------------------------------------
    def _new_conn(self) -> http.client.HTTPConnection:
        cls = http.client.HTTPSConnection if self.tls else http.client.HTTPConnection
        return cls(self.host, timeout=60)

    def close(self) -> None:
        self._pool.close()

    def _request(
        self,
        method: str,
        key: str = "",
        query: Optional[dict[str, str]] = None,
        body: bytes = b"",
        headers: Optional[dict[str, str]] = None,
        retry_reset: bool = True,
        fresh: bool = False,
    ):
        path = "/" + self.bucket
        if key:
            path += "/" + urllib.parse.quote(key, safe="/-_.~")
        query = query or {}
        payload_hash = hashlib.sha256(body).hexdigest() if body else _EMPTY_SHA256
        hdrs = dict(headers or {})
        if self.signer:
            raw_path = "/" + self.bucket + ("/" + key if key else "")
            hdrs.update(
                self.signer.sign(
                    method, self.host, raw_path, query, payload_hash,
                    extra_headers=hdrs,
                )
            )
        else:
            hdrs["x-amz-content-sha256"] = payload_hash
        if body:
            hdrs["Content-Length"] = str(len(body))
        qs = urllib.parse.urlencode(query)
        url = path + ("?" + qs if qs else "")
        # the retry must BYPASS the pool: after an idle gap the server may
        # have closed every parked socket, and drawing another stale one
        # would fail a healthy backend twice
        conn = self._new_conn() if fresh else self._pool.acquire()
        try:
            conn.request(method, url, body=body or None, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
        except (http.client.HTTPException, OSError):
            # stale keep-alive (server closed an idle pooled socket) or a
            # genuinely broken conn: drop it, retry once on a fresh one
            self._pool.discard(conn)
            if not retry_reset:
                raise
            return self._request(method, key, query, body, headers,
                                 retry_reset=False, fresh=True)
        if resp.will_close:
            self._pool.discard(conn)
        else:
            self._pool.release(conn)
        return resp.status, dict(resp.getheaders()), data

    @staticmethod
    def _check(status: int, data: bytes, key: str) -> None:
        """Classified failures for the resilience layer (object/resilient):
        throttle responses back off longer + shed concurrency; other 4xx
        are permanent (the request is wrong, not unlucky) and are never
        retried.  Every raise carries `.status` for generic classifiers."""
        if status == 404:
            raise NotFoundError(key)
        if status >= 300:
            if status in (429, 503):  # 503 = S3 SlowDown
                e: IOError = ThrottleError(
                    f"s3 throttled ({status}): {data[:200]!r}")
            elif 400 <= status < 500 and status not in (408, 416):
                e = PermanentError(
                    f"s3 request rejected ({status}): {data[:200]!r}")
            else:
                e = IOError(f"s3 request failed ({status}): {data[:200]!r}")
            e.status = status
            raise e

    def _k(self, key: str) -> str:
        return self.prefix + key

    # ---- object ops ------------------------------------------------------
    def create(self) -> None:
        status, _, data = self._request("PUT")
        if status >= 300 and status != 409:  # 409 BucketAlreadyExists
            logger.debug("create bucket: %s %r", status, data[:120])

    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        headers = {}
        if off or limit >= 0:
            end = "" if limit < 0 else str(off + limit - 1)
            headers["Range"] = f"bytes={off}-{end}"
        status, _, data = self._request("GET", self._k(key), headers=headers)
        if status == 416:  # empty range on empty object
            return b""
        self._check(status, data, key)
        return data

    def put(self, key: str, data: bytes) -> None:
        status, _, body = self._request("PUT", self._k(key), body=data)
        self._check(status, body, key)

    def delete(self, key: str) -> None:
        status, _, body = self._request("DELETE", self._k(key))
        if status not in (200, 204, 404):
            self._check(status, body, key)

    def head(self, key: str) -> Obj:
        status, headers, _ = self._request("HEAD", self._k(key))
        if status == 404:
            raise NotFoundError(key)
        if status >= 300:
            raise IOError(f"s3 head failed ({status})")
        size = int(headers.get("Content-Length", 0) or 0)
        mtime = 0.0
        lm = headers.get("Last-Modified")
        if lm:
            import email.utils

            dt = email.utils.parsedate_to_datetime(lm)
            mtime = dt.timestamp()
        return Obj(key=key, size=size, mtime=mtime)

    def copy(self, dst: str, src: str) -> None:
        status, _, body = self._request(
            "PUT",
            self._k(dst),
            headers={"x-amz-copy-source": f"/{self.bucket}/{self._k(src)}"},
        )
        self._check(status, body, src)

    # ---- listing (ListObjectsV2) ----------------------------------------
    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        token = ""
        start_after = self._k(marker) if marker else ""
        while True:
            query = {"list-type": "2", "prefix": self._k(prefix), "max-keys": "1000"}
            if token:
                query["continuation-token"] = token
            elif start_after:
                query["start-after"] = start_after
            status, _, data = self._request("GET", query=query)
            self._check(status, data, prefix)
            ns = ""
            root = ET.fromstring(data)
            if root.tag.startswith("{"):
                ns = root.tag.split("}")[0] + "}"
            for c in root.findall(f"{ns}Contents"):
                k = c.findtext(f"{ns}Key") or ""
                # every key is returned, including trailing-slash folder
                # markers (reference pkg/object/s3.go does the same; the
                # gateway does not list directories at all)
                if self.prefix:
                    if not k.startswith(self.prefix):
                        continue
                    k = k[len(self.prefix):]
                if not k:
                    # the marker object equal to the configured prefix
                    # itself strips to an empty key: nothing to address
                    continue
                size = int(c.findtext(f"{ns}Size") or 0)
                mtime = 0.0
                lm = c.findtext(f"{ns}LastModified")
                if lm:
                    try:
                        mtime = datetime.datetime.fromisoformat(
                            lm.replace("Z", "+00:00")
                        ).timestamp()
                    except ValueError:
                        pass
                yield Obj(key=k, size=size, mtime=mtime,
                          is_dir=k.endswith("/"))
            trunc = (root.findtext(f"{ns}IsTruncated") or "").lower() == "true"
            token = root.findtext(f"{ns}NextContinuationToken") or ""
            if not trunc or not token:
                return

    # ---- multipart -------------------------------------------------------
    def create_multipart_upload(self, key: str) -> Optional[MultipartUpload]:
        status, _, data = self._request(
            "POST", self._k(key), query={"uploads": ""}
        )
        self._check(status, data, key)
        root = ET.fromstring(data)
        ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") else ""
        upload_id = root.findtext(f"{ns}UploadId") or ""
        return MultipartUpload(
            min_part_size=5 << 20, max_count=10000, upload_id=upload_id
        )

    def upload_part(self, key: str, upload_id: str, num: int, data: bytes) -> Part:
        status, headers, body = self._request(
            "PUT",
            self._k(key),
            query={"partNumber": str(num), "uploadId": upload_id},
            body=data,
        )
        self._check(status, body, key)
        return Part(num=num, etag=headers.get("ETag", "").strip('"'), size=len(data))

    def complete_upload(self, key: str, upload_id: str, parts: list[Part]) -> None:
        manifest = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{p.num}</PartNumber><ETag>{p.etag}</ETag></Part>"
            for p in sorted(parts, key=lambda p: p.num)
        ) + "</CompleteMultipartUpload>"
        status, _, body = self._request(
            "POST",
            self._k(key),
            query={"uploadId": upload_id},
            body=manifest.encode(),
        )
        self._check(status, body, key)

    def abort_upload(self, key: str, upload_id: str) -> None:
        self._request("DELETE", self._k(key), query={"uploadId": upload_id})
