"""S3-compatible HTTP gateway over the FileSystem SDK (a copy of
juicefs_tpu/gateway/s3.py).

Mirrors the reference's MinIO-based gateway semantics (pkg/gateway):
  - buckets = top-level directories of the volume (gateway.go jfsObjects)
  - objects = files; "dir/" keys list by prefix via the namespace itself
  - multipart uploads assemble under /.sys/multipart (gateway.go:188-196)
  - ETag = hex JTH-256 prefix stored in an xattr (etag-in-xattr like the
    reference's s3-etag xattr)

Serving-plane data paths:
  - GET streams block-sized spans through the vfs streaming reader (the
    streaming readahead window ramps for sequential S3 consumers) with
    bounded gateway-side buffering and chunked socket writes;
  - PUT / UploadPart stream the request body into the vfs writer in
    block-sized pieces, so the bytes ride the ingest/dedup/compress
    plane exactly like FUSE writes;
  - CompleteMultipartUpload and CopyObject stitch server-side at the
    slice/metadata level (``fs.copy_range`` -> meta copy_file_range
    slice increfs) — no part is ever re-read or re-written;
  - ListObjectsV2 pages through an ordered incremental readdir walk
    (serve.OrderedKeyWalker): real continuation tokens, bounded memory
    at any max-keys, no full-bucket recursion;
  - every request passes the bounded admission gate (overload sheds as
    503 SlowDown) and runs under the tenant scope of its access key —
    SigV4 verification maps multiple access keys to tenants.
"""

from __future__ import annotations

import errno as _errno
import posixpath
import re
import urllib.parse
import uuid
from xml.sax.saxutils import escape

from ..meta.types import TYPE_DIRECTORY
from .. import native
from ..gpu.jth256 import digest_hex
from ..utils import get_logger
from ..fs import FSError, FileSystem
from . import BaseHandler, HTTPAdapter
from .serve import (
    UNSATISFIABLE,
    GatewayAuth,
    OrderedKeyWalker,
    ServingPlane,
    parse_range,
)

logger = get_logger("gateway.s3")

SYS_MULTIPART = "/.sys/multipart"
ETAG_XATTR = b"s3.etag"
NS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _etag(data: bytes) -> str:
    return digest_hex(native.jth256(data))[:32]


class S3Gateway(HTTPAdapter):
    _name = "s3-gateway"

    def __init__(
        self,
        fs: FileSystem,
        address: str = "127.0.0.1",
        port: int = 9000,
        access_key: str = "",
        secret_key: str = "",
        tenant_keys: dict[str, str] | None = None,
        max_inflight: int = 64,
    ):
        super().__init__(address, port)
        self.fs = fs
        auth = GatewayAuth()
        if access_key:
            auth.add_key(access_key, secret_key)
        for ak, sk in (tenant_keys or {}).items():
            auth.add_key(ak, sk)
        self.plane = ServingPlane(fs.vfs, auth, max_inflight=max_inflight)
        # trusted-boundary mode serves through the CALLER's FileSystem
        # context (its uid), not a synthetic tenant
        self.plane.bind_anonymous(fs)
        gw = self

        class Handler(BaseHandler):
            def log_message(self, fmt, *args):
                logger.debug(fmt, *args)

            def _authorized(self):
                """Verify AWS SigV4 when the gateway has credentials and
                map the access key to its tenant (reference: MinIO auth
                layer in pkg/gateway).  Signature, date window (replay
                bound) and the streaming-scheme rejection happen here;
                PAYLOAD hashes are verified on the data path while the
                body streams (serve.stream_body_in), never by buffering.
                Returns the Tenant, or None (error already sent)."""
                if not gw.plane.auth.enabled:
                    return gw.plane.tenant("")
                import datetime as _dt

                headers = {k.lower(): v for k, v in self.headers.items()}
                amz_date = headers.get("x-amz-date", "")
                try:
                    ts = _dt.datetime.strptime(
                        amz_date, "%Y%m%dT%H%M%SZ"
                    ).replace(tzinfo=_dt.timezone.utc)
                except ValueError:
                    self._drain()
                    gw.plane.note_auth_failure()
                    self._error(403, "AccessDenied", "missing x-amz-date")
                    return None
                skew = abs(
                    (_dt.datetime.now(_dt.timezone.utc) - ts).total_seconds()
                )
                if skew > 900:
                    self._drain()
                    gw.plane.note_auth_failure()
                    self._error(403, "RequestTimeTooSkewed")
                    return None
                if headers.get("x-amz-content-sha256", "").startswith(
                        "STREAMING-"):
                    self._drain()
                    self._error(
                        501, "NotImplemented",
                        "streaming chunked payloads are not supported",
                    )
                    return None
                u = urllib.parse.urlsplit(self.path)
                query = {
                    k: v[0]
                    for k, v in urllib.parse.parse_qs(
                        u.query, keep_blank_values=True
                    ).items()
                }
                ak = gw.plane.auth.verify(
                    self.command,
                    urllib.parse.unquote(u.path),
                    query,
                    headers,
                    self.headers.get("Authorization", ""),
                )
                if ak is None:
                    self._drain()
                    gw.plane.note_auth_failure()
                    self._error(403, "SignatureDoesNotMatch")
                    return None
                return gw.plane.tenant(ak)

            def _declared_sha(self) -> str | None:
                """The signed payload hash a streamed body must match
                (None = unsigned / trusted mode: nothing to check)."""
                if not gw.plane.auth.enabled:
                    return None
                sha = self.headers.get("x-amz-content-sha256", "")
                if not sha or sha == "UNSIGNED-PAYLOAD":
                    return None
                return sha

            def _verify_buffered(self, body: bytes) -> bool:
                """Payload-hash check for the small, buffered control
                bodies (CompleteMultipartUpload manifest)."""
                want = self._declared_sha()
                if want is None:
                    return True
                import hashlib as _hashlib

                if _hashlib.sha256(body).hexdigest() == want:
                    return True
                self._error(400, "XAmzContentSHA256Mismatch")
                return False

            def _params(self):
                u = urllib.parse.urlsplit(self.path)
                q = urllib.parse.parse_qs(u.query, keep_blank_values=True)
                parts = u.path.lstrip("/").split("/", 1)
                bucket = urllib.parse.unquote(parts[0]) if parts[0] else ""
                key = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
                return bucket, key, q

            def _xml(self, code: int, body: str):
                data = ('<?xml version="1.0" encoding="UTF-8"?>' + body).encode()
                gw.plane.note_error(code)
                self.send_response(code)
                self.send_header("Content-Type", "application/xml")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _error(self, code: int, s3code: str, msg: str = ""):
                self._xml(code, f"<Error><Code>{s3code}</Code>"
                                f"<Message>{escape(msg or s3code)}</Message></Error>")

            def _shed(self):
                """Admission-gate refusal: S3's retryable overload reply.
                The unread body is NOT drained (that would spend the very
                bandwidth shedding exists to protect) — close instead."""
                self.close_connection = True
                gw.plane.note_error(503)
                body = (b'<?xml version="1.0" encoding="UTF-8"?>'
                        b"<Error><Code>SlowDown</Code>"
                        b"<Message>Reduce your request rate.</Message>"
                        b"</Error>")
                self.send_response(503)
                self.send_header("Content-Type", "application/xml")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)

            # -- dispatch --------------------------------------------------
            def do_GET(self):
                t = self._authorized()
                if t is None:
                    return
                bucket, key, q = self._params()
                op = "list" if not key else "get"
                with gw.plane.admitted(op, t) as adm:
                    if adm is None:
                        return self._shed()
                    try:
                        if not bucket:
                            return gw._list_buckets(self, t)
                        if not key:
                            return gw._list_objects(self, t, bucket, q)
                        return gw._get_object(self, t, bucket, key)
                    except ValueError:
                        self._error(400, "InvalidArgument")
                    except FSError as e:
                        self._map_fs_error(e)
                    except OSError as e:
                        # storage-layer failure (outage, breaker open)
                        # surfacing before the headers committed: a
                        # clean, retryable 500 — never a dead socket
                        logger.warning("GET failed: %s", e)
                        self._error(500, "InternalError", str(e))

            def do_HEAD(self):
                t = self._authorized()
                if t is None:
                    return
                bucket, key, q = self._params()
                with gw.plane.admitted("head", t) as adm:
                    if adm is None:
                        return self._shed()
                    try:
                        if bucket and not key:
                            t.fs.stat("/" + bucket)
                            return self._empty(200)
                        return gw._head_object(self, t, bucket, key)
                    except FSError as e:
                        gw.plane.note_error(
                            404 if e.errno == _errno.ENOENT else 500)
                        self._empty(
                            404 if e.errno == _errno.ENOENT else 500)

            def do_PUT(self):
                t = self._authorized()
                if t is None:
                    return
                bucket, key, q = self._params()
                op = "part" if "partNumber" in q else "put"
                with gw.plane.admitted(op, t) as adm:
                    if adm is None:
                        return self._shed()
                    try:
                        if bucket and not key:
                            return gw._create_bucket(self, t, bucket)
                        if "partNumber" in q and "uploadId" in q:
                            return gw._upload_part(
                                self, t, bucket, key, q["uploadId"][0],
                                int(q["partNumber"][0]),
                            )
                        return gw._put_object(self, t, bucket, key)
                    except ValueError:
                        self._drain()
                        self._error(400, "InvalidArgument")
                    except FSError as e:
                        self._drain()
                        self._map_fs_error(e)
                    except OSError as e:
                        logger.warning("PUT failed: %s", e)
                        self._drain()
                        self._error(500, "InternalError", str(e))

            def do_POST(self):
                t = self._authorized()
                if t is None:
                    return
                bucket, key, q = self._params()
                with gw.plane.admitted("multipart", t) as adm:
                    if adm is None:
                        return self._shed()
                    try:
                        if "uploads" in q:
                            return gw._create_multipart(self, t, bucket, key)
                        if "uploadId" in q:
                            return gw._complete_multipart(
                                self, t, bucket, key, q["uploadId"][0])
                        self._drain()
                        self._error(400, "InvalidRequest")
                    except ValueError:
                        self._error(400, "InvalidArgument")
                    except FSError as e:
                        self._map_fs_error(e)
                    except OSError as e:
                        logger.warning("POST failed: %s", e)
                        self._error(500, "InternalError", str(e))

            def do_DELETE(self):
                t = self._authorized()
                if t is None:
                    return
                bucket, key, q = self._params()
                with gw.plane.admitted("delete", t) as adm:
                    if adm is None:
                        return self._shed()
                    try:
                        if "uploadId" in q:
                            return gw._abort_multipart(
                                self, t, bucket, key, q["uploadId"][0])
                        if bucket and not key:
                            return gw._delete_bucket(self, t, bucket)
                        return gw._delete_object(self, t, bucket, key)
                    except ValueError:
                        self._error(400, "InvalidArgument")
                    except FSError as e:
                        self._map_fs_error(e)
                    except OSError as e:
                        logger.warning("DELETE failed: %s", e)
                        self._error(500, "InternalError", str(e))

            def _map_fs_error(self, e: FSError):
                if e.errno == _errno.ENOENT:
                    self._error(404, "NoSuchKey", str(e))
                elif e.errno == _errno.ENOTEMPTY:
                    self._error(409, "BucketNotEmpty", str(e))
                elif e.errno in (_errno.EACCES, _errno.EPERM):
                    self._error(403, "AccessDenied", str(e))
                else:
                    self._error(500, "InternalError", str(e))

        self._handler_cls = Handler

    # -- bucket ops --------------------------------------------------------

    def _list_buckets(self, h, t):
        entries = t.fs.listdir("/", want_attr=True)
        items = "".join(
            f"<Bucket><Name>{escape(e.name.decode())}</Name>"
            f"<CreationDate>1970-01-01T00:00:00.000Z</CreationDate></Bucket>"
            for e in entries
            if e.attr and e.attr.typ == TYPE_DIRECTORY and not e.name.startswith(b".")
        )
        h._xml(200, f'<ListAllMyBucketsResult xmlns="{NS}">'
                    f"<Buckets>{items}</Buckets></ListAllMyBucketsResult>")

    def _create_bucket(self, h, t, bucket: str):
        h._drain()  # CreateBucketConfiguration XML is accepted-as-given
        try:
            t.fs.mkdir("/" + bucket, 0o777)
        except FSError as e:
            if e.errno != _errno.EEXIST:
                raise
        h._empty(200, {"Location": "/" + bucket})

    def _delete_bucket(self, h, t, bucket: str):
        t.fs.rmdir("/" + bucket)
        h._empty(204)

    # -- object ops --------------------------------------------------------

    def _obj_path(self, bucket: str, key: str) -> str:
        p = posixpath.normpath(f"/{bucket}/{key}")
        if not p.startswith(f"/{bucket}/"):
            raise FSError(_errno.EPERM, key)  # path escape attempt
        return p

    def _put_object(self, h, t, bucket: str, key: str):
        fs = t.fs
        fs.stat("/" + bucket)
        length = int(h.headers.get("Content-Length", 0) or 0)
        path = self._obj_path(bucket, key)
        if key.endswith("/"):
            if length:
                h._drain()
                raise FSError(_errno.EINVAL, key)
            fs.makedirs(path)
            return h._empty(200, {"ETag": '"d41d8cd98f00b204e9800998ecf8427e"'})
        copy_src = h.headers.get("x-amz-copy-source")
        # the destination's parent chain is created only once the
        # request is known-good (just before the publishing rename): a
        # failed copy-source or truncated body must not leave empty
        # directory trees that make DeleteBucket fail BucketNotEmpty on
        # a bucket ListObjects shows as empty
        parent = posixpath.dirname(path)
        if copy_src:
            h._drain()  # a copy request's body is ignored, not left on
            # the socket to desync the next keep-alive request
            src = urllib.parse.unquote(copy_src.lstrip("/"))
            sbucket, _, skey = src.partition("/")
            # Same escape guard as destination keys (no ../ traversal);
            # the copy itself is a server-side slice share — no data
            # bytes move through the gateway
            spath = self._obj_path(sbucket, skey)
            sattr = fs.stat(spath)
            try:
                et = fs.getxattr(spath, ETAG_XATTR).decode()
            except FSError:
                et = f"{sattr.length:x}-{sattr.mtime:x}"
            if spath != path:
                # copy-to-SELF is a metadata refresh in S3; otherwise
                # the slice share lands in a temp key and publishes by
                # rename, so a mid-copy failure never leaves the live
                # destination truncated or partial
                fs.makedirs(self._TMP_DIR)
                tmp = f"{self._TMP_DIR}/{uuid.uuid4().hex}"
                with fs.create(tmp):
                    pass
                try:
                    fs.copy_range(spath, tmp)
                except FSError:
                    self._discard(fs, tmp)
                    raise
                try:
                    fs.setxattr(tmp, ETAG_XATTR, et.encode())
                except FSError:
                    pass  # etag falls back to length-mtime on read
                if parent != "/":
                    fs.makedirs(parent)
                fs.rename(tmp, path)
            return h._xml(200, f'<CopyObjectResult xmlns="{NS}">'
                               f"<ETag>&quot;{et}&quot;</ETag></CopyObjectResult>")
        # data path: the body streams into the vfs writer in block-sized
        # pieces (ingest/dedup/compress engage), never one RAM buffer.
        # It lands in a TEMP key first: an overwrite PUT whose body dies
        # or lies about its hash must never have touched the live
        # destination object (one atomic rename publishes it)
        tmp, et, got, sha_ok = self._stream_to_temp(h, fs, length)
        if got < length:
            # client truncated the body: the socket is desynced — drop
            # the partial temp and the connection
            self._discard(fs, tmp)
            h.close_connection = True
            return h._error(400, "IncompleteBody")
        if not sha_ok:
            self._discard(fs, tmp)
            return h._error(400, "XAmzContentSHA256Mismatch")
        try:
            fs.setxattr(tmp, ETAG_XATTR, et.encode())
        except FSError:
            pass
        if parent != "/":
            fs.makedirs(parent)
        fs.rename(tmp, path)
        h._empty(200, {"ETag": f'"{et}"'})

    _TMP_DIR = "/.sys/tmp"

    def _stream_to_temp(self, h, fs, length: int):
        """Stream the request body into a fresh temp file under the
        /.sys staging area; the caller publishes it with one rename
        once the bytes are complete and hash-verified.  Returns
        (tmp_path, etag, bytes_read, sha_ok).  A vfs failure
        MID-STREAM (ENOSPC, breaker open) discards the temp before
        propagating — the caller never learns the path, so nobody else
        could clean it up."""
        fs.makedirs(self._TMP_DIR)
        tmp = f"{self._TMP_DIR}/{uuid.uuid4().hex}"
        try:
            with fs.create(tmp) as f:
                et, got, sha_ok = self.plane.stream_in(
                    h, f, length, want_sha=h._declared_sha()
                )
        except OSError:
            self._discard(fs, tmp)
            raise
        return tmp, et, got, sha_ok

    @staticmethod
    def _discard(fs, path: str) -> None:
        try:
            fs.unlink(path)
        except FSError:
            pass  # unwind of a failed PUT: the object may never have landed

    def _get_object(self, h, t, bucket: str, key: str):
        fs = t.fs
        path = self._obj_path(bucket, key)
        attr = fs.stat(path)
        if attr.typ == TYPE_DIRECTORY:
            raise FSError(_errno.ENOENT, key)
        rng = parse_range(h.headers.get("Range"), attr.length)
        if rng is UNSATISFIABLE:
            gw_code = 416
            self.plane.note_error(gw_code)
            h.send_response(gw_code)
            h.send_header("Content-Range", f"bytes */{attr.length}")
            h.send_header("Content-Length", "0")
            h.end_headers()
            return
        if rng is None:
            start, end, code = 0, attr.length - 1, 200
        else:
            (start, end), code = rng, 206
        length = end - start + 1 if attr.length else 0
        etag = self._etag_of(fs, path, attr)
        if not length:
            h.send_response(code)
            h.send_header("Content-Type", "application/octet-stream")
            h.send_header("Content-Length", "0")
            h.send_header("Last-Modified", _http_date(attr.mtime))
            h.send_header("ETag", f'"{etag}"')
            h.end_headers()
            return
        # stream block-sized spans through the vfs reader: sequential
        # spans ramp the streaming readahead window; at most ONE span is
        # buffered gateway-side at any instant.  The FIRST
        # span is read BEFORE the headers commit, so a failing read
        # (cold miss during an outage) still maps to a clean 500 —
        # only a mid-stream failure degrades to a closed connection
        with fs.open(path) as f:
            first = f.pread(start, min(self.plane.span, length))
            h.send_response(code)
            h.send_header("Content-Type", "application/octet-stream")
            h.send_header("Content-Length", str(length))
            h.send_header("Last-Modified", _http_date(attr.mtime))
            h.send_header("ETag", f'"{etag}"')
            if code == 206:
                h.send_header("Content-Range",
                              f"bytes {start}-{end}/{attr.length}")
            h.end_headers()
            sent = 0
            try:
                sent = self.plane.write_span(h.wfile, first)
                if sent < length:
                    sent += self.plane.stream_out(
                        h.wfile, f, start + sent, length - sent)
            except OSError:
                # headers are committed: a socket or backend failure
                # here can only be signalled by closing — sending an
                # error response would inject bytes into the body
                pass
        if sent < length:
            # the file shrank (or the backend died) mid-stream: the
            # promised Content-Length cannot be met — kill the
            # keep-alive so the client sees a truncation, not a hung
            # read or a phantom second response
            h.close_connection = True

    def _head_object(self, h, t, bucket: str, key: str):
        fs = t.fs
        path = self._obj_path(bucket, key)
        attr = fs.stat(path)
        if attr.typ == TYPE_DIRECTORY and not key.endswith("/"):
            raise FSError(_errno.ENOENT, key)
        h._empty(200, {
            "Content-Length": str(attr.length),
            "Content-Type": "application/octet-stream",
            "Last-Modified": _http_date(attr.mtime),
            "ETag": f'"{self._etag_of(fs, path, attr)}"',
        })

    def _delete_object(self, h, t, bucket: str, key: str):
        fs = t.fs
        path = self._obj_path(bucket, key)
        try:
            attr = fs.stat(path)
            if attr.typ == TYPE_DIRECTORY:
                fs.rmdir(path)
            else:
                fs.unlink(path)
        except FSError as e:
            if e.errno != _errno.ENOENT:  # S3 delete is idempotent
                raise
        h._empty(204)

    def _etag_of(self, fs, path: str, attr) -> str:
        try:
            return fs.getxattr(path, ETAG_XATTR).decode()
        except FSError:
            return f"{attr.length:x}-{attr.mtime:x}"

    # -- listing -----------------------------------------------------------

    def _list_objects(self, h, t, bucket: str, q):
        """ListObjectsV2 with real pagination: keys stream in
        sort order from the incremental walker; the page stops at
        max-keys and the NextContinuationToken is the last item emitted
        (a key, or a CommonPrefixes entry whose whole subtree is then
        skipped on resume).  Memory is bounded by the page + the walk
        stack — never the bucket."""
        fs = t.fs
        fs.stat("/" + bucket)
        prefix = q.get("prefix", [""])[0]
        delimiter = q.get("delimiter", [""])[0]
        max_keys = int(q.get("max-keys", ["1000"])[0])
        token = q.get(
            "continuation-token", q.get("start-after", q.get("marker", [""]))
        )[0]

        walker = OrderedKeyWalker(fs, bucket, prefix, after=token)
        if delimiter and token.endswith(delimiter):
            # resuming after a rolled-up CommonPrefixes entry: everything
            # under it was already represented by that one entry
            walker.skip = token
        contents: list[tuple[str, object]] = []
        prefixes: list[str] = []
        truncated, next_token = False, ""
        if max_keys > 0:
            last = ""
            for key, attr in walker:
                item_is_prefix = False
                if delimiter:
                    rest = key[len(prefix):]
                    cut = rest.find(delimiter)
                    if cut >= 0:
                        item_is_prefix = True
                        pfx = prefix + rest[: cut + 1]
                if len(contents) + len(prefixes) >= max_keys:
                    # this item proves more remain: the page is full
                    truncated, next_token = True, last
                    break
                if item_is_prefix:
                    prefixes.append(pfx)
                    last = pfx
                    # skip the rest of the rolled-up subtree: the walker
                    # discards (and for '/' delimiters prunes) below it
                    walker.skip = pfx
                else:
                    contents.append((key, attr))
                    last = key

        body = "".join(
            f"<Contents><Key>{escape(k)}</Key>"
            f"<LastModified>{_iso_date(a.mtime)}</LastModified>"
            f"<Size>{a.length}</Size>"
            f"<StorageClass>STANDARD</StorageClass></Contents>"
            for k, a in contents
        ) + "".join(
            f"<CommonPrefixes><Prefix>{escape(p)}</Prefix></CommonPrefixes>"
            for p in prefixes
        )
        h._xml(200, f'<ListBucketResult xmlns="{NS}">'
                    f"<Name>{escape(bucket)}</Name><Prefix>{escape(prefix)}</Prefix>"
                    f"<KeyCount>{len(contents) + len(prefixes)}</KeyCount>"
                    f"<MaxKeys>{max_keys}</MaxKeys>"
                    f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>"
                    + (f"<NextContinuationToken>{escape(next_token)}</NextContinuationToken>"
                       if truncated else "")
                    + body + "</ListBucketResult>")

    # -- multipart ---------------------------------------------------------

    _UPLOAD_ID_RE = re.compile(r"^[0-9a-f]{32}$")

    def _mp_dir(self, upload_id: str) -> str:
        # uploadId is attacker-controlled: only the exact uuid4-hex shape
        # generated by _create_multipart may reach the path join, else
        # '../' ids escape /.sys/multipart (bypassing the _obj_path guard)
        if not self._UPLOAD_ID_RE.fullmatch(upload_id):
            raise ValueError("invalid upload id")
        return f"{SYS_MULTIPART}/{upload_id}"

    def _check_upload_id(self, h, upload_id: str) -> bool:
        if not self._UPLOAD_ID_RE.fullmatch(upload_id):
            h._drain()  # an unread body desyncs the keep-alive stream
            h._error(404, "NoSuchUpload", "invalid upload id")
            return False
        return True

    def _create_multipart(self, h, t, bucket: str, key: str):
        fs = t.fs
        fs.stat("/" + bucket)
        h._drain()
        upload_id = uuid.uuid4().hex
        fs.makedirs(self._mp_dir(upload_id))
        fs.write_file(f"{self._mp_dir(upload_id)}/.key",
                      f"{bucket}/{key}".encode())
        h._xml(200, f'<InitiateMultipartUploadResult xmlns="{NS}">'
                    f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
                    f"<UploadId>{upload_id}</UploadId>"
                    f"</InitiateMultipartUploadResult>")

    def _upload_part(self, h, t, bucket: str, key: str, upload_id: str, num: int):
        if not self._check_upload_id(h, upload_id):
            return
        fs = t.fs
        length = int(h.headers.get("Content-Length", 0) or 0)
        part = f"{self._mp_dir(upload_id)}/{num:05d}"
        # part bodies stream through the same ingest/dedup write path as
        # plain PUTs — duplicate part content elides its backend PUTs —
        # and land via the same temp+rename: a failed retry of a part
        # must not destroy the earlier good upload of that part number
        tmp, et, got, sha_ok = self._stream_to_temp(h, fs, length)
        if got < length:
            self._discard(fs, tmp)
            h.close_connection = True
            return h._error(400, "IncompleteBody")
        if not sha_ok:
            self._discard(fs, tmp)
            return h._error(400, "XAmzContentSHA256Mismatch")
        try:
            fs.setxattr(tmp, ETAG_XATTR, et.encode())
        except FSError:
            pass
        fs.rename(tmp, part)
        h._empty(200, {"ETag": f'"{et}"'})

    def _complete_multipart(self, h, t, bucket: str, key: str, upload_id: str):
        if not self._check_upload_id(h, upload_id):
            return
        fs = t.fs
        body = h._body()  # part manifest (small control payload)
        if not h._verify_buffered(body):
            return
        mp = self._mp_dir(upload_id)
        names = sorted(
            e.name.decode() for e in fs.listdir(mp) if e.name != b".key"
        )
        path = self._obj_path(bucket, key)
        # server-side stitch: each part's slices are SHARED
        # into a TEMP key at its offset (meta copy_file_range increfs) —
        # zero object-store reads or writes happen here — and the
        # finished object publishes with one rename: a mid-stitch
        # failure (or a GET racing the loop) never sees the live
        # destination truncated or partial.  Parts are deleted only
        # AFTER the rename lands (decref leaves the shared data alone).
        fs.makedirs(self._TMP_DIR)
        tmp = f"{self._TMP_DIR}/{uuid.uuid4().hex}"
        with fs.create(tmp):
            pass
        etags, off = [], 0
        try:
            for n in names:
                ppath = f"{mp}/{n}"
                pattr = fs.stat(ppath)
                try:
                    etags.append(fs.getxattr(ppath, ETAG_XATTR).decode())
                except FSError:
                    etags.append(f"{pattr.length:x}")
                if pattr.length:
                    fs.copy_range(ppath, tmp, off_out=off)
                off += pattr.length
        except FSError:
            self._discard(fs, tmp)
            raise
        et = _etag("".join(etags).encode()) + f"-{len(names)}"
        try:
            fs.setxattr(tmp, ETAG_XATTR, et.encode())
        except FSError:
            pass
        parent = posixpath.dirname(path)
        if parent != "/":
            fs.makedirs(parent)
        fs.rename(tmp, path)
        fs.remove_all(mp)
        h._xml(200, f'<CompleteMultipartUploadResult xmlns="{NS}">'
                    f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
                    f"<ETag>&quot;{et}&quot;</ETag>"
                    f"</CompleteMultipartUploadResult>")

    def _abort_multipart(self, h, t, bucket: str, key: str, upload_id: str):
        if not self._check_upload_id(h, upload_id):
            return
        try:
            t.fs.remove_all(self._mp_dir(upload_id))
        except FSError:
            pass
        h._empty(204)


def _http_date(ts: int) -> str:
    import email.utils

    return email.utils.formatdate(ts, usegmt=True)


def _iso_date(ts: int) -> str:
    import datetime

    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%S.000Z")
