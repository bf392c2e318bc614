"""Gateway serving plane (a copy of juicefs_tpu/gateway/serve.py).

The presentation adapters (S3, WebDAV) used to buffer every object
end-to-end in handler RAM and run on unbounded ``ThreadingHTTPServer``
threads invisible to the QoS scheduler.  This module is the runtime that
turns them into a first-class heavy-traffic entry point:

  admission      a bounded in-flight gate fronting every request:
                 overload sheds IMMEDIATELY as S3 ``503 SlowDown``
                 (never an unbounded queue, never a 500), so the
                 handler-thread population stays bounded by the gate.
  tenancy        SigV4 authentication maps each access key to a tenant
                 uid; every admitted request runs under
                 ``tenant_scope(uid)`` AND against a per-tenant
                 ``FileSystem`` context, so the meta ops and block I/O a
                 request fans out are DRR-queued under the real tenant
                 (qos/scheduler.py) — handler work is FOREGROUND class
                 on the shared lanes like any other entry point.
  streaming      data paths move block-sized spans between the socket
                 and the vfs: GET streams through ``File.pread`` (the
                 streaming reader sees the sequential spans and
                 ramps readahead), PUT/UploadPart stream the request
                 body into ``File.write`` (bytes ride the
                 ingest/dedup/compress plane), and at most ONE span per
                 request is ever buffered gateway-side (the
                 ``juicefs_gateway_stream_buffer_bytes`` gauge is the
                 acceptance counter).
  operability    pinned ``juicefs_gateway_*`` metrics and a ``.status``
                 gateway section (in-flight, shed, per-tenant rates,
                 streaming buffers) via ``status_for(vfs)``.

``parse_range`` is the ONE Range-header parser: suffix/inverted/
multi-range semantics are defined (and unit-tested) once.
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from contextlib import contextmanager
from typing import Iterator, Optional

from ..fs import FileSystem, FSError
from ..meta.context import Context
from ..meta.types import TYPE_DIRECTORY
from ..metric import global_registry
from ..qos import tenant_scope
from ..gpu.jth256 import digest_hex
from .. import native
from ..utils import get_logger

logger = get_logger("gateway.serve")

_reg = global_registry()
_REQUESTS = _reg.counter(
    "juicefs_gateway_requests",
    "Requests admitted by the gateway serving plane", ("op",),
)
_SHED = _reg.counter(
    "juicefs_gateway_shed",
    "Requests shed as 503 SlowDown by the admission gate",
)
_ERRORS = _reg.counter(
    "juicefs_gateway_errors",
    "Error responses sent by the gateway", ("family",),
)
_AUTH_FAILURES = _reg.counter(
    "juicefs_gateway_auth_failures",
    "Requests rejected by the SigV4 authenticator",
)
_BYTES_IN = _reg.counter(
    "juicefs_gateway_bytes_in",
    "Object bytes streamed from clients into the volume",
)
_BYTES_OUT = _reg.counter(
    "juicefs_gateway_bytes_out",
    "Object bytes streamed from the volume to clients",
)
_REQ_SECONDS = _reg.histogram(
    "juicefs_gateway_request_seconds",
    "Admitted-request wall time per op", ("op",),
)

# live planes for the process-level gauges + the per-vfs .status section
_LIVE_PLANES: "weakref.WeakSet[ServingPlane]" = weakref.WeakSet()


def _sum_planes(fn) -> float:
    total = 0
    try:
        for p in list(_LIVE_PLANES):
            total += fn(p)
    except Exception as e:
        # racing a plane teardown must never break a scrape
        logger.debug("gateway gauge scrape raced a teardown: %s", e)
    return total


_reg.gauge(
    "juicefs_gateway_inflight",
    "Requests currently inside the admission gate",
).set_function(lambda: _sum_planes(lambda p: p.gate.inflight))
_reg.gauge(
    "juicefs_gateway_stream_buffer_bytes",
    "Gateway-side streaming buffer bytes currently held "
    "(bounded: one block-sized span per admitted request)",
).set_function(lambda: _sum_planes(lambda p: p._buffered))


# ---------------------------------------------------------------- ranges --

UNSATISFIABLE = object()  # parse_range sentinel: respond 416


def parse_range(rng: Optional[str], total: int):
    """The ONE RFC 7233 Range parser both adapters use.

    Returns ``None`` (serve the full body, 200), ``(start, end)``
    inclusive (206), or the ``UNSATISFIABLE`` sentinel (416).  Semantics
    shared by S3 and WebDAV:

      - only single ``bytes=`` ranges; a multi-range spec (comma) is
        IGNORED (RFC 7233 lets a server serve the full representation);
      - malformed or syntactically inverted specs are ignored;
      - ``bytes=a-b`` clamps ``b`` to the last byte;
      - ``bytes=a-`` with ``a >= total`` is unsatisfiable;
      - suffix ``bytes=-N`` takes the last N bytes; ``-0`` (and any
        range against an empty body) is unsatisfiable per the RFC.
    """
    if not rng or not rng.startswith("bytes=") or "," in rng:
        return None
    spec = rng[6:].strip()
    a, sep, b = spec.partition("-")
    if not sep:
        return None
    try:
        if a:
            start = int(a)
            if start < 0:
                return None
            if b:
                end = int(b)
                if end < start:
                    return None  # inverted: ignore the header
                end = min(end, total - 1)
            else:
                end = total - 1
            if start >= total:
                return UNSATISFIABLE
            return start, end
        # suffix-range: last N bytes; N must be a plain non-negative int
        if not b.isdigit():
            return None
        n = int(b)
        if n == 0 or total == 0:
            return UNSATISFIABLE
        return max(0, total - n), total - 1
    except ValueError:
        return None  # malformed: ignore the header (RFC 7233)


# ------------------------------------------------------------- streaming --

def stream_file_out(wfile, f, start: int, length: int, span: int,
                    account=None) -> int:
    """Stream ``length`` bytes of open file ``f`` from ``start`` to the
    socket in ``span``-sized pieces.  Each piece rides ``File.pread`` —
    the vfs streaming reader sees the sequential spans and ramps its
    readahead window — and is released from the gateway-side
    buffer before the next is read (bounded per-request buffering).
    Returns bytes actually written; a short vfs read (file truncated
    mid-stream) stops early — the caller must close the connection so
    the client sees the truncation instead of a hung keep-alive."""
    sent = 0
    span = max(1, span)
    while sent < length:
        n = min(span, length - sent)
        data = f.pread(start + sent, n)
        if not data:
            break
        if account is not None:
            account(len(data))
        try:
            wfile.write(data)
        finally:
            if account is not None:
                account(-len(data))
        _BYTES_OUT.inc(len(data))
        sent += len(data)
        if len(data) < n:
            break
    return sent


class StreamingEtag:
    """Incremental JTH-256 ETag over streamed spans.

    A body that fits one span hashes exactly like the buffered seed path
    (``jth256(data)``); a larger stream folds the per-span digests into
    a tree digest (the same shape multipart ETags already have — the
    value is opaque to clients, stored in the etag xattr)."""

    def __init__(self):
        self._first: Optional[bytes] = None
        self._tree = None
        self._spans = 0

    def update(self, piece: bytes) -> None:
        self._spans += 1
        if self._spans == 1:
            self._first = bytes(piece)
            return
        if self._tree is None:
            self._tree = hashlib.sha256()  # fold carrier for span digests
            self._tree.update(native.jth256(self._first))
            self._first = None
        self._tree.update(native.jth256(bytes(piece)))

    def hexdigest(self) -> str:
        if self._tree is not None:
            return digest_hex(native.jth256(self._tree.digest()))[:32]
        return digest_hex(native.jth256(self._first or b""))[:32]


def stream_body_in(rfile, f, length: int, span: int, account=None,
                   want_sha: Optional[str] = None, consumed=None):
    """Stream ``length`` request-body bytes into open file ``f`` in
    ``span``-sized pieces, so the bytes ride the vfs write pipeline
    (slice-building, inline dedup, batched compression) instead of one
    end-to-end RAM buffer.  Returns ``(etag_hex, bytes_read, sha_ok)``:
    ``bytes_read < length`` means the client truncated the body;
    ``sha_ok`` is False when ``want_sha`` (a signed x-amz-content-sha256)
    does not match the streamed payload — the caller unwinds the write.
    ``consumed`` (the handler's body accounting) is credited piece by
    piece AS the socket is read, never post-hoc: a mid-stream vfs write
    failure must not leave the error path believing the body is still
    unread (its drain would block on bytes that never come, then eat
    the next pipelined request)."""
    etag = StreamingEtag()
    sha = hashlib.sha256() if want_sha else None
    got = 0
    span = max(1, span)
    while got < length:
        piece = rfile.read(min(span, length - got))
        if not piece:
            break
        if consumed is not None:
            consumed(len(piece))
        if account is not None:
            account(len(piece))
        try:
            etag.update(piece)
            if sha is not None:
                sha.update(piece)
            f.write(piece)
        finally:
            if account is not None:
                account(-len(piece))
        _BYTES_IN.inc(len(piece))
        got += len(piece)
    sha_ok = sha is None or sha.hexdigest() == want_sha
    return etag.hexdigest(), got, sha_ok


# ------------------------------------------------------------- admission --

class AdmissionGate:
    """Bounded in-flight admission: overload sheds, never queues.

    ``max_inflight`` bounds the requests concurrently past the gate (and
    with them the handler threads doing real work); a request arriving
    at the bound is refused immediately — the adapter turns that into
    S3 ``503 SlowDown`` — so a traffic spike degrades into counted,
    retryable sheds instead of an unbounded thread/queue pileup."""

    def __init__(self, max_inflight: int = 64):
        self.max_inflight = max(1, int(max_inflight))
        self._lock = threading.Lock()
        self.inflight = 0
        self.admitted = 0
        self.shed = 0

    def try_enter(self) -> bool:
        with self._lock:
            if self.inflight >= self.max_inflight:
                self.shed += 1
                return False
            self.inflight += 1
            self.admitted += 1
            return True

    def leave(self) -> None:
        with self._lock:
            self.inflight -= 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"max_inflight": self.max_inflight,
                    "inflight": self.inflight,
                    "admitted": self.admitted, "shed": self.shed}


# ---------------------------------------------------------------- tenancy --

# synthetic uid base for access-key tenants: far above real system uids
# so gateway tenants never collide with FUSE users in the DRR queues
TENANT_UID_BASE = 3_000_000


def tenant_uid(access_key: str) -> int:
    """Deterministic tenant uid for an access key: STABLE across gateway
    restarts and adapter instances (arrival-order assignment would remap
    file ownership and the DRR fair-queue identity on every restart).
    Stays under 2^31 (kernel uid space); a hash collision merely makes
    two keys share a fair queue and ownership — safe, and vanishingly
    rare at realistic key counts."""
    h = int.from_bytes(
        hashlib.sha256(access_key.encode()).digest()[:4], "big")
    return TENANT_UID_BASE + h % 1_000_000_000


class Tenant:
    """One authenticated principal: its access key, uid, and the
    FileSystem context every op of its requests runs under."""

    __slots__ = ("name", "uid", "fs")

    def __init__(self, name: str, uid: int, fs: FileSystem):
        self.name = name
        self.uid = uid
        self.fs = fs


class GatewayAuth:
    """SigV4 verification over a MULTI-key registry: each access key is
    its own tenant (reference: MinIO's auth layer fronting pkg/gateway).
    With no keys registered the gateway runs in trusted-boundary mode
    (auth accepted as-is, single anonymous tenant)."""

    def __init__(self):
        self._signers: dict[str, object] = {}

    def add_key(self, access_key: str, secret_key: str) -> None:
        from ..object.s3 import SigV4

        self._signers[access_key] = SigV4(access_key, secret_key)

    @property
    def enabled(self) -> bool:
        return bool(self._signers)

    def access_keys(self) -> list[str]:
        return sorted(self._signers)

    def verify(self, method: str, path: str, query: dict,
               headers: dict, authorization: str) -> Optional[str]:
        """Returns the authenticated ACCESS KEY, or None."""
        try:
            cred = dict(
                p.strip().split("=", 1)
                for p in authorization.split(" ", 1)[1].split(",")
            )["Credential"].split("/")[0]
        except (KeyError, IndexError, ValueError):
            return None
        signer = self._signers.get(cred)
        if signer is None:
            return None
        if signer.verify(method, path, query, headers, authorization):
            return cred
        return None


# ------------------------------------------------------------ key walker --

class OrderedKeyWalker:
    """Lexicographic, resumable object-key stream over one bucket.

    ListObjectsV2 at scale: keys stream in S3 sort order from
    an incremental directory walk — one listing per directory actually
    entered, never a full-bucket recursion — so memory at any page size
    is bounded by (directory fan-out x depth), not bucket size.

      prefix   only keys starting with it; subtrees that cannot match
               are pruned without being listed
      after    strictly-greater resumption bound (continuation-token /
               start-after / marker): subtrees entirely <= after are
               pruned without being listed
      skip     settable mid-iteration: while a key starts with it, the
               walker discards without yielding and prunes whole
               directories under it — how the delimiter roll-up skips
               a CommonPrefixes subtree it will never emit from

    Ordering subtlety: entries sort by ``name + '/'`` for directories
    (a directory's keys all carry the trailing slash, so ``foo.txt``
    must sort BEFORE the subtree of directory ``foo`` — byte 0x2e < 0x2f
    — which a bare name sort gets wrong)."""

    def __init__(self, fs: FileSystem, bucket: str, prefix: str = "",
                 after: str = ""):
        self.fs = fs
        self.bucket = bucket
        self.prefix = prefix
        self.after = after
        # a common-prefix continuation token must ALSO skip its whole
        # subtree — but only the handler knows the delimiter (a bare
        # start-after that happens to end with "/" still lists the keys
        # inside), so the handler sets `skip`, never the constructor
        self.skip = ""

    def __iter__(self) -> Iterator[tuple[str, object]]:
        return self._walk("")

    def _walk(self, rel: str) -> Iterator[tuple[str, object]]:
        try:
            entries = self.fs.listdir(
                f"/{self.bucket}/{rel}" if rel else f"/{self.bucket}",
                want_attr=True,
            )
        except FSError:
            return
        items = []
        for e in entries:
            # dotted names are ordinary S3 keys: the multipart staging
            # area (/.sys) is a sibling of the buckets at the VOLUME
            # root, never inside one, so nothing here needs hiding
            name = e.name.decode()
            is_dir = bool(e.attr and e.attr.typ == TYPE_DIRECTORY)
            items.append((name + "/" if is_dir else name, name, is_dir, e))
        items.sort(key=lambda it: it[0])
        for _sort_key, name, is_dir, e in items:
            key = rel + name
            if is_dir:
                dkey = key + "/"
                # prune: cannot match the prefix, entirely consumed by
                # the resumption bound, or inside the skip subtree
                if self.prefix and not (dkey.startswith(self.prefix)
                                        or self.prefix.startswith(dkey)):
                    continue
                if self.after and not (dkey > self.after
                                       or self.after.startswith(dkey)):
                    continue
                if self.skip and dkey.startswith(self.skip):
                    continue
                yield from self._walk(dkey)
            else:
                if key <= self.after or not key.startswith(self.prefix):
                    continue
                if self.skip and key.startswith(self.skip):
                    continue
                yield key, e.attr


# ------------------------------------------------------------- the plane --

class ServingPlane:
    """Per-gateway runtime: admission, tenancy, stream accounting, and
    the ``.status`` gateway section.  One per adapter instance; all
    planes over one vfs aggregate in ``status_for``."""

    def __init__(self, vfs, auth: Optional[GatewayAuth] = None,
                 max_inflight: int = 64):
        self.vfs = vfs
        self.auth = auth or GatewayAuth()
        self.gate = AdmissionGate(max_inflight)
        # per-request streaming budget: the helpers hold at most ONE
        # span of block_size bytes at a time (the acceptance bound)
        self.span = int(vfs.store.conf.block_size)
        self._lock = threading.Lock()
        self._buffered = 0
        self.buffered_peak = 0
        self._tenants: dict[str, Tenant] = {}
        self._tenant_ops: dict[str, int] = {}
        self._requests: dict[str, int] = {}
        _LIVE_PLANES.add(self)

    # -- tenancy -----------------------------------------------------------
    def bind_anonymous(self, fs: FileSystem) -> Tenant:
        """Trusted-boundary principal: serves through the CALLER's
        FileSystem context instead of a synthetic tenant uid."""
        with self._lock:
            t = Tenant("anonymous", getattr(fs.ctx, "uid", 0), fs)
            self._tenants[""] = t
            return t

    def tenant(self, name: str) -> Tenant:
        """Get-or-create the tenant context for an access key (or the
        anonymous principal in trusted-boundary mode)."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                uid = 0 if name == "" else tenant_uid(name)
                fs = FileSystem(self.vfs, Context(uid=uid, gid=uid, pid=0))
                t = self._tenants[name] = Tenant(name or "anonymous", uid, fs)
            return t

    # -- admission ---------------------------------------------------------
    @contextmanager
    def admitted(self, op: str, tenant: Optional[Tenant] = None):
        """Admission scope around one request's dispatch: sheds at the
        gate (yields None — the adapter answers 503 SlowDown), else runs
        the body FOREGROUND under the tenant's scope so every meta op
        and block I/O it fans out lands in the tenant's DRR queue."""
        import time as _time

        if not self.gate.try_enter():
            _SHED.inc()
            yield None
            return
        _REQUESTS.labels(op).inc()
        uid = tenant.uid if tenant is not None else 0
        name = tenant.name if tenant is not None else "anonymous"
        with self._lock:
            self._requests[op] = self._requests.get(op, 0) + 1
            self._tenant_ops[name] = self._tenant_ops.get(name, 0) + 1
        t0 = _time.perf_counter()
        try:
            with tenant_scope(uid):
                yield self
        finally:
            self.gate.leave()
            _REQ_SECONDS.labels(op).observe(_time.perf_counter() - t0)

    # -- stream accounting -------------------------------------------------
    def _account(self, delta: int) -> None:
        with self._lock:
            self._buffered += delta
            if self._buffered > self.buffered_peak:
                self.buffered_peak = self._buffered

    def stream_out(self, wfile, f, start: int, length: int) -> int:
        return stream_file_out(wfile, f, start, length, self.span,
                               account=self._account)

    def write_span(self, wfile, data) -> int:
        """Write one already-read span with buffer accounting (the
        pre-header first span of a GET)."""
        if not data:
            return 0
        self._account(len(data))
        try:
            wfile.write(data)
        finally:
            self._account(-len(data))
        _BYTES_OUT.inc(len(data))
        return len(data)

    def stream_in(self, handler, f, length: int,
                  want_sha: Optional[str] = None):
        """Stream the handler's request body into ``f``, crediting the
        handler's consumed-byte accounting per piece (so its error-path
        drain stays exact even when the vfs write dies mid-stream)."""
        return stream_body_in(handler.rfile, f, length, self.span,
                              account=self._account, want_sha=want_sha,
                              consumed=handler._note_consumed)

    # -- observability -----------------------------------------------------
    def note_error(self, code: int) -> None:
        if code >= 400:
            _ERRORS.labels("5xx" if code >= 500 else "4xx").inc()

    def note_auth_failure(self) -> None:
        _AUTH_FAILURES.inc()

    def stats(self) -> dict:
        with self._lock:
            return {
                "admission": self.gate.snapshot(),
                "requests": dict(self._requests),
                "tenants": dict(self._tenant_ops),
                "streaming": {
                    "span_bytes": self.span,
                    "window_bytes": self.span,
                    "buffered_bytes": self._buffered,
                    "buffered_peak": self.buffered_peak,
                },
                "auth": {"enabled": self.auth.enabled,
                         "keys": len(self.auth.access_keys())},
            }


def status_for(vfs) -> Optional[dict]:
    """Aggregate ``.status`` gateway section for every live plane over
    this vfs (vfs/internal.py consults it; None = no gateway attached)."""
    planes = [p for p in list(_LIVE_PLANES) if p.vfs is vfs]
    if not planes:
        return None
    if len(planes) == 1:
        return planes[0].stats()
    return {"adapters": [p.stats() for p in planes]}
