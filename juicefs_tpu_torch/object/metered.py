"""Per-backend object-op metrics + object-layer spans (a copy of
juicefs_tpu/object/metered.py).

Role-match to the reference's per-op meters in pkg/chunk/cached_store.go:
653-932 (object_request_durations_histogram / object_request_errors /
object_request_data_bytes), but implemented as a transparent ObjectStorage
wrapper so every stack (mount, gateway, gc, bench) meters the true object
boundary — beneath the chunk cache, above the wire driver. The chunk store
wraps its storage with `metered()` automatically; wrapping is idempotent.
"""

from __future__ import annotations

import errno as _errno

from ..metric import global_registry
from ..metric.trace import global_tracer
from ..utils import get_logger
from .interface import NotFoundError, ObjectStorage

logger = get_logger("object.metered")

_reg = global_registry()
_DUR = _reg.histogram(
    "juicefs_object_request_durations_histogram_seconds",
    "Object storage request latencies (reference cached_store.go:653-932)",
    ("method", "backend"),
)
_ERRORS = _reg.counter(
    "juicefs_object_request_errors",
    "Failed object storage requests (missing keys excluded)",
    ("method", "backend"),
)
_DATA_BYTES = _reg.counter(
    "juicefs_object_request_data_bytes",
    "Bytes moved to/from object storage",
    ("method", "backend"),
)
_TR = global_tracer()


class MeteredStorage(ObjectStorage):
    """Transparent metering wrapper; unknown attributes delegate to the
    wrapped store so driver-specific surfaces stay reachable."""

    def __init__(self, inner: ObjectStorage):
        self._inner = inner
        try:
            backend = inner.string().split("://", 1)[0] or type(inner).__name__
        except Exception as e:
            backend = type(inner).__name__
            logger.debug("backend label fell back to %s: %s", backend, e)
        self.backend = backend
        # hot-path children pre-resolved once (labels() locks a dict)
        self._h_get = _DUR.labels("GET", backend)
        self._h_put = _DUR.labels("PUT", backend)
        self._h_delete = _DUR.labels("DELETE", backend)
        self._h_head = _DUR.labels("HEAD", backend)
        self._e_get = _ERRORS.labels("GET", backend)
        self._e_put = _ERRORS.labels("PUT", backend)
        self._e_delete = _ERRORS.labels("DELETE", backend)
        self._e_head = _ERRORS.labels("HEAD", backend)
        self._b_get = _DATA_BYTES.labels("GET", backend)
        self._b_put = _DATA_BYTES.labels("PUT", backend)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- metered data ops --------------------------------------------------
    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        with _TR.span("object", "get", hist=self._h_get) as sp:
            try:
                data = self._inner.get(key, off, limit)
            except NotFoundError:
                if sp.active:
                    sp.set(key=key, errno=_errno.ENOENT)
                raise
            except Exception as e:
                self._e_get.inc()
                if sp.active:
                    sp.set(key=key, error=type(e).__name__)
                raise
            self._b_get.inc(len(data))
            if sp.active:
                sp.set(key=key, bytes=len(data), backend=self.backend)
            return data

    def put(self, key: str, data: bytes) -> None:
        with _TR.span("object", "put", hist=self._h_put) as sp:
            try:
                self._inner.put(key, data)
            except Exception as e:
                self._e_put.inc()
                if sp.active:
                    sp.set(key=key, error=type(e).__name__)
                raise
            self._b_put.inc(len(data))
            if sp.active:
                sp.set(key=key, bytes=len(data), backend=self.backend)

    def delete(self, key: str) -> None:
        with _TR.span("object", "delete", hist=self._h_delete) as sp:
            try:
                self._inner.delete(key)
            except Exception as e:
                self._e_delete.inc()
                if sp.active:
                    sp.set(key=key, error=type(e).__name__)
                raise
            if sp.active:
                sp.set(key=key, backend=self.backend)

    def head(self, key: str):
        with self._h_head.time():
            try:
                return self._inner.head(key)
            except NotFoundError:
                raise
            except Exception:
                self._e_head.inc()
                raise

    # -- transparent delegation --------------------------------------------
    def string(self) -> str:
        return self._inner.string()

    def create(self) -> None:
        self._inner.create()

    def copy(self, dst: str, src: str) -> None:
        self._inner.copy(dst, src)

    def list_all(self, prefix: str = "", marker: str = ""):
        return self._inner.list_all(prefix, marker)

    def list(self, prefix: str = "", marker: str = "", limit: int = 1000):
        return self._inner.list(prefix, marker, limit)

    def create_multipart_upload(self, key: str):
        return self._inner.create_multipart_upload(key)

    def upload_part(self, key: str, upload_id: str, num: int, data: bytes):
        return self._inner.upload_part(key, upload_id, num, data)

    def complete_upload(self, key: str, upload_id: str, parts) -> None:
        self._inner.complete_upload(key, upload_id, parts)

    def abort_upload(self, key: str, upload_id: str) -> None:
        self._inner.abort_upload(key, upload_id)

    def limits(self) -> dict:
        return self._inner.limits()


def metered(store: ObjectStorage) -> ObjectStorage:
    """Idempotently wrap a store with per-backend op metrics."""
    if isinstance(store, MeteredStorage):
        return store
    return MeteredStorage(store)
