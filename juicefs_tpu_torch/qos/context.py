"""Ambient QoS context: which (tenant, weight, class) the current thread
is doing I/O for (a copy of juicefs_tpu/qos/context.py).

Dependency-free on purpose: the scheduler sets it around task execution,
the VFS entry points set the tenant from the request uid, the resilience
layer carries it across its elastic-pool crossing (so retries and hedges
are charged to the op that spawned them), and the bandwidth limiter reads
the class for per-class sub-bucket attribution.

Inheritance rules implemented on top of this module (qos/scheduler.py):
  - a nested submit inherits the ambient tenant/weight, so a read fan-out
    stays attributed to the uid that opened the file;
  - a nested submit never ESCALATES class: work submitted from a
    BACKGROUND task runs at BACKGROUND even through a FOREGROUND-class
    executor (compaction reads must not jump the queue just because they
    ride `RSlice.read`).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Optional

DEFAULT_TENANT = 0

_tls = threading.local()


class QosContext:
    __slots__ = ("tenant", "weight", "cls")

    def __init__(self, tenant=DEFAULT_TENANT, weight: int = 1, cls=None):
        self.tenant = tenant
        self.weight = max(1, int(weight))
        self.cls = cls  # an IOClass, or None outside scheduler workers


def current() -> Optional[QosContext]:
    return getattr(_tls, "ctx", None)


@contextmanager
def applied(ctx: Optional[QosContext]) -> Iterator[None]:
    """Install `ctx` as the thread's ambient QoS context (None = clear)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


@contextmanager
def scoped(cls=None, tenant=None, weight=None) -> Iterator[None]:
    """Override parts of the ambient context for a region of the CURRENT
    thread — e.g. `scoped(cls=IOClass.BACKGROUND)` around a compaction
    body demotes every nested submit (reads AND rewrite uploads) to
    background priority regardless of which executor they ride."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = QosContext(
        tenant if tenant is not None
        else (prev.tenant if prev else DEFAULT_TENANT),
        weight if weight is not None else (prev.weight if prev else 1),
        cls if cls is not None else (prev.cls if prev else None),
    )
    try:
        yield
    finally:
        _tls.ctx = prev


@contextmanager
def tenant_scope(tenant, weight: int = 1) -> Iterator[None]:
    """Tag this thread's I/O with a tenant (the VFS uses the request uid).
    The class stays whatever the ambient context says — entry points run
    outside scheduler workers, so it is None there."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = QosContext(tenant, weight, prev.cls if prev else None)
    try:
        yield
    finally:
        _tls.ctx = prev
