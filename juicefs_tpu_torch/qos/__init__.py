"""Unified I/O QoS subsystem (a copy of juicefs_tpu/qos): one scheduler for every pool,
priority classes, per-tenant DRR fair queueing, and hierarchical
token-bucket bandwidth shaping charged at the object boundary.

    from juicefs_tpu_torch import qos
    ex = qos.global_scheduler().executor("download", qos.IOClass.BACKGROUND)
    fut = ex.submit(fetch_fn, key)

See docs/ARCHITECTURE.md "QoS & scheduling" for the class table, the
lane graph, and the pool-migration map.
"""

from .context import QosContext, scoped, tenant_scope
from .limiter import (
    GatedStorage,
    Limiter,
    ShapedStorage,
    TokenBucket,
    gated,
    shaped,
)
from .scheduler import (
    ClassExecutor,
    IOClass,
    Scheduler,
    global_scheduler,
    maybe_global_scheduler,
)

__all__ = [
    "ClassExecutor",
    "GatedStorage",
    "IOClass",
    "Limiter",
    "QosContext",
    "Scheduler",
    "ShapedStorage",
    "TokenBucket",
    "gated",
    "global_scheduler",
    "maybe_global_scheduler",
    "scoped",
    "shaped",
    "tenant_scope",
]
