"""Object-plane fault contract of the port.

Only `BreakerOpenError` is here for now: `chunk/parallel.py` must tell an
open circuit (abort the whole stage) from a per-item failure (skip it).
The retry policy, breaker, hedging and `resilience_snapshot()` of
juicefs_tpu/object/resilient.py are still to be ported.
"""

from __future__ import annotations

import errno as _errno


class BreakerOpenError(OSError):
    """Fail-fast: the backend's circuit breaker is open.  An OSError with
    EIO so cache misses surface the ladder's bottom rung to POSIX callers
    without any extra mapping."""

    def __init__(self, backend: str):
        super().__init__(_errno.EIO, f"object backend {backend}: circuit open")
