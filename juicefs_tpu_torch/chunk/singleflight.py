"""Singleflight: dedup concurrent loads of the same block
(a copy of juicefs_tpu/chunk/singleflight.py; reference
pkg/chunk/singleflight.go)."""

from __future__ import annotations

import threading
from typing import Callable, Hashable

from ..metric import global_registry

_reg = global_registry()
_CALLS = _reg.counter(
    "juicefs_singleflight_calls", "Singleflight fetches executed (leaders)"
)
_SHARED = _reg.counter(
    "juicefs_singleflight_shared",
    "Concurrent fetches deduplicated onto an in-flight leader",
)


class _Call:
    __slots__ = ("done", "result", "error")

    def __init__(self):
        self.done = threading.Event()
        self.result = None
        self.error: BaseException | None = None


class SingleFlight:
    def __init__(self):
        self._calls: dict[Hashable, _Call] = {}
        self._lock = threading.Lock()

    def do(self, key: Hashable, fn: Callable[[], object]):
        with self._lock:
            call = self._calls.get(key)
            if call is not None:
                leader = False
            else:
                call = _Call()
                self._calls[key] = call
                leader = True
        if not leader:
            _SHARED.inc()
            call.done.wait()
            if call.error is not None:
                raise call.error
            return call.result
        _CALLS.inc()
        try:
            call.result = fn()
            return call.result
        except BaseException as e:
            call.error = e
            raise
        finally:
            with self._lock:
                self._calls.pop(key, None)
            call.done.set()
