"""Runtime lock-order watchdog (a copy of juicefs_tpu/utils/lockwatch.py,
watching the port's own files): the dynamic complement to
``tools/analyze``'s static passes, covering what an AST walk cannot see
through dynamic dispatch.

Opt-in via ``JUICEFS_LOCK_WATCHDOG=1`` + :func:`install`; importing the
module installs nothing.  ``install()``
patches, for callers inside ``juicefs_tpu_torch/`` only (the creation site's
frame decides — stdlib and test-code locks stay raw):

* ``threading.Lock`` / ``threading.RLock`` / ``threading.Condition`` —
  construction returns a watched wrapper.  Locks are classed
  lockdep-style by CREATION SITE (``file:line``): every instance born at
  a site shares one node in the acquisition-order graph, so an inversion
  between two *instances* of the same pair of sites is still caught.

and, process-wide (they only record when the calling thread holds a
watched lock):

* ``Future.result()/.exception()`` on a not-done future,
  ``queue.Queue.get/put`` with ``block=True``, ``threading.Event.wait``
  on an unset event, and ``time.sleep`` — the holds-while-blocking set,
  mirroring the static ``blocking-under-lock`` rule.

Detection is graph-based, not interleaving-based: thread 1 taking A then
B and thread 2 taking B then A is reported even when the schedule never
actually deadlocks — the edge set carries the cycle.  ``Condition.wait``
is handled correctly: the wrapper's ``_release_save`` bookkeeping drops
the condition's own lock for the duration of the wait.

Intentional holds-while-blocking sites wrap the region in
``permit("<reason>")`` — the runtime twin of the static
``# analyze: allow(blocking-under-lock) -- reason`` comment.

Violations accumulate in a process-global state for a test fixture to
check.  Drills use :func:`scoped_state` for an
isolated graph and :func:`watched_lock` for explicit wrappers.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
import _thread

_JUICEFS_MARK = os.sep + "juicefs_tpu_torch" + os.sep

# real factories captured at import time — the wrappers must build their
# inner primitives from these, never from the (possibly patched)
# threading module attributes
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

_tls = threading.local()


def enabled() -> bool:
    return os.environ.get("JUICEFS_LOCK_WATCHDOG", "") not in ("", "0")


# ---------------------------------------------------------------------------
# state: site-classed acquisition graph + violations

class State:
    """One watchdog universe: edge graph, violation list."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        # (site_a, site_b) -> (thread_name, short_stack): B acquired
        # while A held
        self.edges: dict[tuple[str, str], tuple[str, str]] = {}
        self._adj: dict[str, set[str]] = {}
        self.violations: list[dict] = []

    def note_edge(self, a: "WatchedLock", b: "WatchedLock") -> None:
        key = (a.site, b.site)
        with self._mu:
            if key in self.edges:
                return
            stack = _short_stack()
            self.edges[key] = (threading.current_thread().name, stack)
            if a.site == b.site:
                if b.reentrant:
                    return   # distinct RLock instances of one class: benign
                self.violations.append({
                    "kind": "inversion",
                    "detail": f"nested acquisition of lock class {a.site} "
                              "(two instances, non-reentrant): two threads "
                              "doing this in opposite instance order "
                              "deadlock",
                    "thread": threading.current_thread().name,
                    "stack": stack,
                })
                return
            self._adj.setdefault(a.site, set()).add(b.site)
            path = self._path(b.site, a.site)
            if path is not None:
                prev_thread, prev_stack = self.edges.get(
                    (path[0], path[1]), ("?", ""))
                self.violations.append({
                    "kind": "inversion",
                    "detail": (
                        f"lock-order inversion: {a.site} -> {b.site} here, "
                        f"but {' -> '.join(path)} was established by thread "
                        f"{prev_thread}"),
                    "thread": threading.current_thread().name,
                    "stack": stack + "\n  -- conflicting order:\n"
                             + prev_stack,
                })

    def _path(self, src: str, dst: str):
        """A path src -> ... -> dst in the site graph, else None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def note_blocking(self, op: str, held: list["WatchedLock"]) -> None:
        with self._mu:
            self.violations.append({
                "kind": "holds-while-blocking",
                "detail": f"{op} while holding "
                          + ", ".join(sorted({h.site for h in held})),
                "thread": threading.current_thread().name,
                "stack": _short_stack(),
            })

    def snapshot(self) -> list[dict]:
        with self._mu:
            return list(self.violations)

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self._adj.clear()
            self.violations.clear()


_state = State()


def state() -> State:
    return _state


def violations() -> list[dict]:
    return _state.snapshot()


def reset() -> None:
    _state.reset()


class scoped_state:
    """Swap in a fresh State for a drill; restores the old one on exit.
    (Tier-1 runs tests serially; background threads recording into the
    drill state merely add noise a drill's presence-assertions ignore.)"""

    def __enter__(self) -> State:
        global _state
        self._saved = _state
        _state = State()
        return _state

    def __exit__(self, *exc) -> None:
        global _state
        _state = self._saved


def _short_stack(limit: int = 14) -> str:
    frames = traceback.extract_stack()[:-3]
    keep = [f for f in frames
            if _JUICEFS_MARK in f.filename or "tests" + os.sep in f.filename]
    tail = (keep or frames)[-4:]
    return "\n".join(f"  {os.path.basename(f.filename)}:{f.lineno} "
                     f"in {f.name}" for f in tail[:limit])


# ---------------------------------------------------------------------------
# thread-held bookkeeping

def _held() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def _permits() -> int:
    return getattr(_tls, "permits", 0)


class permit:
    """Mark a region as an intentionally-blocking-under-lock site.  The
    runtime twin of `# analyze: allow(blocking-under-lock) -- reason`;
    the reason is mandatory and kept for the report."""

    def __init__(self, reason: str):
        if not reason or not reason.strip():
            raise ValueError("lockwatch.permit requires a written reason")
        self.reason = reason

    def __enter__(self):
        _tls.permits = _permits() + 1
        return self

    def __exit__(self, *exc):
        _tls.permits = _permits() - 1


def _note_acquire(lock: "WatchedLock") -> None:
    stack = _held()
    if not any(e is lock for e in stack):   # reentry records no edges
        for h in stack:
            _state.note_edge(h, lock)
    stack.append(lock)


def _note_release(lock: "WatchedLock") -> None:
    stack = _held()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is lock:
            del stack[i]
            return


# ---------------------------------------------------------------------------
# wrappers

class WatchedLock:
    """threading.Lock-compatible wrapper recording acquisition order."""

    __slots__ = ("_inner", "site")
    reentrant = False

    def __init__(self, site: str, inner=None):
        self._inner = inner if inner is not None else _REAL_LOCK()
        self.site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquire(self)
        return ok

    def release(self) -> None:
        _note_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WatchedLock {self.site} inner={self._inner!r}>"


class WatchedRLock:
    """threading.RLock-compatible wrapper, incl. the Condition protocol
    (`_release_save`/`_acquire_restore`/`_is_owned`) with correct
    held-set bookkeeping across a Condition.wait."""

    __slots__ = ("_inner", "site")
    reentrant = True

    def __init__(self, site: str, inner=None):
        self._inner = inner if inner is not None else _REAL_RLOCK()
        self.site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquire(self)
        return ok

    def release(self) -> None:
        _note_release(self)
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition protocol: wait() releases ALL recursion levels
    def _release_save(self):
        stack = _held()
        n = sum(1 for e in stack if e is self)
        state = self._inner._release_save()
        for _ in range(n):
            _note_release(self)
        return (state, n)

    def _acquire_restore(self, saved) -> None:
        state, n = saved
        self._inner._acquire_restore(state)
        for _ in range(n):
            _note_acquire(self)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def __repr__(self) -> str:
        return f"<WatchedRLock {self.site} inner={self._inner!r}>"


def _caller_site(depth: int = 2):
    """(site, is_juicefs) for the construction site `depth` frames up."""
    f = sys._getframe(depth)
    fn = f.f_code.co_filename
    if _JUICEFS_MARK not in fn:
        return None
    mark = fn.rindex(_JUICEFS_MARK)
    short = fn[mark + 1:].replace(os.sep, "/")
    return f"{short}:{f.f_lineno}"


def watched_lock(site: str = "", rlock: bool = False):
    """Explicit wrapper factory (drills, opt-in call sites)."""
    if not site:
        site = _caller_site() or "adhoc"
    return WatchedRLock(site) if rlock else WatchedLock(site)


# ---------------------------------------------------------------------------
# install / uninstall

_installed = False
_saved: dict = {}


def install() -> bool:
    """Patch the factories and the blocking set.  Idempotent; no-op
    (returns False) when JUICEFS_LOCK_WATCHDOG is not set."""
    global _installed
    if _installed or not enabled():
        return _installed
    import queue as _queue
    import time as _time
    from concurrent.futures import Future as _Future

    real_lock = threading.Lock
    real_rlock = threading.RLock
    real_cond = threading.Condition

    def lock_factory():
        site = _caller_site()
        if site is None:
            return real_lock()
        return WatchedLock(site)

    def rlock_factory():
        site = _caller_site()
        if site is None:
            return real_rlock()
        return WatchedRLock(site)

    def condition_factory(lock=None):
        if lock is None:
            site = _caller_site()
            if site is not None:
                lock = WatchedRLock(site)
        return real_cond(lock)

    _saved.update(
        lock=real_lock, rlock=real_rlock, cond=real_cond,
        fut_result=_Future.result, fut_exception=_Future.exception,
        q_get=_queue.Queue.get, q_put=_queue.Queue.put,
        ev_wait=threading.Event.wait, sleep=_time.sleep,
    )
    threading.Lock = lock_factory
    threading.RLock = rlock_factory
    threading.Condition = condition_factory

    _TESTS_MARK = os.sep + "tests" + os.sep

    def _maybe_flag(op):
        stack = _held()
        if not stack or _permits():
            return
        # only juicefs/test CALL SITES count: stdlib-internal waits made
        # on our behalf (e.g. Thread.start's bounded startup handshake
        # inside a lane lock) are not the unbounded blocking this hunts
        caller = sys._getframe(2).f_code.co_filename
        if _JUICEFS_MARK not in caller and _TESTS_MARK not in caller:
            return
        _state.note_blocking(op, stack)

    def result(self, timeout=None, _orig=_Future.result):
        if not self.done():
            _maybe_flag("Future.result()")
        return _orig(self, timeout)

    def exception(self, timeout=None, _orig=_Future.exception):
        if not self.done():
            _maybe_flag("Future.exception()")
        return _orig(self, timeout)

    def q_get(self, block=True, timeout=None, _orig=_queue.Queue.get):
        if block and self.empty():
            _maybe_flag("Queue.get()")
        return _orig(self, block, timeout)

    def q_put(self, item, block=True, timeout=None, _orig=_queue.Queue.put):
        if block and self.full():
            _maybe_flag("Queue.put()")
        return _orig(self, item, block, timeout)

    def ev_wait(self, timeout=None, _orig=threading.Event.wait):
        if not self.is_set():
            _maybe_flag("Event.wait()")
        return _orig(self, timeout)

    def sleep(secs, _orig=_time.sleep):
        if secs > 0:
            _maybe_flag("time.sleep()")
        return _orig(secs)

    _Future.result = result
    _Future.exception = exception
    _queue.Queue.get = q_get
    _queue.Queue.put = q_put
    threading.Event.wait = ev_wait
    _time.sleep = sleep
    _installed = True
    return True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    import queue as _queue
    import time as _time
    from concurrent.futures import Future as _Future

    threading.Lock = _saved["lock"]
    threading.RLock = _saved["rlock"]
    threading.Condition = _saved["cond"]
    _Future.result = _saved["fut_result"]
    _Future.exception = _saved["fut_exception"]
    _queue.Queue.get = _saved["q_get"]
    _queue.Queue.put = _saved["q_put"]
    threading.Event.wait = _saved["ev_wait"]
    _time.sleep = _saved["sleep"]
    _installed = False
