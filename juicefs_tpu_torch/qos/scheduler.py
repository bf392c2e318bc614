"""Unified I/O scheduler (a copy of juicefs_tpu/qos/scheduler.py).

Without it the client would run several mutually-blind thread pools
(upload, download, slice-read, prefetch workers, the ingest finalizer's
uploads, and ad-hoc per-command pools), so a background `gc --dedup` scan
would compete head-to-head with a foreground training read.  This module
is the seam that replaces them: one shared
scheduler owns the worker threads and fronts every pool behind

    Scheduler.submit(lane, cls, fn, *args, tenant=..., weight=...)

with

  priority classes   strict priority FOREGROUND > {INGEST, PREFETCH} >
                     BACKGROUND across classes (the mid tier alternates),
                     with a starvation-proof floor: every `floor_every`-th
                     dispatch inverts the order, so saturating foreground
                     load can never starve background work entirely.
  fair queueing      deficit-round-robin across (class, tenant) queues:
                     tenants take turns weighted by their quantum, so one
                     uid flooding reads cannot monopolize a class.
  bounded queues     sheddable classes bound their backlog: PREFETCH
                     DROPS on a full queue (a warm-miss later is the
                     cheap outcome), INGEST/BACKGROUND apply submit-side
                     backpressure (the producer waits for space), and
                     FOREGROUND never sheds.
  foreground reserve a lane never devotes its last `bg_reserve` workers
                     to BACKGROUND work, so a foreground arrival finds a
                     worker without waiting out an in-flight bulk GET.

Lanes.  Workers are grouped into named lanes ("upload", "download",
"slice", "bulk") sized by the widest consumer.  Lanes exist for exactly
one reason: the nested submit-and-wait deadlock rule (docs/ARCHITECTURE
"Concurrency model") — a task must never wait on work queued behind it on
its own worker set.  The lane graph stays acyclic: slice -> download,
bulk -> download, never the reverse.  Priorities, fairness, shedding and
the bandwidth budget (qos/limiter.py) all apply across lanes.

Class inheritance.  A nested submit never escalates: work submitted from
inside a BACKGROUND task is demoted to BACKGROUND even through a
FOREGROUND-class executor, so compaction reads riding `RSlice.read` and
bulk-path prefetch hints classify correctly with zero call-site changes.
"""
from __future__ import annotations
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from enum import Enum
from typing import Callable, Optional
from ..metric import global_registry
from ..utils import get_logger
from . import context as qctx
logger = get_logger('qos.scheduler')
_reg = global_registry()
_SUBMITTED = _reg.counter('juicefs_qos_submitted', 'I/O tasks accepted by the unified scheduler', ('class',))
_COMPLETED = _reg.counter('juicefs_qos_completed', 'I/O tasks the unified scheduler finished', ('class',))
_SHED = _reg.counter('juicefs_qos_shed', 'Sheddable I/O tasks dropped on a full class queue (prefetch)', ('class',))
_WAIT = _reg.histogram('juicefs_qos_wait_seconds', 'Queue wait from submit to dispatch per priority class', ('class',))
_DEPTH = _reg.gauge('juicefs_qos_queue_depth', 'Tasks queued (not yet running) per class', ('class',))

class IOClass(Enum):
    """Priority classes.  Lower `priority` dispatches first."""
    FOREGROUND = ('foreground', 0)
    INGEST = ('ingest', 1)
    PREFETCH = ('prefetch', 1)
    BACKGROUND = ('background', 2)

    def __init__(self, label: str, priority: int):
        self.label = label
        self.priority = priority
DEFAULT_BOUNDS = {IOClass.FOREGROUND: None, IOClass.INGEST: 1024, IOClass.PREFETCH: 64, IOClass.BACKGROUND: 1024}
SHEDDABLE = frozenset({IOClass.PREFETCH})
_FLOOR_EVERY = 8
_DRR_QUANTUM = 4
_FG_RECENT_S = 30.0
_LIVE_SCHEDULERS: 'weakref.WeakSet[Scheduler]' = weakref.WeakSet()

def _depth_of(cls: IOClass) -> int:
    total = 0
    try:
        for s in list(_LIVE_SCHEDULERS):
            for lane in list(s._lanes.values()):
                total += lane.queues[cls].size
    except Exception:
        pass
    return total
for _cls in IOClass:
    _DEPTH.labels(_cls.label).set_function(lambda c=_cls: _depth_of(c))

class _Task:
    __slots__ = ('fn', 'args', 'kw', 'fut', 'cls', 'tenant', 'weight', 'cost', 'enq')

    def __init__(self, fn, args, kw, fut, cls, tenant, weight, cost):
        self.fn = fn
        self.args = args
        self.kw = kw
        self.fut = fut
        self.cls = cls
        self.tenant = tenant
        self.weight = weight
        self.cost = cost
        self.enq = time.perf_counter()

class _TenantQ:
    __slots__ = ('q', 'deficit', 'weight')

    def __init__(self, weight: int):
        self.q: deque[_Task] = deque()
        self.deficit = 0
        self.weight = weight

class _ClassQueue:
    """Deficit-round-robin fair queue across tenants of one class."""
    __slots__ = ('tenants', 'order', 'size')

    def __init__(self):
        self.tenants: dict = {}
        self.order: deque = deque()
        self.size = 0

    def push(self, task: _Task) -> None:
        tq = self.tenants.get(task.tenant)
        if tq is None:
            tq = _TenantQ(task.weight)
            self.tenants[task.tenant] = tq
            self.order.append(task.tenant)
        else:
            tq.weight = max(tq.weight, task.weight)
        tq.q.append(task)
        self.size += 1

    def pop(self) -> Optional[_Task]:
        while self.order:
            tenant = self.order[0]
            tq = self.tenants[tenant]
            if not tq.q:
                self.order.popleft()
                del self.tenants[tenant]
                continue
            if tq.deficit < tq.q[0].cost:
                tq.deficit += _DRR_QUANTUM * tq.weight
                self.order.rotate(-1)
                continue
            task = tq.q.popleft()
            tq.deficit -= task.cost
            self.size -= 1
            if not tq.q:
                self.order.popleft()
                del self.tenants[tenant]
            return task
        return None

class _Lane:
    """One named worker group; dispatch order within it is governed by
    class priority + DRR.  Width is the max concurrent I/O of the lane."""

    def __init__(self, sched: 'Scheduler', name: str, width: int):
        self.sched = sched
        self.name = name
        self.width = max(1, int(width))
        self.cond = threading.Condition()
        self.queues = {cls: _ClassQueue() for cls in IOClass}
        self.running = {cls: 0 for cls in IOClass}
        self.spawned = 0
        self.idle = 0
        self.queued = 0
        self.dispatches = 0
        self.fg_last = float('-inf')

    def _class_order(self) -> list:
        mid = [IOClass.INGEST, IOClass.PREFETCH] if self.dispatches % 2 else [IOClass.PREFETCH, IOClass.INGEST]
        order = [IOClass.FOREGROUND] + mid + [IOClass.BACKGROUND]
        if self.sched.floor_every and self.dispatches % self.sched.floor_every == 0:
            order.reverse()
        return order

    def _pick(self) -> Optional[_Task]:
        self.dispatches += 1
        if time.monotonic() - self.fg_last < _FG_RECENT_S:
            spec_limit = max(1, self.width - self.sched.bg_reserve)
        else:
            spec_limit = self.width
        spec_running = self.running[IOClass.BACKGROUND] + self.running[IOClass.PREFETCH]
        for cls in self._class_order():
            if cls in (IOClass.BACKGROUND, IOClass.PREFETCH) and spec_running >= spec_limit:
                continue
            task = self.queues[cls].pop()
            if task is not None:
                self.queued -= 1
                return task
        return None

    def _worker(self) -> None:
        while True:
            with self.cond:
                task = self._pick()
                while task is None:
                    if self.sched._closed:
                        return
                    self.idle += 1
                    self.cond.wait()
                    self.idle -= 1
                    if self.sched._closed:
                        return
                    task = self._pick()
                self.running[task.cls] += 1
                self.cond.notify_all()
            try:
                self._execute(task)
            finally:
                with self.cond:
                    self.running[task.cls] -= 1
                    self.cond.notify_all()

    def _execute(self, task: _Task) -> None:
        fut = task.fut
        if not fut.set_running_or_notify_cancel():
            return
        _WAIT.labels(task.cls.label).observe(time.perf_counter() - task.enq)
        with qctx.applied(qctx.QosContext(task.tenant, task.weight, task.cls)):
            try:
                fut.set_result(task.fn(*task.args, **task.kw))
            except BaseException as e:
                fut.set_exception(e)
        _COMPLETED.labels(task.cls.label).inc()
        with self.sched._stats_lock:
            self.sched._completed[task.cls] += 1

    def _spawn_locked(self) -> None:
        self.spawned += 1
        threading.Thread(target=self._worker, daemon=True, name=f'qos-{self.name}-{self.spawned}').start()

class Scheduler:
    """The shared scheduler.  One per process in production
    (`global_scheduler()`); tests may build private ones and `close()`
    them.  Workers are daemon threads spawned on demand up to each lane's
    width — an idle scheduler costs nothing."""

    def __init__(self, bounds: Optional[dict]=None, floor_every: int=_FLOOR_EVERY, bg_reserve: int=1, bound_wait: float=300.0):
        self.bounds = dict(DEFAULT_BOUNDS)
        if bounds:
            self.bounds.update(bounds)
        self.floor_every = max(0, int(floor_every))
        self.bg_reserve = max(0, int(bg_reserve))
        self.bound_wait = bound_wait
        self._lanes: dict[str, _Lane] = {}
        self._lanes_lock = threading.Lock()
        self._closed = False
        # per-instance counters mirroring the process-global metrics:
        # snapshot() must attribute work to THIS scheduler (two stores on
        # private schedulers must not see each other's counts in .status)
        self._stats_lock = threading.Lock()
        self._submitted = {cls: 0 for cls in IOClass}
        self._completed = {cls: 0 for cls in IOClass}
        self._shed = {cls: 0 for cls in IOClass}
        _LIVE_SCHEDULERS.add(self)

    def lane(self, name: str, width: int=1) -> _Lane:
        """Get-or-create a lane, widening it to at least `width`."""
        with self._lanes_lock:
            ln = self._lanes.get(name)
            if ln is None:
                ln = _Lane(self, name, width)
                self._lanes[name] = ln
        self.widen(name, width)
        return ln

    def widen(self, name: str, width: int) -> None:
        """Raise a lane's worker ceiling (never narrows: a shared lane's
        width is the widest consumer's ask)."""
        ln = self._lanes.get(name)
        if ln is None:
            self.lane(name, width)
            return
        with ln.cond:
            if width > ln.width:
                ln.width = max(1, int(width))
                ln.cond.notify_all()

    def submit(self, lane: str, cls: IOClass, fn: Callable, *args, tenant=None, weight: Optional[int]=None, cost: int=1, nowait: bool=False, **kw) -> Optional[Future]:
        """Queue `fn(*args, **kw)` at `cls` priority on `lane`.

        Returns a Future, or None when the class is sheddable and its
        queue is full (the task was dropped and counted).  INGEST and
        BACKGROUND submits block for queue space (backpressure);
        FOREGROUND is unbounded and never waits.  `nowait=True` turns
        the backpressure wait into an immediate TimeoutError — for
        callers with their own serial fallback (the compression plane's
        lane fan-out) that must degrade rather than park.

        tenant/weight default to the ambient QoS context (qos/context.py);
        the effective class never escalates above the ambient class.
        """
        requested = cls
        amb = qctx.current()
        if amb is not None:
            if tenant is None:
                tenant = amb.tenant
            if weight is None:
                weight = amb.weight
            if amb.cls is not None and amb.cls.priority > cls.priority:
                cls = amb.cls
        if tenant is None:
            tenant = qctx.DEFAULT_TENANT
        weight = max(1, int(weight or 1))
        ln = self._lanes.get(lane)
        if ln is None:
            ln = self.lane(lane)
        fut: Future = Future()
        task = _Task(fn, args, kw, fut, cls, tenant, weight, max(1, cost))
        bound = self.bounds.get(cls)
        with ln.cond:
            if self._closed:
                raise RuntimeError('scheduler is closed')
            q = ln.queues[cls]
            if bound is not None and q.size >= bound:
                # shedability follows the REQUESTED class: a prefetch
                # demoted to BACKGROUND (ambient inheritance) must still
                # drop on a full queue — speculative work never turns
                # into submit-side backpressure on the thread that asked
                if cls in SHEDDABLE or requested in SHEDDABLE:
                    _SHED.labels(requested.label).inc()
                    with self._stats_lock:
                        self._shed[requested] += 1
                    return None
                if nowait:
                    raise TimeoutError(
                        f'qos: {cls.label} queue on lane {lane!r} full '
                        '(nowait submit)')
                deadline = time.monotonic() + self.bound_wait
                while q.size >= bound:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise TimeoutError(f'qos: {cls.label} queue on lane {lane!r} full for {self.bound_wait:.0f}s')
                    ln.cond.wait(min(left, 1.0))
                    if self._closed:
                        raise RuntimeError('scheduler is closed')
            q.push(task)
            ln.queued += 1
            if cls is IOClass.FOREGROUND:
                ln.fg_last = time.monotonic()
            _SUBMITTED.labels(cls.label).inc()
            with self._stats_lock:
                self._submitted[cls] += 1
            if ln.spawned < ln.width and ln.queued > ln.idle:
                ln._spawn_locked()
            if ln.idle > 0:
                ln.cond.notify_all()
        return fut

    def executor(self, lane: str, cls: IOClass, width: Optional[int]=None, tenant=None) -> 'ClassExecutor':
        """An executor-shaped handle bound to (lane, class): drop-in for
        the ThreadPoolExecutors it replaces.  `width` widens the lane."""
        if width:
            self.lane(lane, width)
        else:
            self.lane(lane, 1)
        return ClassExecutor(self, lane, cls, tenant=tenant)

    def close(self) -> None:
        """Stop the workers (tests; the process-global scheduler lives for
        the process — its workers are daemons)."""
        self._closed = True
        for ln in list(self._lanes.values()):
            with ln.cond:
                ln.cond.notify_all()

    def snapshot(self) -> dict:
        """Live state for `.status` / `juicefs status`."""
        lanes = {}
        for (name, ln) in list(self._lanes.items()):
            with ln.cond:
                lanes[name] = {'width': ln.width, 'workers': ln.spawned, 'idle': ln.idle, 'queued': {cls.label: ln.queues[cls].size for cls in IOClass if ln.queues[cls].size}, 'running': {cls.label: n for (cls, n) in ln.running.items() if n}}
        classes = {}
        with self._stats_lock:
            for cls in IOClass:
                entry = {'submitted': self._submitted[cls], 'completed': self._completed[cls]}
                shed = self._shed[cls]
                if shed:
                    entry['shed'] = shed
                classes[cls.label] = entry
        return {'lanes': lanes, 'classes': classes, 'floor_every': self.floor_every, 'bg_reserve': self.bg_reserve}

class ClassExecutor:
    """Executor facade over one (lane, class) of a shared scheduler.

    Owns only its own submissions: `shutdown()` drains (or cancels) the
    futures THIS executor created and refuses new ones — it never stops
    scheduler workers other consumers share.  That is the store-shutdown
    contract: `CachedStore.close()` drains its own
    work while another store on the same scheduler keeps running.
    """

    def __init__(self, sched: Scheduler, lane: str, cls: IOClass, tenant=None):
        self._sched = sched
        self.lane = lane
        self.cls = cls
        self.tenant = tenant
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._outstanding: set[Future] = set()
        self._inflight_submits = 0
        self._closed = False

    def submit(self, fn: Callable, *args, **kw) -> Optional[Future]:
        """Future, or None when a sheddable class dropped the task."""
        with self._lock:
            if self._closed:
                raise RuntimeError('cannot schedule new futures after shutdown')
            self._inflight_submits += 1
        fut = None
        try:
            fut = self._sched.submit(self.lane, self.cls, fn, *args, tenant=self.tenant, **kw)
        finally:
            with self._lock:
                self._inflight_submits -= 1
                if fut is not None:
                    self._outstanding.add(fut)
                self._cond.notify_all()
        if fut is not None:
            fut.add_done_callback(self._done)
        return fut

    def _done(self, fut: Future) -> None:
        with self._lock:
            self._outstanding.discard(fut)

    def map(self, fn: Callable, *iterables):
        """ThreadPoolExecutor.map-alike (submit all, yield in order) for
        the bulk command call sites (sync/objbench/gc)."""
        futs = [self.submit(fn, *args) for args in zip(*iterables)]

        def results():
            for f in futs:
                if f is not None:
                    yield f.result()
        return results()

    def shutdown(self, wait: bool=True, cancel_futures: bool=False, timeout: Optional[float]=None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            self._closed = True
            while self._inflight_submits > 0:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    break
                self._cond.wait(1.0 if left is None else min(left, 1.0))
            pending = list(self._outstanding)
        if cancel_futures:
            for f in pending:
                f.cancel()
        if wait:
            from concurrent.futures import wait as _fwait
            with self._lock:
                pending = list(self._outstanding)
            if pending:
                _fwait(pending, timeout=timeout)

    def __enter__(self) -> 'ClassExecutor':
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=True)
_global_lock = threading.Lock()
_global: Optional[Scheduler] = None

def global_scheduler() -> Scheduler:
    """The process-wide scheduler every store/command shares."""
    global _global
    with _global_lock:
        if _global is None or _global._closed:
            _global = Scheduler()
        return _global

def maybe_global_scheduler() -> Optional[Scheduler]:
    """The global scheduler if one exists (status paths must not create
    worker state as a side effect of being read)."""
    return _global