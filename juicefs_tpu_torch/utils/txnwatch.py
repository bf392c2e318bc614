"""Runtime txn rerun-purity harness (a copy of
juicefs_tpu/utils/txnwatch.py): the dynamic complement
to ``tools/analyze``'s ``txn-purity`` static pass, the way lockwatch is
the dynamic complement of the lock-order passes.

Opt-in via ``JUICEFS_TXN_RERUN=1`` + :func:`install`; importing the
module installs nothing, and the port's meta tests install it for their
module.  Every engine transaction seam (``tkv_client.MemKV/SqliteKV``,
``redis_kv.RedisKV``, ``sql.SQLMeta._txn/_rtxn``) routes its closure
through
:func:`double_run`, which executes every SUCCESSFUL closure TWICE with
the first run's engine-side writes discarded (buffered-write engines
simply drop the buffer; sqlite engines roll back to a savepoint), then
asserts the two runs are byte-identical:

* the ordered write set (buffered KV writes, recorded ``set``/``delete``
  calls, recorded mutating SQL statements) must match exactly;
* the returned result must be structurally equal
  (:func:`canon` — bytes-normalized, address-free);
* a discard/abort decision must reproduce.

Any divergence is a NON-IDEMPOTENT closure: exactly the double-apply
bug that optimistic conflict retry (redis WATCH, sqlite BUSY) triggers
in production, surfaced deterministically on every test run.  Clock
nondeterminism is removed instead of tolerated: while a doubled run is
in flight, ``time.time``/``time.monotonic`` are patched (refcounted, so
ambient code pays nothing when no txn is doubling) and the second run
REPLAYS the first run's readings (thread-local; other threads always
see the real clock) — a closure stamping ``mtime`` is rerun-safe, a
closure appending to a captured list is caught.

Engines that serialize their transactions (MemKV's lock, sqlite's write
mutex, sqlite snapshot reads) compare strictly.  Redis transactions can
race a concurrent writer between the two runs, so their ``run_once``
also returns the READ SET (the WATCH+GET cache plus a scan log): the
purity contract is *writes are a deterministic function of reads*, so a
divergent write set only counts as a violation when the two runs read
identical state — a contended counter bump whose reruns see different
bases is the conflict machinery's business (WATCH aborts the stale
EXEC), not a purity bug.

Violations accumulate in a process-global state for a test fixture to
check.  Drills use :func:`scoped_state`.
"""

from __future__ import annotations

import os
import re
import threading
import _thread

_REAL_TIME = __import__("time").time
_REAL_MONO = __import__("time").monotonic

_tls = threading.local()

_MUTATING_SQL = ("INSERT", "UPDATE", "DELETE", "REPLACE", "CREATE", "DROP")


def enabled() -> bool:
    return os.environ.get("JUICEFS_TXN_RERUN", "") not in ("", "0")


# ---------------------------------------------------------------------------
# state (mirrors lockwatch.State)

class State:
    def __init__(self):
        self._mu = _thread.allocate_lock()
        self.violations: list[dict] = []
        self.doubled = 0          # closures actually executed twice

    def note(self, engine: str, closure, detail: str) -> None:
        with self._mu:
            self.violations.append({
                "kind": "txn-rerun",
                "engine": engine,
                "closure": _closure_site(closure),
                "detail": detail,
                "thread": threading.current_thread().name,
            })

    def snapshot(self) -> list[dict]:
        with self._mu:
            return list(self.violations)

    def reset(self) -> None:
        with self._mu:
            self.violations.clear()
            self.doubled = 0


_state = State()


def state() -> State:
    return _state


def violations() -> list[dict]:
    return _state.snapshot()


def reset() -> None:
    _state.reset()


class scoped_state:
    """Fresh State for a drill; restores the old one on exit."""

    def __enter__(self) -> State:
        global _state
        self._saved = _state
        _state = State()
        return _state

    def __exit__(self, *exc) -> None:
        global _state
        _state = self._saved


def _closure_site(fn) -> str:
    code = getattr(fn, "__code__", None)
    if code is None:
        return getattr(fn, "__qualname__", repr(fn))
    name = getattr(fn, "__qualname__", code.co_name)
    short = os.path.basename(code.co_filename)
    return f"{name} ({short}:{code.co_firstlineno})"


# ---------------------------------------------------------------------------
# deterministic clock: record on run 1, replay on run 2

class _Clock:
    __slots__ = ("mode", "values", "idx")

    def __init__(self, mode: str, values=None):
        self.mode = mode            # "record" | "replay"
        self.values = values if values is not None else {"t": [], "m": []}
        self.idx = {"t": 0, "m": 0}

    def tick(self, kind: str, real) -> float:
        if self.mode == "record":
            v = real()
            self.values[kind].append(v)
            return v
        vs = self.values[kind]
        i = self.idx[kind]
        if i < len(vs):
            self.idx[kind] = i + 1
            return vs[i]
        # the rerun read the clock MORE times than the first run did —
        # already a divergence the write/result compare will surface;
        # keep time monotone-ish by holding the last reading
        return vs[-1] if vs else real()


def _patched_time():
    c = getattr(_tls, "clock", None)
    return _REAL_TIME() if c is None else c.tick("t", _REAL_TIME)


def _patched_monotonic():
    c = getattr(_tls, "clock", None)
    return _REAL_MONO() if c is None else c.tick("m", _REAL_MONO)


# The clock is patched ONLY while a doubled run is in flight (refcounted
# across threads): a permanently-installed wrapper taxes every
# time.time() on the hot read path (the tracer-overhead budget measured
# it), whereas two module setattrs per doubled txn are noise.  Other
# threads hitting the wrapper mid-scope have no thread-local recorder
# and fall through to the real clock.
_patch_mu = _thread.allocate_lock()
_patch_depth = 0


def _patch_clock() -> None:
    global _patch_depth
    import time as _time

    with _patch_mu:
        _patch_depth += 1
        if _patch_depth == 1:
            _time.time = _patched_time
            _time.monotonic = _patched_monotonic


def _unpatch_clock() -> None:
    global _patch_depth
    import time as _time

    with _patch_mu:
        _patch_depth -= 1
        if _patch_depth == 0:
            _time.time = _REAL_TIME
            _time.monotonic = _REAL_MONO


class _clock_scope:
    def __init__(self, mode: str, values=None):
        self._clock = _Clock(mode, values)

    def __enter__(self) -> _Clock:
        self._saved = getattr(_tls, "clock", None)
        _tls.clock = self._clock
        _patch_clock()
        return self._clock

    def __exit__(self, *exc) -> None:
        _tls.clock = self._saved
        _unpatch_clock()


_installed = False


def install() -> bool:
    """Arm the harness (the clock sources are patched per doubled run,
    not globally — ambient code pays nothing).  Idempotent; no-op
    (returns False) while JUICEFS_TXN_RERUN is unset."""
    global _installed
    if _installed or not enabled():
        return _installed
    _installed = True
    return True


def uninstall() -> None:
    global _installed
    _installed = False


def active() -> bool:
    return _installed and enabled()


# ---------------------------------------------------------------------------
# structural equality (address-free, bytes-normalized)

_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


def canon(v, depth: int = 0):
    """Canonical comparable form of a closure result / write value."""
    if depth > 8:
        return _ADDR_RE.sub("0x", repr(v))[:200]
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return tuple(canon(x, depth + 1) for x in v)
    if isinstance(v, (set, frozenset)):
        return frozenset(canon(x, depth + 1) for x in v)
    if isinstance(v, dict):
        return tuple(sorted(
            ((canon(k, depth + 1), canon(x, depth + 1)) for k, x in v.items()),
            key=repr))
    d = getattr(v, "__dict__", None)
    if d is not None:
        return (type(v).__name__,) + tuple(
            sorted((k, canon(x, depth + 1)) for k, x in d.items()))
    return _ADDR_RE.sub("0x", repr(v))[:200]


def _diff(r1, w1, d1, r2, w2, d2) -> str:
    parts = []
    if d1 != d2:
        parts.append(f"discard decision diverged ({d1} vs {d2})")
    if canon(w1) != canon(w2):
        parts.append(
            f"write set diverged (run1={_summ(w1)} run2={_summ(w2)})")
    if canon(r1) != canon(r2):
        parts.append(
            f"result diverged (run1={_summ(r1)} run2={_summ(r2)})")
    return "; ".join(parts)


def _summ(v) -> str:
    return _ADDR_RE.sub("0x", repr(v))[:160]


# ---------------------------------------------------------------------------
# the seam: engines call this with their one-attempt runner

def double_run(engine: str, fn, run_once, reset=None):
    """Run ``run_once() -> (result, writes, discarded[, reads])`` once;
    while the harness is active and the attempt did not discard, discard
    its engine-side effects via ``reset()`` (None for buffered-write
    engines) and run it again under the replayed clock, comparing the
    two runs.  Returns the LAST run's (result, writes, discarded) — for
    direct-write engines that is the run whose effects are live.

    The optional 4th element is the attempt's READ SET, supplied by
    engines whose reads can race concurrent writers (redis): when the
    two runs observed DIFFERENT state, a divergent output is the
    concurrent writer's doing (the engine's conflict machinery owns that
    case) and is not flagged — the contract is writes-as-a-function-of-
    reads, not writes-frozen-in-time."""
    if not active():
        return run_once()[:3]
    with _clock_scope("record") as clk:
        out1 = run_once()
    r1, w1, d1 = out1[:3]
    reads1 = out1[3] if len(out1) > 3 else None
    if d1:
        return r1, w1, d1
    if reset is not None:
        reset()
    try:
        with _clock_scope("replay", clk.values):
            out2 = run_once()
    except BaseException as e:
        # Only serialized engines (no read set) flag a rerun-raise as a
        # violation: on a reads-bearing engine a concurrent writer can
        # legitimately change what the rerun observes (same exemption as
        # the compare path), and an engine-retryable error (sqlite BUSY)
        # is the caller's backoff loop's business, not impurity.
        import sqlite3
        if reads1 is None and not isinstance(e, sqlite3.OperationalError):
            _state.note(engine, fn,
                        f"rerun raised {type(e).__name__}: {e} (first "
                        "run succeeded) — closure consumes state it "
                        "does not reset")
        raise
    r2, w2, d2 = out2[:3]
    reads2 = out2[3] if len(out2) > 3 else None
    with _state._mu:
        _state.doubled += 1
    detail = _diff(r1, w1, d1, r2, w2, d2)
    if detail and (reads1 is None or canon(reads1) == canon(reads2)):
        _state.note(engine, fn, detail)
    return r2, w2, d2


# ---------------------------------------------------------------------------
# SQL cursor recorder (meta/sql.py): the write set of a relational txn
# is the ordered stream of mutating statements it issued

class RecordingCursor:
    """Cursor proxy logging mutating statements; everything else
    delegates.  ``execute`` returns the proxy so chained ``.fetchone()``
    and ``for row in cur.execute(...)`` keep working."""

    def __init__(self, cur):
        self._cur = cur
        self.log: list = []

    @staticmethod
    def _mutating(sql: str) -> bool:
        head = sql.lstrip().split(None, 1)
        return bool(head) and head[0].upper() in _MUTATING_SQL

    def execute(self, sql, params=()):
        if self._mutating(sql):
            self.log.append((sql, canon(tuple(params))))
        self._cur.execute(sql, params)
        return self

    def executemany(self, sql, seq):
        seq = list(seq)  # materialize: recorded AND executed once
        if self._mutating(sql):
            self.log.append((sql, canon(tuple(tuple(p) for p in seq))))
        self._cur.executemany(sql, seq)
        return self

    def __iter__(self):
        return iter(self._cur)

    def __getattr__(self, name):
        return getattr(self._cur, name)
