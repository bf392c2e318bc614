"""The sqlite meta engine's write transactions from inside.

`SqliteKV.txn` times each attempt in three stages, spans of the port's
tracer that feed the rollup `juicefs_torch_stage_seconds`: `meta.txn.lock_wait`
(until BEGIN IMMEDIATE has returned), `meta.txn.run` (the closure) and
`meta.txn.commit` (the COMMIT, or the ROLLBACK of a closure that raised or
discarded). A nested transaction joins the outer one and times nothing;
each retry counts in `juicefs_transaction_restart`. Under a torch
profiler each stage is a range on the calling thread.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from juicefs_tpu_torch.meta import tkv_client
from juicefs_tpu_torch.meta.tkv_client import SqliteKV
from juicefs_tpu_torch.metric import global_registry
from juicefs_tpu_torch.metric.trace import global_tracer, stage_hist, stage_metrics_snapshot
from juicefs_tpu_torch.utils import txnwatch

STAGES = ("meta.txn.lock_wait", "meta.txn.run", "meta.txn.commit")


@pytest.fixture
def kv(tmp_path):
    kv = SqliteKV(str(tmp_path / "kv.db"))
    yield kv
    kv.close()


class _Seen:
    """A stage histogram the engine bound, wrapped to note which thread
    observed what, so that the transactions of other threads (a session's
    heartbeat that another test left running) are told apart."""

    def __init__(self, hist, stage, seen):
        self.hist, self.stage, self.seen = hist, stage, seen

    def observe(self, v):
        self.seen.append((threading.get_ident(), self.stage, v))
        self.hist.observe(v)


@pytest.fixture
def seen(monkeypatch):
    """[(thread, stage, seconds)] of every stage observed in the test."""
    out = []
    for stage, hist in list(tkv_client._TXN_STAGES.items()):
        monkeypatch.setitem(tkv_client._TXN_STAGES, stage, _Seen(hist, stage, out))
    return out


def _snapshot(seen: list) -> tuple[dict, int]:
    """The rollup's count of each stage, and how many observations
    `seen` holds."""
    snap = stage_metrics_snapshot()
    zero = {"count": 0, "sum_seconds": 0.0}
    return {s: snap.get(s, zero)["count"] for s in STAGES}, len(seen)


def _moved(before: tuple[dict, int], seen: list) -> dict:
    """{stage: the rollup's count moved since `before`}, less what other
    threads observed meanwhile."""
    counts, mark = before
    after, _ = _snapshot(seen)
    me = threading.get_ident()
    return {s: after[s] - counts[s]
            - sum(1 for t, st, _ in seen[mark:] if t != me and f"meta.txn.{st}" == s)
            for s in STAGES}


def _restarts() -> float:
    return global_registry()._metrics["juicefs_transaction_restart"].value


def test_one_write_txn_observes_each_stage_once(kv, seen):
    before = _snapshot(seen)
    kv.txn(lambda tx: tx.set(b"k", b"v"))
    assert _moved(before, seen) == {s: 1 for s in STAGES}
    assert kv.txn(lambda tx: tx.get(b"k")) == b"v"


def test_a_nested_txn_adds_nothing(kv, seen):
    def outer(tx):
        tx.set(b"a", b"1")
        inner = _snapshot(seen)
        kv.txn(lambda t: t.set(b"b", b"2"))  # joins the open transaction
        assert _moved(inner, seen) == {s: 0 for s in STAGES}

    before = _snapshot(seen)
    kv.txn(outer)
    assert _moved(before, seen) == {s: 1 for s in STAGES}
    assert kv.txn(lambda tx: tx.gets(b"a", b"b")) == [b"1", b"2"]


def test_a_doubled_closure_is_one_run(kv, seen, monkeypatch):
    """Under the txn-rerun harness the closure runs twice inside one
    attempt: still one observation of each stage."""
    monkeypatch.setenv("JUICEFS_TXN_RERUN", "1")
    assert txnwatch.install()
    runs = []
    try:
        before = _snapshot(seen)
        violations = len(txnwatch.violations())
        kv.txn(lambda tx: (runs.append(1), tx.set(b"k", b"v"))[-1])
        assert len(runs) == 2
        assert _moved(before, seen) == {s: 1 for s in STAGES}
        assert len(txnwatch.violations()) == violations
    finally:
        txnwatch.uninstall()
    assert kv.txn(lambda tx: tx.get(b"k")) == b"v"


def test_a_discarded_txn_times_its_rollback_as_commit(kv, seen):
    def discard(tx):
        tx.set(b"gone", b"1")
        tx.discard()

    before = _snapshot(seen)
    kv.txn(discard)
    assert _moved(before, seen) == {s: 1 for s in STAGES}
    assert kv.txn(lambda tx: tx.get(b"gone")) is None


def test_a_closure_that_raises_still_closes_run_and_commit(kv, seen):
    def boom(tx):
        tx.set(b"half", b"1")
        raise ValueError("the closure failed")

    before = _snapshot(seen)
    restarts = _restarts()
    with pytest.raises(ValueError, match="the closure failed"):
        kv.txn(boom)
    assert _moved(before, seen) == {s: 1 for s in STAGES}
    assert _restarts() == restarts  # not retried
    assert not kv.in_txn()
    assert kv.txn(lambda tx: tx.get(b"half")) is None  # rolled back


def test_a_failed_begin_is_a_second_lock_wait_and_a_restart(kv, seen, monkeypatch):
    """The first BEGIN IMMEDIATE fails as a busy database would: that
    attempt observes `lock_wait` alone, the second all three stages, and
    the retry counts once. The statements are those of an uninstrumented
    txn: the failed BEGIN, its ROLLBACK (which fails: nothing is open), then
    the second attempt's BEGIN, the closure's statement and COMMIT."""
    conn = kv._get_conn()
    statements = []
    failed = []

    class Conn:
        def execute(self, sql, *args):
            statements.append(sql.split()[0])
            if sql == "BEGIN IMMEDIATE" and not failed:
                failed.append(sql)
                raise sqlite3.OperationalError("database is locked")
            return conn.execute(sql, *args)

    monkeypatch.setattr(kv, "_get_conn", Conn)
    monkeypatch.setattr(tkv_client.time, "sleep", lambda s: None)
    before = _snapshot(seen)
    restarts = _restarts()
    kv.txn(lambda tx: tx.set(b"k", b"v"))
    assert _moved(before, seen) == {"meta.txn.lock_wait": 2, "meta.txn.run": 1,
                              "meta.txn.commit": 1}
    assert _restarts() - restarts == 1
    assert statements == ["BEGIN", "ROLLBACK", "BEGIN", "INSERT", "COMMIT"]
    monkeypatch.undo()
    assert kv.txn(lambda tx: tx.get(b"k")) == b"v"


def test_a_failed_snapshot_txn_counts_a_restart(kv, seen, monkeypatch):
    """`simple_txn` takes no write lock and times no stage; a BEGIN that
    fails is retried and counts as a restart."""
    conn = kv._get_conn()
    failed = []

    class Conn:
        total_changes = property(lambda self: conn.total_changes)

        def execute(self, sql, *args):
            if sql == "BEGIN" and not failed:
                failed.append(sql)
                raise sqlite3.OperationalError("database is locked")
            return conn.execute(sql, *args)

    kv.txn(lambda tx: tx.set(b"k", b"v"))
    monkeypatch.setattr(kv, "_get_conn", Conn)
    monkeypatch.setattr(tkv_client.time, "sleep", lambda s: None)
    before = _snapshot(seen)
    restarts = _restarts()
    assert kv.simple_txn(lambda tx: tx.get(b"k")) == b"v"
    assert _restarts() - restarts == 1
    assert _moved(before, seen) == {s: 0 for s in STAGES}


def test_a_writer_holding_the_lock_shows_as_lock_wait(kv, seen):
    """A second thread holds a write txn open for 50 ms; the first thread's
    txn, started meanwhile, waits at least 40 ms in `lock_wait` (a lower
    bound only)."""
    inside, done = threading.Event(), threading.Event()

    def hold(tx):
        tx.set(b"held", b"1")
        inside.set()
        time.sleep(0.05)

    def holder():
        try:
            kv.txn(hold)
        finally:
            kv.close()  # this thread's connection
            done.set()

    t = threading.Thread(target=holder)
    t.start()
    assert inside.wait(10)
    before = _snapshot(seen)
    kv.txn(lambda tx: tx.set(b"after", b"1"))
    t.join(10)
    assert not t.is_alive() and done.is_set()
    me = threading.get_ident()
    waits = [v for th, st, v in seen if th == me and st == "lock_wait"]
    assert len(waits) == 1 and waits[0] >= 0.04
    # the holder's lock_wait was observed before its closure ran, its run
    # and commit after
    assert _moved(before, seen) == {s: 1 for s in STAGES}
    assert sum(1 for th, st, _ in seen if th == t.ident) == 3


def test_stages_are_profiler_ranges_on_the_calling_thread(kv, tmp_path):
    kv.txn(lambda tx: tx.set(b"warm", b"1"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with global_tracer().span("test", "meta", stage="caller",
                                  hist=stage_hist("test", "meta", "caller")):
            kv.txn(lambda tx: tx.set(b"k", b"v"))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text()).get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    (caller,) = by_name["test.meta.caller"]
    ranges = []
    for name in STAGES:
        (e,) = by_name[name]
        assert e["tid"] == caller["tid"]
        assert caller["ts"] <= e["ts"] and e["ts"] + e["dur"] <= caller["ts"] + caller["dur"]
        ranges.append(e)
    # in order, none inside another
    for a, b in zip(ranges, ranges[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
