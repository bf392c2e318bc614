"""The port's qos and object-resilience copies (juicefs_tpu_torch/qos,
juicefs_tpu_torch/object/resilient.py) held to a selection of the JAX
package's own drills (tests/test_qos.py, tests/test_resilient.py).

Each case runs once per package (`pkg` = ref | port): both packages keep
their own registry, scheduler and breaker state, so every counter is read
through the registry of the package under test.
"""

import importlib
import threading
import time
import types

import pytest

import juicefs_tpu.metric as ref_metric
import juicefs_tpu.object.interface as ref_interface
import juicefs_tpu.object.mem as ref_mem
import juicefs_tpu.qos as ref_qos
import juicefs_tpu_torch.metric as port_metric
import juicefs_tpu_torch.object.interface as port_interface
import juicefs_tpu_torch.object.mem as port_mem
import juicefs_tpu_torch.qos as port_qos

# the reference's object package exports a `resilient()` function that
# shadows its submodule of the same name
ref_resilient = importlib.import_module("juicefs_tpu.object.resilient")
port_resilient = importlib.import_module("juicefs_tpu_torch.object.resilient")

PACKAGES = {
    "ref": types.SimpleNamespace(qos=ref_qos, res=ref_resilient, iface=ref_interface,
                                 reg=ref_metric.global_registry(), Mem=ref_mem.MemStorage),
    "port": types.SimpleNamespace(qos=port_qos, res=port_resilient, iface=port_interface,
                                  reg=port_metric.global_registry(), Mem=port_mem.MemStorage),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _counter(p, name, *labels):
    m = p.reg._metrics[name]
    return m.labels(*labels) if labels else m


class CountingMem:
    """Inner store counting every backend call."""

    def __init__(self, mem_cls):
        self._s = mem_cls()
        self.calls = 0
        self._mu = threading.Lock()

    def _count(self):
        with self._mu:
            self.calls += 1

    def string(self):
        return "mem://counting"

    def get(self, key, off=0, limit=-1):
        self._count()
        return self._s.get(key, off, limit)

    def put(self, key, data):
        self._count()
        self._s.put(key, data)

    def delete(self, key):
        self._count()
        self._s.delete(key)

    def head(self, key):
        self._count()
        return self._s.head(key)

    def list_all(self, prefix="", marker=""):
        self._count()
        return self._s.list_all(prefix, marker)


# -- qos ---------------------------------------------------------------------

def test_executor_class_priority(pkg):
    """Queued FOREGROUND runs before INGEST before BACKGROUND on one lane."""
    q = pkg.qos
    s = q.Scheduler(floor_every=0)
    try:
        gate = threading.Event()
        order = []
        s.submit("x", q.IOClass.FOREGROUND, gate.wait, 5)  # occupy the worker
        time.sleep(0.05)
        bg = s.executor("x", q.IOClass.BACKGROUND)
        ing = s.executor("x", q.IOClass.INGEST)
        fg = s.executor("x", q.IOClass.FOREGROUND)
        futs = [bg.submit(order.append, "bg"), ing.submit(order.append, "in"),
                fg.submit(order.append, "fg")]
        gate.set()
        for f in futs:
            f.result(5)
        assert order == ["fg", "in", "bg"]
        for ex in (bg, ing, fg):
            ex.shutdown(wait=True)
    finally:
        s.close()


def test_token_bucket_contract(pkg):
    tb_cls = pkg.qos.TokenBucket
    assert tb_cls(1e6).burst == 1 << 20
    assert tb_cls(80e6).burst == pytest.approx(10e6)
    with pytest.raises(ValueError):
        tb_cls(0)
    tb = tb_cls(100.0, burst=10)
    tb.charge(60)  # ~0.5 s of debt at 100 B/s
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        tb.gate(timeout=0.05)
    assert time.monotonic() - t0 < 0.4


def test_limiter_tokens(pkg):
    lim_cls = pkg.qos.Limiter
    lim = lim_cls(upload_bps=0.0, download_bps=-1.0)
    assert not lim.enabled(lim_cls.UPLOAD) and not lim.enabled(lim_cls.DOWNLOAD)
    assert lim.gate(lim_cls.DOWNLOAD) == 0.0
    lim = lim_cls(download_bps=1e9, burst=1e9)
    before = _counter(pkg, "juicefs_qos_throttled_bytes", "download").value
    lim.charge(lim_cls.DOWNLOAD, 4096, waited=0.0)
    assert _counter(pkg, "juicefs_qos_throttled_bytes", "download").value == before


# -- resilience --------------------------------------------------------------

def test_retry_classification(pkg):
    r, i = pkg.res, pkg.iface
    assert r.classify(i.NotFoundError("k")) is r.ErrorClass.PERMANENT
    assert r.classify(i.PermanentError("denied")) is r.ErrorClass.PERMANENT
    assert r.classify(i.ThrottleError("slow down")) is r.ErrorClass.THROTTLE
    assert r.classify(IOError("conn reset")) is r.ErrorClass.TRANSIENT
    e = IOError("rejected")
    for status, cls in ((403, "PERMANENT"), (429, "THROTTLE"), (503, "THROTTLE"),
                        (500, "TRANSIENT"), (408, "TRANSIENT")):
        e.status = status
        assert r.classify(e) is getattr(r.ErrorClass, cls), status
    p = r.RetryPolicy(jitter=0.0)
    for attempt in range(6):
        assert (p.backoff(attempt, r.ErrorClass.THROTTLE)
                > p.backoff(attempt, r.ErrorClass.TRANSIENT))


def test_transient_retried_permanent_not(pkg):
    r = pkg.res
    inner = CountingMem(pkg.Mem)
    inner._s.put("k", b"v")
    fails = {"n": 2}
    real_get = inner.get

    def flaky(key, off=0, limit=-1):
        if fails["n"] > 0:
            fails["n"] -= 1
            inner._count()
            raise IOError("transient blip")
        return real_get(key, off, limit)

    inner.get = flaky
    t0 = _counter(pkg, "juicefs_object_retries_by_class", "transient").value
    rs = r.resilient(inner, policy=r.RetryPolicy(max_attempts=8, base=0.001, jitter=0.0),
                     hedge=False)
    try:
        assert rs.get("k") == b"v"
        assert _counter(pkg, "juicefs_object_retries_by_class",
                        "transient").value == t0 + 2
        calls = inner.calls
        with pytest.raises(pkg.iface.NotFoundError):
            rs.get("missing")
        assert inner.calls == calls + 1  # exactly one attempt
    finally:
        rs.close()


def test_breaker_open_half_open_reset_with_on_reset(pkg):
    r = pkg.res
    inner = CountingMem(pkg.Mem)
    inner._s.put("k", b"v")
    br = r.CircuitBreaker(backend=f"torch-trip-{id(pkg)}", threshold=0.5,
                          min_samples=4, probe_interval=0.05)
    resets = []
    br.on_reset(lambda: resets.append(1))
    down = {"down": True}
    real_get, real_head = inner.get, inner.head

    def flappy(key, off=0, limit=-1):
        if down["down"]:
            inner._count()
            raise IOError("backend down")
        return real_get(key, off, limit)

    def flappy_head(key):
        # the half-open probe HEADs the backend: while it is down the probe
        # fails too, so the breaker stays OPEN however long the asserts
        # below are delayed (the probe is not the call under test: uncounted)
        if down["down"]:
            raise IOError("backend down")
        return real_head(key)

    inner.get = flappy
    inner.head = flappy_head
    rs = r.resilient(inner, policy=r.RetryPolicy(max_attempts=2, base=0.001, jitter=0.0),
                     breaker=br, hedge=False)
    try:
        for _ in range(3):
            with pytest.raises(IOError):
                rs.get("k")
        assert br.state == r.BreakerState.OPEN and rs.degraded
        calls = inner.calls
        with pytest.raises(r.BreakerOpenError) as ei:
            rs.get("k")
        assert ei.value.errno == 5 and inner.calls == calls  # fail fast, no call
        down["down"] = False
        # the probe thread flips the state to CLOSED under the breaker's
        # lock and fires on_reset after releasing it: wait for both
        deadline = time.time() + 5.0
        while (br.state != r.BreakerState.CLOSED or not resets) \
                and time.time() < deadline:
            time.sleep(0.02)
        assert br.state == r.BreakerState.CLOSED and resets == [1]
        assert rs.get("k") == b"v"
    finally:
        rs.close()


def test_half_open_refailure_retrips(pkg):
    r = pkg.res
    br = r.CircuitBreaker(backend=f"torch-cb-{id(pkg)}", threshold=0.5, min_samples=2,
                          probe_interval=999.0)
    resets = []
    br.on_reset(lambda: resets.append(1))
    br.record_failure()
    br.record_failure()
    assert br.state == r.BreakerState.OPEN
    br._state = r.BreakerState.HALF_OPEN
    br.record_failure()
    assert br.state == r.BreakerState.OPEN
    br._state = r.BreakerState.HALF_OPEN
    br.record_success()
    br.record_success()
    assert br.state == r.BreakerState.CLOSED and resets == [1]
    br.close()


def test_hedged_get_first_response_wins(pkg):
    r = pkg.res
    inner = CountingMem(pkg.Mem)
    inner._s.put("k", b"hedged!")
    state = {"calls": 0}
    gate = threading.Event()
    real_get = inner.get

    def slow_first(key, off=0, limit=-1):
        state["calls"] += 1
        if state["calls"] == 1:  # primary: stuck until released
            gate.wait(10.0)
        return real_get(key, off, limit)

    inner.get = slow_first
    rs = r.resilient(inner, policy=r.RetryPolicy(deadline=8.0, max_attempts=2),
                     hedge=True, hedge_delay=0.05)
    w0 = _counter(pkg, "juicefs_object_hedge_wins", rs.metric_backend).value
    try:
        t0 = time.perf_counter()
        assert rs.get("k") == b"hedged!"
        assert time.perf_counter() - t0 < 2.0
        assert state["calls"] == 2
        assert _counter(pkg, "juicefs_object_hedge_wins", rs.metric_backend).value == w0 + 1
    finally:
        gate.set()
        rs.close()


def test_resilience_snapshot_keys(pkg):
    """After a hedge and a trip, the snapshot carries the same keys in both
    packages (short names, non-zero series only)."""
    r = pkg.res
    rs = r.resilient(pkg.Mem(), hedge=False)
    try:
        h = rs.health()
        assert h["breaker"]["state"] == "closed" and h["degraded"] is False
        snap = r.resilience_snapshot()
        assert isinstance(snap, dict)
        assert set(snap) <= {n.replace("juicefs_object_", "") for n in
                             r._SNAPSHOT_COUNTERS + ("juicefs_object_breaker_state",
                                                     "juicefs_object_shed_limit")}
    finally:
        rs.close()
    assert port_resilient._SNAPSHOT_COUNTERS == ref_resilient._SNAPSHOT_COUNTERS


def test_breaker_open_error_is_eio():
    e = port_resilient.BreakerOpenError("store")
    assert isinstance(e, OSError) and e.errno == 5
    assert str(e) == str(ref_resilient.BreakerOpenError("store"))
