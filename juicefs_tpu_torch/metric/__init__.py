"""Metrics: the port's own Prometheus-compatible registry.

A copy of the three meter types of juicefs_tpu/metric (counter, gauge
with lazily evaluated values, histogram with a timer) and the registry
that renders them in the text exposition format, with the process gauges,
the `/metrics` HTTP endpoint (`MetricsServer`) that `gateway --metrics`
serves, and the push exporter (`MetricsPusher`) behind `mount
--metrics-push` / `--graphite`. The port registers its meters here, in a
registry of its own, so its series never mix with the reference's.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsPusher", "MetricsServer",
           "Registry", "global_registry"]

_DEFAULT_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60,
)


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._children: dict[tuple[str, ...], _Metric] = {}
        self._lock = threading.Lock()

    def _make_child(self) -> "_Metric":
        return self.__class__(self.name, self.help)

    def labels(self, *values: str):
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                child._label_values = key  # type: ignore[attr-defined]
                child.label_names = self.label_names
                self._children[key] = child
            return child

    def _label_dict(self) -> dict[str, str]:
        values = getattr(self, "_label_values", ())
        return dict(zip(self.label_names, values))

    def _series(self) -> Iterable["_Metric"]:
        if self._children:
            yield from self._children.values()
        else:
            yield self

    def render(self) -> str:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str = "", label_names: tuple[str, ...] = ()):
        super().__init__(name, help_, label_names)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for s in self._series():
            out.append(f"{self.name}{_fmt_labels(s._label_dict())} {s.value}")
        return "\n".join(out)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_: str = "", label_names: tuple[str, ...] = ()):
        super().__init__(name, help_, label_names)
        self.value = 0.0
        self._fn = None

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    def set_function(self, fn) -> None:
        """Lazily-evaluated gauge: `fn()` is read at render time."""
        self._fn = fn

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for s in self._series():
            v = s._fn() if s._fn is not None else s.value
            out.append(f"{self.name}{_fmt_labels(s._label_dict())} {v}")
        return "\n".join(out)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str = "", label_names: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.sum = 0.0
        self.total = 0

    def _make_child(self) -> "Histogram":
        # children must inherit the parent's bucket layout
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, v: float) -> None:
        with self._lock:
            self.sum += v
            self.total += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def time(self):
        """Context manager observing elapsed seconds."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *a):
                hist.observe(time.perf_counter() - self.t0)

        return _Timer()

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for s in self._series():
            labels = s._label_dict()
            acc = 0
            for i, b in enumerate(s.buckets):
                acc += s.counts[i]
                lb = dict(labels, le=repr(b) if b != int(b) else str(b))
                out.append(f"{self.name}_bucket{_fmt_labels(lb)} {acc}")
            lb = dict(labels, le="+Inf")
            out.append(f"{self.name}_bucket{_fmt_labels(lb)} {s.total}")
            out.append(f"{self.name}_sum{_fmt_labels(labels)} {s.sum}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} {s.total}")
        return "\n".join(out)


class Registry:
    """Named metric collection rendering the text exposition format."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        # conflicting re-registrations (same name, different type/labels):
        # recorded instead of raising; the first registration wins
        self.conflicts: list[str] = []

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if (existing.kind != metric.kind
                        or existing.label_names != metric.label_names):
                    self.conflicts.append(
                        f"{metric.name}: re-registered as {metric.kind}"
                        f"{metric.label_names} (was {existing.kind}"
                        f"{existing.label_names})"
                    )
                return existing
            self._metrics[metric.name] = metric
            return metric

    def walk(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def counter(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Counter:
        return self._register(Counter(name, help_, labels))  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge(name, help_, labels))  # type: ignore[return-value]

    def histogram(self, name: str, help_: str = "", labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = _DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_, labels, buckets))  # type: ignore[return-value]

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.render() for m in metrics) + "\n"


_global = Registry()


def global_registry() -> Registry:
    return _global


def register_process_metrics(reg: Optional[Registry] = None) -> None:
    """CPU / memory / uptime gauges (reference pkg/metric/metrics.go:34-56)."""
    import os
    import resource

    reg = reg or global_registry()
    t0 = time.time()
    reg.gauge("juicefs_uptime", "Seconds since process start").set_function(
        lambda: time.time() - t0
    )
    reg.gauge("juicefs_cpu_usage", "Accumulated process CPU seconds").set_function(
        lambda: (lambda r: r.ru_utime + r.ru_stime)(
            resource.getrusage(resource.RUSAGE_SELF)
        )
    )
    reg.gauge("juicefs_memory", "Peak RSS in bytes").set_function(
        lambda: resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    )
    reg.gauge("juicefs_pid", "Process id").set_function(os.getpid)


class MetricsServer:
    """HTTP /metrics endpoint for a registry
    (reference exposeMetrics cmd/mount.go:84: pull-based Prometheus).

    Binds host:port (port 0 picks a free one — exposed via .port) and
    serves the text exposition format from a daemon thread.
    """

    @classmethod
    def from_addr(cls, addr: str, registry: Optional[Registry] = None,
                  with_process_metrics: bool = True) -> "MetricsServer":
        """Parse 'host:port' / ':port' / 'port', validate, register the
        process gauges, and start serving."""
        host, _, port = addr.rpartition(":")
        if not port.isdigit():
            raise ValueError(
                f"--metrics expects host:port or port, got {addr!r}"
            )
        if with_process_metrics:
            register_process_metrics(registry)
        return cls(registry, host=host or "127.0.0.1", port=int(port)).start()

    def __init__(self, registry: Optional[Registry] = None,
                 host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry or global_registry()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = reg.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics", daemon=True
        )

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()  # blocks until serve_forever exits
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        self._httpd.server_close()


class MetricsPusher:
    """Push-based metrics export (reference pkg/metric/metrics.go:67 and
    sdk/java/libjfs/main.go:354-407): POST the Prometheus text format to
    a Pushgateway, or stream Graphite plaintext over TCP, on an interval.
    Fail-silent — metrics export must never take down a mount."""

    def __init__(self, registry: Registry, interval: float = 10.0,
                 pushgateway: str = "", graphite: str = "",
                 job: str = "juicefs", prefix: str = "juicefs"):
        self.registry = registry
        self.interval = interval
        self.pushgateway = pushgateway
        self.graphite = graphite
        self.job = job
        self.prefix = prefix
        self.pushes = 0
        self.errors = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="metrics-push"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.push_once()

    def push_once(self) -> None:
        try:
            if self.pushgateway:
                self._push_gateway()
            if self.graphite:
                self._push_graphite()
            self.pushes += 1
        except Exception:
            self.errors += 1

    def _push_gateway(self) -> None:
        import urllib.request

        from urllib.parse import quote

        body = self.registry.render().encode()
        url = self.pushgateway.rstrip("/")
        if not url.startswith(("http://", "https://")):
            url = "http://" + url
        req = urllib.request.Request(
            f"{url}/metrics/job/{quote(self.job, safe='')}",
            data=body, method="PUT",
            headers={"Content-Type": "text/plain"},
        )
        urllib.request.urlopen(req, timeout=5).read()

    def _push_graphite(self) -> None:
        import socket as _socket

        import re as _re

        host, _, port = self.graphite.rpartition(":")
        ts = int(time.time())
        lines = []
        for line in self.registry.render().splitlines():
            if not line or line.startswith("#"):
                continue
            metric, _, value = line.rpartition(" ")
            if not metric:
                continue
            # labels become path segments (label values only, in order):
            # distinct series must stay distinct Graphite paths, or every
            # labeled series and histogram bucket collapses into one
            name, _, labels = metric.partition("{")
            path = name
            if labels:
                for val in _re.findall(r'="([^"]*)"', labels):
                    path += "." + (_re.sub(r"[^A-Za-z0-9_-]", "_", val) or "_")
            lines.append(f"{self.prefix}.{path} {value} {ts}\n")
        with _socket.create_connection((host or "127.0.0.1", int(port)),
                                       timeout=5) as s:
            s.sendall("".join(lines).encode())

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
