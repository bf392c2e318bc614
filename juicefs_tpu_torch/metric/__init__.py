"""Metrics: the port's own Prometheus-compatible registry.

A copy of the three meter types of juicefs_tpu/metric (counter, gauge,
histogram) and the registry that renders them in the text exposition
format. The port registers its meters here, in a registry of its own, so
its `juicefs_torch_*` series never mix with the reference's.
"""

from __future__ import annotations

import threading
from typing import Iterable

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "global_registry"]

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

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for s in self._series():
            out.append(f"{self.name}{_fmt_labels(s._label_dict())} {s.value}")
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
