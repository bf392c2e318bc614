"""The device trace of a run: `DeviceTrace` in a `--trace 1` run,
`CardClock` in a `--trace 0` run (below).

`torch.profiler` (CUPTI) records a steady sub-window of the measured
window; the driver calls `start()` and `stop()` at its edges, and the
benchmark's own spans (`span(name)`, a profiler range) mark what the host
was doing around the calls into each layer. From the exported trace:

- busy seconds: the union of every kernel, memcpy and memset interval;
- hash kernel seconds: the summed time of the program's hash kernels;
- the device operations that took most time, and the longest idle gaps,
  each named by the innermost host operation running at its middle.

The pipeline's byte and block counters are read at both edges, so the
roofline divides the work of exactly this sub-window. With tracing off
every call is a no-op.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

from . import roofline
from .stats import gaps, union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "portbench.window"
TOP = 10


def counters() -> dict:
    """The hash pipeline's cumulative block and byte counters, and the
    inline-dedup stage's blocks and passthroughs (0 before it loads)."""
    from juicefs_tpu_torch.metric import global_registry

    reg = global_registry()._metrics

    def value(name):
        m = reg.get(name)
        return m.value if m is not None else 0

    return {"blocks_hashed": value("juicefs_torch_blocks_hashed"),
            "hash_bytes": value("juicefs_torch_hash_bytes"),
            "ingest_blocks": value("juicefs_ingest_blocks"),
            "ingest_passthrough": value("juicefs_ingest_passthrough")}


def span(name: str):
    """A profiler range named `name` (a no-op cost while no profiler runs)."""
    import torch

    return torch.profiler.record_function(name)


class DeviceTrace:
    """`begin()` before the window starts the profiler, `start()` and
    `stop()` mark the traced sub-window (the counters are read at both
    marks), `end()` after the window stops the profiler and reduces the
    trace to `summary`. The profiler runs from before the window's threads
    start doing device work until after they stop."""

    def __init__(self, enabled: bool, workdir: str, kind: str):
        self.enabled = enabled
        self.workdir = workdir
        self.kind = kind
        self.summary = None
        self._prof = None
        self._range = None
        self._c0 = self._c1 = None
        self._t0 = 0.0
        self._host_s = 0.0

    @property
    def running(self) -> bool:
        return self._range is not None

    def begin(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        kw = {}
        try:  # record the host ops of every thread, not only this one's
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw)
        self._prof.start()

    def start(self) -> None:
        if self._prof is None or self._range is not None or self._c1 is not None:
            return
        import torch

        torch.cuda.synchronize()
        self._c0 = counters()
        self._range = contextlib.ExitStack()
        self._range.enter_context(span(WINDOW))
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._range is None:
            return
        import torch

        torch.cuda.synchronize()
        self._host_s = time.perf_counter() - self._t0
        self._range.close()
        self._range = None
        self._c1 = counters()

    def end(self) -> None:
        if self._prof is None:
            return
        self.stop()
        self._prof.stop()
        path = os.path.join(self.workdir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        if self._c1 is None:
            raise RuntimeError("the traced sub-window was never marked")
        self.summary = summarise(events, self.kind, self._host_s)
        if self.summary["device_events"] == 0:
            raise RuntimeError("the profiler recorded no kernel or copy on the card in "
                               "the traced window; no device numbers to report")
        self.summary["blocks_hashed"] = int(self._c1["blocks_hashed"] - self._c0["blocks_hashed"])
        self.summary["hash_bytes"] = int(self._c1["hash_bytes"] - self._c0["hash_bytes"])


class CardClock:
    """The card's time over a whole untraced window, the source of the
    end-to-end metrics taken from the device trace: `seconds["busy"]`, the
    union of every kernel, memcpy and memset interval, and
    `seconds["kernels"]`, the union of the kernels' alone, that
    `torch.profiler` (CUPTI, card activity alone: no host op is recorded)
    saw between `begin()`, after the card has finished the set-up's work,
    and `end()`, after it has finished the window's. `seconds` is None
    while disabled."""

    def __init__(self, enabled: bool, workdir: str):
        self.enabled = enabled
        self.workdir = workdir
        self.seconds = None
        self._prof = None

    def begin(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def end(self) -> None:
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self._prof.stop()
        path = os.path.join(self.workdir, "card.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        self.seconds = card_seconds(events)


def card_seconds(events: list) -> dict:
    """Busy and kernel seconds of a trace that covers only the window."""
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("cat"))
           for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels = [(s, t) for s, t, cat in dev if cat == "kernel"]
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel on the card in the "
                           "window; no device numbers to report")
    lo, hi = min(s for s, _t, _c in dev), max(t for _s, t, _c in dev)
    return {"busy": union_length([(s, t) for s, t, _c in dev], lo, hi) / 1e6,
            "kernels": union_length(kernels, lo, hi) / 1e6}


def _short(name: str) -> str:
    """A kernel's name without its parameter list."""
    depth, cut = 0, len(name)
    for i in range(len(name) - 1, -1, -1):
        if name[i] == ")":
            depth += 1
        elif name[i] == "(":
            depth -= 1
            if depth == 0:
                cut = i
                break
    head = name[:cut] if cut > 0 and name.endswith(")") else name
    return head[:160]


def summarise(events: list, kind: str, host_s: float) -> dict:
    """Busy and hash-kernel seconds, the top device operations and the
    longest idle gaps of one exported trace, within its window range."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if win:
        lo = float(win[0]["ts"])
        hi = lo + float(win[0]["dur"])
    elif dev:
        lo = min(float(e["ts"]) for e in dev)
        hi = lo + host_s * 1e6
    else:
        lo, hi = 0.0, host_s * 1e6
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in dev]
    busy_us = union_length(spans, lo, hi)
    by_name: dict[str, float] = {}
    hash_us = 0.0
    for e, (s, t) in zip(dev, spans):
        d = max(0.0, min(t, hi) - max(s, lo))
        name = _short(str(e.get("name", "?")))
        by_name[name] = by_name.get(name, 0.0) + d
        if e.get("cat") == "kernel" and roofline.is_hash_kernel(str(e.get("name", ""))):
            hash_us += d
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), str(e.get("name", "?")))
            for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW]
    idle = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    named_gaps = []
    for s, t in idle:
        mid = (s + t) / 2
        inner = min((h for h in host if h[0] <= mid <= h[1]),
                    key=lambda h: h[1] - h[0], default=None)
        named_gaps.append([inner[2][:160] if inner else "no host op recorded", (t - s) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "hash_kernel_s": hash_us / 1e6,
        "device_events": sum(1 for s, t in spans if t > lo and s < hi),
        "kind": kind,
        "breakdown": {"device_ops": [[n, us / 1e6] for n, us in ops],
                      "idle_gaps": named_gaps},
    }
