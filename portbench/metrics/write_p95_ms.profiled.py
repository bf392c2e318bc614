"""95th percentile of the commit latency of every file committed in the
traced run's window, from its first write to its close returning, in ms.
Taken under the profiler, which slows the host; the untraced run reports
the same statistic under `unbounded`."""


def read(rec):
    p95 = rec["window"]["metrics"].get("write_p95_ms")
    return None if p95 is None else p95["value"]
