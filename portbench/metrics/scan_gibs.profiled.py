"""Live bytes of every `gc --dedup` pass in the traced run's window over
its seconds, in GiB/s. Taken under the profiler, which slows the host;
the untraced run reports the same rate under `unbounded`."""


def read(rec):
    return rec["window"]["metrics"]["scan_gibs"]["value"]
