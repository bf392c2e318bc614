"""Share of `gc --dedup` pass wall time the hash pipeline waits on the
oldest block fetch (`chunk.fetch.wait` in `fetch_ordered`), in %."""

from portbench.spans import stage_pass_share


def read(rec):
    return stage_pass_share(rec, "chunk.fetch.wait")
