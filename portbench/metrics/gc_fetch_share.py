"""Share of `gc --dedup` pass wall time spent fetching blocks
(`chunk.parallel.fetch_ordered`: the wall with GETs in flight), in %."""

from portbench.readers import pass_share


def read(rec):
    return pass_share(rec, "get")
