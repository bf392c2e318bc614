"""Share of `gc --dedup` pass wall time in read + hash beyond the fetch
wall (`gpu.pipeline HashPipeline.hash_stream`: hashing the fetch window did
not hide), in %."""

from portbench.readers import pass_share


def read(rec):
    return pass_share(rec, "hash")
