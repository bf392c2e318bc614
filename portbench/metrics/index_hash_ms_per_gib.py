"""Thread-ms per GiB committed in the content indexer's hash call
(`gpu.index.batch` around `HashPipeline.hash_blocks`: pack into a pinned
slot, upload, launch and the wait for the digests)."""

from portbench.readers import stage_ms_per_gib


def read(rec):
    return stage_ms_per_gib(rec, "gpu.index.batch")
