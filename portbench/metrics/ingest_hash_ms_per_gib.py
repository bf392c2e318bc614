"""Thread-ms per GiB committed in the ingest stage's hash of a batch
(`gpu.pipeline.hash_packed`: the launch and the wait for its digests)."""

from portbench.readers import stage_ms_per_gib


def read(rec):
    return stage_ms_per_gib(rec, "chunk.ingest.hash")
