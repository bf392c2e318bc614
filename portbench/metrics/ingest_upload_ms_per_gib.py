"""Thread-ms per GiB committed in the ingest stage's HtoD enqueue of a
packed hash batch (`gpu.hash.upload` in `HashPipeline.shard_packed`: a
pageable upload, so the host waits on CUDA's staging copy)."""

from portbench.readers import stage_ms_per_gib


def read(rec):
    return stage_ms_per_gib(rec, "gpu.hash.upload")
