"""Thread-ms per GiB committed in the upload pool's PUTs
(`chunk.cached_store` `_put_block`, stage chunk.upload.put)."""

from portbench.readers import stage_ms_per_gib


def read(rec):
    return stage_ms_per_gib(rec, "chunk.upload.put")
