"""Thread-ms per GiB committed in the compress plane's lz4 of the
blocks to upload (stage chunk.upload.compress)."""

from portbench.readers import stage_ms_per_gib


def read(rec):
    return stage_ms_per_gib(rec, "chunk.upload.compress")
