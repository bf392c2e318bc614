"""Thread-ms per GiB committed in the ingest stage's host pack and one
shared upload of a hash batch (`chunk.ingest` pack_blocks + shard_packed)."""

from portbench.readers import stage_ms_per_gib


def read(rec):
    return stage_ms_per_gib(rec, "chunk.ingest.pack")
