"""Thread-ms per GiB committed in the content-ref plane's meta
transactions (`ContentRefs` lookup/incref and register)."""

from portbench.readers import stage_ms_per_gib


def read(rec):
    return stage_ms_per_gib(rec, "chunk.ingest.lookup", "chunk.ingest.register")
