"""Share of the blocks entering the inline-dedup stage in the window that
it passed through to a plain upload, unhashed, because its queue was full
(the port's overload contract), in %."""


def read(rec):
    c = rec["counters"]
    if c["ingest_blocks"] <= 0:
        return None
    return 100.0 * c["ingest_passthrough"] / c["ingest_blocks"]
