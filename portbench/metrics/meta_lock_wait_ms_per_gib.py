"""Thread-ms per GiB committed that the sqlite meta engine's write
transactions waited for the write lock (`meta.txn.lock_wait`: the
process's own writers, then sqlite's lock, until BEGIN IMMEDIATE returned),
one observation an attempt."""

from portbench.readers import stage_ms_per_gib


def read(rec):
    return stage_ms_per_gib(rec, "meta.txn.lock_wait")
