"""Thread-ms per GiB committed in the statement that ends each of the
sqlite meta engine's write transactions (`meta.txn.commit`: the COMMIT and
its WAL append, or the ROLLBACK of a discard or a closure that raised)."""

from portbench.readers import stage_ms_per_gib


def read(rec):
    return stage_ms_per_gib(rec, "meta.txn.commit")
