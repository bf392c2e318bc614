"""Thread-ms per GiB committed in the sqlite meta engine's write
transactions' closures and their statements (`meta.txn.run`), one
observation an attempt whose BEGIN succeeded."""

from portbench.readers import stage_ms_per_gib


def read(rec):
    return stage_ms_per_gib(rec, "meta.txn.run")
