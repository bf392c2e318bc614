"""Share of `gc --dedup` pass wall time in the meta engine: loading the
index and backfilling its rows (`meta`, kv on sqlite3), in %."""

from portbench.readers import pass_share


def read(rec):
    return pass_share(rec, "index_load", "meta_backfill")
