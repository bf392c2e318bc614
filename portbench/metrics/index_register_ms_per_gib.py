"""Thread-ms per GiB committed in the content indexer's meta transactions
(`chunk.index.register` around `set_block_digests`, on the thread that
records the rows of every batch hashed since its last transaction)."""

from portbench.readers import stage_ms_per_gib


def read(rec):
    return stage_ms_per_gib(rec, "chunk.index.register")
