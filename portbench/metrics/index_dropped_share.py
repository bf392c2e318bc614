"""Share of the blocks handed to the content indexer in the window that
its full queue dropped, in %: the driver's deltas of
`juicefs_index_dropped` over those of `juicefs_index_blocks`,
`juicefs_index_dropped` and `juicefs_index_errors` (blocks indexed,
dropped, or in a failed batch)."""


def read(rec):
    w = rec["window"]
    if any(k not in w for k in ("index_blocks", "index_dropped", "index_errors")):
        return None
    total = w["index_blocks"] + w["index_dropped"] + w["index_errors"]
    if total <= 0:
        return None
    return 100.0 * w["index_dropped"] / total
