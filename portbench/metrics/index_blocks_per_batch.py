"""Blocks a content-indexer batch: the driver's delta of
`juicefs_index_blocks` over the batches the indexer's worker processed
(`chunk.index.process`) in the window."""


def read(rec):
    batches = rec["stages"].get("chunk.index.process", {}).get("count", 0)
    if batches <= 0 or "index_blocks" not in rec["window"]:
        return None
    return rec["window"]["index_blocks"] / batches
