"""Blocks per hash batch of the ingest stage (`HashBatcher`): blocks
hashed over hash batches dispatched in the window."""

from portbench.readers import blocks_per_batch


def read(rec):
    return blocks_per_batch(rec, "chunk.ingest.hash")
