"""Mean time a block waits for the content indexer, from `submit`
queueing it to its batch being handed to the worker's processing
(`chunk.index.wait`), in ms."""

from portbench.spans import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "chunk.index.wait")
