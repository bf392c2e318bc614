"""Mean time a block waits in `HashBatcher`, from `submit()` accepting it
to its batch being handed to the ingest worker (`gpu.batcher.wait`), in ms."""

from portbench.spans import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "gpu.batcher.wait")
