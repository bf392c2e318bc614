"""Share of the window the inline-dedup worker, the one thread that feeds
the card on the write path, spends processing batches
(`chunk.ingest.process` around `IngestPipeline._process`), in %."""

from portbench.spans import stage_window_share


def read(rec):
    return stage_window_share(rec, "chunk.ingest.process")
