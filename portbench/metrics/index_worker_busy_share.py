"""Share of the window the content indexer's worker, the one thread that
feeds the card on this path, spends processing batches
(`chunk.index.process`: each batch's hash call and the hand-off of its
rows), in %."""

from portbench.spans import stage_window_share


def read(rec):
    return stage_window_share(rec, "chunk.index.process")
