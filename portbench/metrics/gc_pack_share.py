"""Share of `gc --dedup` pass wall time the thread that feeds the card
spends packing blocks into the pinned staging slot (`gpu.hash.pack` in
`HashPipeline._dispatch_device`), in %."""

from portbench.spans import stage_pass_share


def read(rec):
    return stage_pass_share(rec, "gpu.hash.pack")
