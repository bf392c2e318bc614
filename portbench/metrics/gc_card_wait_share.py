"""Share of `gc --dedup` pass wall time the thread that feeds the card
waits on the card: for a staging slot's last upload (`gpu.hash.slot_wait`)
and for a batch's digests (`gpu.hash.drain`), in %."""

from portbench.spans import stage_pass_share


def read(rec):
    return stage_pass_share(rec, "gpu.hash.slot_wait", "gpu.hash.drain")
