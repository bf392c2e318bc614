"""Share of the traced sub-window in which no kernel, memcpy or memset
ran on the card, in %."""

from portbench.readers import device_idle


def read(rec):
    return device_idle(rec)
