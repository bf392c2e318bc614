"""The JTH-256 hash kernels' share of the card's memory roofline in the
traced sub-window, in %: (bytes hashed + 32 B a block) at the published peak
over the device time of the hash kernels (portbench/roofline.py)."""

from portbench.readers import hash_roofline


def read(rec):
    return hash_roofline(rec)
