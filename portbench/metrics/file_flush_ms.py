"""Mean time of the VFS's `flush` of a file, the per-file commit barrier:
the wait for the file's block and its slice's commit into meta (the
rollup's `vfs.flush`, the VFS ops' latency histogram), in ms."""

from portbench.spans import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "vfs.flush")
