"""Mean time of the VFS's `create` of a file, meta's create and the handle
(the rollup's `vfs.create`, the VFS ops' latency histogram), in ms."""

from portbench.spans import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "vfs.create")
