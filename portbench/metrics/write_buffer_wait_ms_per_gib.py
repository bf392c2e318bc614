"""Thread-ms per GiB committed that writers waited for room under the
write buffer bound (`chunk.write.buffer_wait`, mount `--buffer-size`):
0.0 when the window committed bytes and no writer waited, None when it
committed nothing or the program has no such span."""

from portbench.readers import GIB

STAGE = "chunk.write.buffer_wait"


def _program_has_the_span() -> bool:
    """The program's stage rollup holds every span its modules bind, moved
    or not: a program without the bound has none of this name."""
    import juicefs_tpu_torch.chunk  # noqa: F401  (binds the store's spans)
    from juicefs_tpu_torch.metric.trace import stage_metrics_snapshot

    return STAGE in stage_metrics_snapshot()


def read(rec):
    nbytes = rec["window"].get("bytes", 0)
    if nbytes <= 0:
        return None
    moved = rec["stages"].get(STAGE)
    if moved is None:
        return 0.0 if _program_has_the_span() else None
    return moved["seconds"] * 1e3 / (nbytes / GIB)
