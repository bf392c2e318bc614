"""Time a file's close waits on its blocks, per file committed in the
window (`chunk.write.finish` in `WSlice.finish`: hash, lookup, elision or
lz4 + PUT), in ms. `file_flush_ms` less this is the slice's meta commit."""

STAGE = "chunk.write.finish"


def read(rec):
    moved = rec["stages"].get(STAGE)
    files = rec["window"].get("files", 0)
    if moved is None or files <= 0:
        return None
    return moved["seconds"] * 1e3 / files
