"""The slice as a whole: the port's `gc --dedup` scan leg on a volume that the
JAX package wrote, against the reference scan on the same volume.

The volume (sqlite meta, file:// storage, CachedStore, 256 KiB blocks = 4
lanes each, 13 full blocks and a ragged tail, 3 planted duplicates) is built through the
reference chunk plane. The reference scan records its digest rows; the rows
are wiped; the port scans the same meta and store. Digest rows and verdicts
must be identical (exact).
"""

import json

import numpy as np
import pytest

from juicefs_tpu.chunk import CachedStore, ChunkConfig
from juicefs_tpu.chunk.cached_store import block_key
from juicefs_tpu.cmd.gc import dedup_scan as ref_dedup_scan
from juicefs_tpu.meta import CHUNK_SIZE, Format, Slice, new_client
from juicefs_tpu.meta.context import Context
from juicefs_tpu.object import create_storage
from juicefs_tpu.tpu import jth256
from juicefs_tpu_torch.cmd.gc import dedup_scan

BS = 256 << 10


@pytest.fixture
def volume(tmp_path):
    rng = np.random.default_rng(7)
    pool = [rng.integers(0, 256, size=BS, dtype=np.uint8).tobytes() for _ in range(2)]
    blocks = [rng.integers(0, 256, size=BS, dtype=np.uint8).tobytes() for _ in range(8)]
    # 13 full blocks; 3 planted duplicates: pool[0] x3 and pool[1] x2
    for i, p in ((1, 0), (4, 1), (6, 0), (9, 0), (10, 1)):
        blocks.insert(i, pool[p])
    tail = rng.integers(0, 256, size=BS // 3 + 5, dtype=np.uint8).tobytes()

    m = new_client(f"sqlite3://{tmp_path}/meta.db")
    m.init(Format(name="torchgc", trash_days=0, block_size=BS >> 10), force=True)
    m.load()
    storage = create_storage(f"file://{tmp_path}/blob")
    storage.create()
    store = CachedStore(storage, ChunkConfig(block_size=BS, cache_dirs=("memory",),
                                             cache_size=1, max_download=4))
    ctx = Context(uid=0, gid=0)
    st, ino, _ = m.create(ctx, 1, b"data.bin", 0o644)
    assert st == 0
    per_chunk = CHUNK_SIZE // BS
    for i, data in enumerate(blocks + [tail]):
        sid = m.new_slice()
        w = store.new_writer(sid)
        w.write_at(data, 0)
        w.finish(len(data))
        indx, pos = divmod(i, per_chunk)
        assert m.write_chunk(ino, indx, pos * BS,
                             Slice(pos=pos * BS, id=sid, size=len(data), off=0,
                                   len=len(data))) == 0
    store.flush_all()
    # live map exactly as cmd/gc.py builds it
    live = {}
    for _ino, slcs in m.list_slices().items():
        for s in slcs:
            if s.id and s.size:
                for j in range((s.size + BS - 1) // BS):
                    live[block_key(s.id, j, min(BS, s.size - j * BS))] = \
                        min(BS, s.size - j * BS)
    try:
        yield m, store, live, blocks + [tail]
    finally:
        store.close()


def _rows(m):
    return {block_key(sid, indx, bsize): d for sid, indx, bsize, d in m.scan_block_digests()}


def _wipe(m):
    stale = [(sid, indx) for sid, indx, _b, _d in m.scan_block_digests()]
    if stale:
        m.delete_block_digests(stale)


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_port_scan_matches_reference_scan(volume, backend):
    m, store, live, blocks = volume
    assert len(live) == 14
    ref = ref_dedup_scan(m, store, live, "cpu", "", BS)
    ref_rows = _rows(m)
    assert ref["hashed_now"] == 14 and ref["duplicate_blocks"] == 3
    _wipe(m)
    assert _rows(m) == {}

    got = dedup_scan(m, store, live, backend, "", BS, threads=4, device="cpu",
                     batch_blocks=4)
    assert _rows(m) == ref_rows
    for k in ("blocks", "bytes", "from_index", "hashed_now", "duplicate_blocks",
              "duplicate_bytes", "dedup_groups", "stale_index_rows_removed"):
        assert got[k] == ref[k], k
    assert set(got) == set(ref) - {"resilience"}
    assert sorted(ref_rows.values()) == sorted(jth256(b) for b in blocks)
    assert got["shard"]["devices"] == (1 if backend == "cuda" else 0)


def test_port_scan_is_incremental_and_prunes(volume, tmp_path):
    m, store, live, _blocks = volume
    ref_dedup_scan(m, store, live, "cpu", "", BS)
    ref_rows = _rows(m)
    # one live row lost (a client without indexing) and one dead block gone
    dropped = sorted(ref_rows)[0]
    sid, indx, _b = (int(x) for x in dropped.rsplit("/", 1)[1].split("_"))
    m.delete_block_digests([(sid, indx)])
    gone = sorted(live)[-1]
    live = {k: v for k, v in live.items() if k != gone}
    index_path = tmp_path / "index.json"
    got = dedup_scan(m, store, live, "cuda", str(index_path), BS, device="cpu")
    assert got["hashed_now"] == 1 and got["from_index"] == len(live) - 1
    assert got["stale_index_rows_removed"] == 1
    assert _rows(m) == {k: v for k, v in ref_rows.items() if k != gone}
    index = json.loads(index_path.read_text())
    assert index == {k: ref_rows[k].hex() for k in live}
