"""The port's admin CLI (juicefs_tpu_torch/cmd: format, gc, fsck) against
the JAX package's, on the same volumes.

The slice as a whole: a volume is formatted and written (by the port's
`build_store` with its BlockIndexer, or by the JAX package's VFS), then the
port's `gc --dedup` and `fsck --verify-data --hash-index` run on one copy
and the JAX package's on an identical second copy (written by the same
seeded steps, so slice ids, block keys and bytes agree). Counts, printed
lines and index JSON must be equal. On the CPU the port's commands take
`--hash-backend cpu --compress-backend cpu`; a device hash backend with no
card makes `format` and `build_store` raise.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from juicefs_tpu.cmd import main as ref_main
from juicefs_tpu.meta.context import Context as RefContext
from juicefs_tpu.tpu.jth256 import jth256
from juicefs_tpu_torch import cmd
from juicefs_tpu_torch.chunk.cached_store import block_key
from juicefs_tpu_torch.chunk.ingest import IngestPipeline
from juicefs_tpu_torch.meta import CHUNK_SIZE, Slice, new_client
from juicefs_tpu_torch.meta.context import Context

BS = 256 << 10  # --block-size 256 (KiB): 4 lanes a block
CPU = ["--hash-backend", "cpu", "--compress-backend", "cpu"]
COUNT_KEYS = ("blocks", "bytes", "from_index", "hashed_now", "stale_index_rows_removed",
              "duplicate_blocks", "duplicate_bytes", "dedup_groups", "backend",
              "fetch_window", "content_refs")


def _plan(seed: int = 11):
    """10 full blocks (3 planted duplicates) and a ragged tail."""
    rng = np.random.default_rng(seed)
    uniq = [rng.integers(0, 256, size=BS, dtype=np.uint8).tobytes() for _ in range(7)]
    full = uniq[:3] + [uniq[0]] + uniq[3:5] + [uniq[1], uniq[0]] + uniq[5:]
    return full + [rng.integers(0, 256, size=BS // 2 + 13, dtype=np.uint8).tobytes()]


def _format(tmp_path, name: str, compress: str, hash_backend: str = "cpu") -> str:
    meta_url = f"sqlite3://{tmp_path}/{name}.db"
    rc = cmd.main(["format", meta_url, name, "--storage", "file", "--bucket",
                   str(tmp_path / f"{name}-blob"), "--block-size", str(BS >> 10),
                   "--compress", compress, "--hash-backend", hash_backend,
                   "--trash-days", "0"])
    assert rc == 0
    return meta_url


def _port_write(meta_url: str, blocks) -> dict:
    """Each block its own slice of one file, through the port's build_store
    (BlockIndexer on the volume's cpu backend); returns the indexer stats."""
    m, fmt = cmd.open_meta(meta_url)
    store = cmd.build_store(fmt, types.SimpleNamespace(compress_backend="cpu", cache_size=1),
                            meta=m)
    try:
        assert store.indexer is not None and store.indexer.backend == "cpu"
        ctx = Context(uid=0, gid=0)
        st, ino, _ = m.create(ctx, 1, b"data.bin", 0o644)
        assert st == 0
        per_chunk = CHUNK_SIZE // BS
        for i, data in enumerate(blocks):
            sid = m.new_slice()
            w = store.new_writer(sid)
            w.write_at(data, 0)
            w.finish(len(data))
            indx, pos = divmod(i, per_chunk)
            assert m.write_chunk(ino, indx, pos * BS, Slice(
                pos=pos * BS, id=sid, size=len(data), off=0, len=len(data))) == 0
        assert m.close(ctx, ino) == 0
        store.flush_all()
        store.indexer.flush()
        return store.indexer.stats()
    finally:
        store.close()
        m.client.close()


def _ref_vfs_write(meta_url: str, tmp_path, blocks) -> None:
    """The same bytes as files written through the JAX package's VFS."""
    from juicefs_tpu.cmd import build_store, open_meta
    from juicefs_tpu.vfs import ROOT_INO, VFS

    m, fmt = open_meta(meta_url)
    m.new_session()
    v = VFS(m, build_store(fmt, types.SimpleNamespace(
        cache_dir=str(tmp_path / "cache"), writeback=False, cache_size=0), meta=m), fmt=fmt)
    ctx = RefContext(uid=0, gid=0, pid=1)
    try:
        for i in range(0, len(blocks), 4):
            st, ino, _, fh = v.create(ctx, ROOT_INO, b"f%d" % i, 0o644)
            assert st == 0
            assert v.write(ctx, ino, fh, 0, b"".join(blocks[i:i + 4])) == 0
            assert v.release(ctx, ino, fh) == 0
        v.store.indexer.flush()
    finally:
        v.close()


def _drop_rows(meta_url: str, n: int) -> None:
    """Lose n digest rows, as an indexer under overload would."""
    m = new_client(meta_url)
    rows = sorted((sid, indx) for sid, indx, _b, _d in m.scan_block_digests())
    m.delete_block_digests(rows[:n])
    m.client.close()


def _run(main, argv, capsys) -> tuple[int, list[str]]:
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("writer,compress", [("port-store", "none"), ("port-store", "lz4"),
                                             ("ref-vfs", "lz4")])
def test_cli_matches_reference_on_the_same_volume(tmp_path, capsys, writer, compress):
    blocks = _plan()
    urls = {}
    for side in ("port", "ref"):
        urls[side] = _format(tmp_path / side, "vol", compress)
        if writer == "port-store":
            stats = _port_write(urls[side], blocks)
            assert stats["blocks"] == len(blocks) and stats["errors"] == 0
        else:
            _ref_vfs_write(urls[side], tmp_path / side, blocks)
        _drop_rows(urls[side], 2)

    out = {}
    for side, main, extra in (("port", cmd.main, ["--compress-backend", "cpu"]),
                              ("ref", ref_main, [])):
        index = tmp_path / f"{side}-dedup.json"
        rc, gc_lines = _run(main, ["gc", urls[side], "--dedup", "--dedup-index",
                                   str(index)] + extra, capsys)
        assert rc == 0
        hash_index = tmp_path / f"{side}-hash.json"
        rc, fsck_lines = _run(main, ["fsck", urls[side], "--verify-data", "--hash-index",
                                     str(hash_index)] + extra, capsys)
        assert rc == 0
        out[side] = {"gc": gc_lines, "stats": json.loads(gc_lines[-1]), "fsck": fsck_lines,
                     "index": json.loads(index.read_text()),
                     "hash_index": json.loads(hash_index.read_text())}
    port, ref = out["port"], out["ref"]
    assert port["gc"][:-1] == ref["gc"][:-1]
    assert port["gc"][0].endswith("0 leaked, 0 missing")
    assert set(port["stats"]) == set(ref["stats"])
    assert {k: port["stats"][k] for k in COUNT_KEYS} == {k: ref["stats"][k] for k in COUNT_KEYS}
    assert port["stats"]["hashed_now"] == 2 and port["stats"]["duplicate_blocks"] == 3
    assert port["fsck"] == ref["fsck"]
    assert port["fsck"][0].startswith(f"verified {len(blocks)} blocks (cpu)")
    assert port["index"] == ref["index"] == port["hash_index"] == ref["hash_index"]
    assert sorted(port["index"].values()) == sorted(jth256(b).hex() for b in blocks)


def test_fsck_catches_planted_bitrot(tmp_path, capsys, caplog):
    meta_url = _format(tmp_path, "rot", "none")
    blocks = _plan(5)
    _port_write(meta_url, blocks)
    m, fmt = cmd.open_meta(meta_url)
    objects = cmd.storage_for(fmt)
    victim = sorted(o.key for o in objects.list_all("chunks/"))[4]
    good = bytes(objects.get(victim))
    objects.put(victim, good[:50] + bytes([good[50] ^ 0xFF]) + good[51:])
    m.client.close()

    # the existence/size check alone passes; only the digests see the rot
    assert _run(cmd.main, ["fsck", meta_url] + CPU, capsys)[0] == 0
    with caplog.at_level("ERROR", logger="cmd.fsck"):
        rc, lines = _run(cmd.main, ["fsck", meta_url, "--verify-data"] + CPU, capsys)
    assert rc == 1
    assert lines[0].endswith("1 digest mismatches") and lines[-1].endswith("1 broken")
    mismatched = [r.getMessage() for r in caplog.records if "digest mismatch" in r.getMessage()]
    assert mismatched == [f"block {victim} content digest mismatch (bitrot?)"]
    # the JAX package's fsck reads the port-written volume the same way
    assert _run(ref_main, ["fsck", meta_url, "--verify-data"], capsys) == (rc, lines)


def test_gc_delete_removes_leak_and_keeps_aliased_canonical(tmp_path, capsys):
    """A canonical object whose own slice is gone stays while an alias of
    another live block still reads through it; a leaked object goes."""
    meta_url = _format(tmp_path, "gcdel", "none")
    blob = _plan(2)[0]
    m, fmt = cmd.open_meta(meta_url)
    store = cmd.build_store(fmt, types.SimpleNamespace(compress_backend="cpu"), meta=m)
    # the inline-dedup ingest stage, as mount --inline-dedup attaches it
    store.ingest = IngestPipeline(store, store.content_refs, backend="cpu")
    ctx = Context(uid=0, gid=0)
    try:
        for name in (b"a.bin", b"b.bin"):
            st, ino, _ = m.create(ctx, 1, name, 0o644)
            assert st == 0
            sid = m.new_slice()
            w = store.new_writer(sid)
            w.write_at(blob, 0)
            w.finish(BS)
            assert m.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=BS, off=0, len=BS)) == 0
            assert m.close(ctx, ino) == 0
        store.ingest.flush()
        store.flush_all()
        assert store.ingest.stats()["put_elided"] == 1
    finally:
        store.close()
    objects = cmd.storage_for(fmt)
    canonical = [o.key for o in objects.list_all("chunks/")]
    assert len(canonical) == 1
    leak = block_key(999, 0, 5)
    objects.put(leak, b"stray")
    assert m.unlink(ctx, 1, b"a.bin") == 0  # the canonical's own file
    m.cleanup_deleted_files()
    m.client.close()

    rc, lines = _run(cmd.main, ["gc", meta_url, "--delete", "--age", "0"] + CPU, capsys)
    assert rc == 0
    assert lines == ["scanned: 2 objects, 1 live blocks (1 deduped), 1 leaked, 0 missing",
                     "deleted 1 leaked objects"]
    assert sorted(o.key for o in objects.list_all("chunks/")) == canonical
    rc, lines = _run(cmd.main, ["fsck", meta_url, "--verify-data"] + CPU, capsys)
    assert rc == 0 and lines[-1] == "checked 1 files / 1 blocks; 0 broken"


@pytest.mark.parametrize("entry", ["format", "build_store", "gc"])
def test_device_hash_backend_without_card_raises(tmp_path, capsys, entry):
    """`pallas` (like tpu and xla) means the card: with none, format fails
    before writing anything and a store or scan on such a volume raises;
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    meta_url = f"sqlite3://{tmp_path}/dev.db"
    bucket = str(tmp_path / "blob")
    if entry == "format":
        rc = cmd.main(["format", meta_url, "dev", "--storage", "file", "--bucket", bucket,
                       "--hash-backend", "pallas"])
        assert rc == 1
        with pytest.raises(RuntimeError, match="not formatted"):
            new_client(meta_url).load()
        from juicefs_tpu_torch.cmd.format import probe_device_bandwidth

        with pytest.raises(RuntimeError, match="--hash-backend pallas"):
            probe_device_bandwidth("pallas")
        return
    # a device-backend volume, as the JAX package formats it
    assert ref_main(["format", meta_url, "dev", "--storage", "file", "--bucket", bucket,
                     "--hash-backend", "pallas"]) == 0
    m, fmt = cmd.open_meta(meta_url)
    try:
        if entry == "build_store":
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cmd.build_store(fmt, types.SimpleNamespace(compress_backend="cpu"), meta=m)
        else:
            assert cmd.main(["gc", meta_url, "--dedup", "--compress-backend", "cpu"]) == 1
            assert cmd.main(["gc", meta_url, "--dedup"] + CPU) == 0
    finally:
        m.client.close()


@pytest.mark.parametrize("command", ["gc", "fsck"])
def test_unindexed_volume_hashes_on_the_card(tmp_path, capsys, caplog, command):
    """A volume formatted with no hash backend is scanned on the card as
    well: with none, `gc --dedup` and `fsck --verify-data` fail, and only
    an explicit `--hash-backend cpu` hashes on the host."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    meta_url = f"sqlite3://{tmp_path}/plain.db"
    assert cmd.main(["format", meta_url, "plain", "--storage", "file", "--bucket",
                     str(tmp_path / "blob"), "--block-size", str(BS >> 10),
                     "--trash-days", "0"]) == 0
    m, fmt = cmd.open_meta(meta_url)
    m.client.close()
    assert fmt.hash_backend == ""
    argv = [command, meta_url, "--dedup" if command == "gc" else "--verify-data"]
    with caplog.at_level("ERROR", logger="cmd"):
        assert _run(cmd.main, argv + ["--compress-backend", "cpu"], capsys)[0] == 1
    assert any("no CUDA device" in r.getMessage() for r in caplog.records)
    rc, lines = _run(cmd.main, argv + CPU, capsys)
    assert rc == 0
    if command == "gc":
        assert json.loads(lines[-1])["backend"] == "cpu"
    else:
        assert lines[0].startswith("verified 0 blocks (cpu)")
