"""The port's Python SDK surface (juicefs_tpu_torch/sdk.py, the `jfs_*`
functions of the libjfs C ABI) and `gc --compact`, against the JAX
package's.

The same `jfs_*` calls go to both packages' SDKs on twin sqlite3:// +
file:// volumes; return values, bytes and errnos must be equal. `jfs_init`
takes only a meta URL, so on a host with no card the volumes are
formatted `--hash-backend cpu --compress none`; a volume that needs the
card makes `jfs_init` fail with -EIO. Then a fragmented file is compacted
by the port's `gc --compact` and by the JAX package's `compact_chunk` on a
twin volume: same bytes, same merged slice layout.
"""

from __future__ import annotations

import errno
import json
import os

import numpy as np
import pytest
import torch

from juicefs_tpu import cmd as ref_cmd
from juicefs_tpu import sdk as ref_sdk
from juicefs_tpu.vfs.compact import compact_chunk as ref_compact_chunk
from juicefs_tpu_torch import cmd as port_cmd
from juicefs_tpu_torch import sdk as port_sdk
from juicefs_tpu_torch.gpu.jth256 import jth256
from juicefs_tpu_torch.vfs import compact as port_compact

BS = 256 << 10
CPU = ["--hash-backend", "cpu", "--compress-backend", "cpu"]


def _format(main, tmp_path, name, compress="none", hash_backend="cpu"):
    url = f"sqlite3://{tmp_path}/{name}.db"
    assert main(["format", url, name, "--storage", "file", "--bucket",
                 str(tmp_path / f"{name}-blob"), "--block-size", str(BS >> 10),
                 "--compress", compress, "--hash-backend", hash_backend,
                 "--trash-days", "0"]) == 0
    return url


def _stat(sdk, mid, path):
    """jfs_stat without the times (each volume stamps its own clock)."""
    out = sdk.jfs_stat(mid, path)
    if isinstance(out, int):
        return out
    size, mode, uid, gid, _a, _m, _c, nlink = out
    return size, mode, uid, gid, nlink


def _session(sdk, url, seed):
    """One seeded SDK session; returns every call's observable result."""
    rng = np.random.default_rng(seed)
    out = []
    mid = sdk.jfs_init(url)
    assert mid > 0
    rec = out.append
    rec(sdk.jfs_mkdir(mid, "/d", 0o755))
    rec(sdk.jfs_mkdir(mid, "/d", 0o755))  # EEXIST
    fd = sdk.jfs_open(mid, "/d/f.bin", os.O_CREAT | os.O_RDWR, 0o644)
    rec(fd > 0)
    data = bytearray()
    for _ in range(12):
        off = int(rng.integers(0, 3 * BS))
        piece = rng.bytes(int(rng.integers(1, BS)))
        rec(sdk.jfs_pwrite(mid, fd, off, piece))
        if len(data) < off + len(piece):
            data.extend(bytes(off + len(piece) - len(data)))
        data[off:off + len(piece)] = piece
        if rng.random() < 0.5:
            rec(sdk.jfs_flush(mid, fd))
        a = int(rng.integers(0, len(data)))
        rec(sdk.jfs_pread(mid, fd, a, int(rng.integers(1, 2 * BS))))
    rec(sdk.jfs_flush(mid, fd))
    rec(sdk.jfs_pread(mid, fd, 0, len(data) + 10) == bytes(data))
    rec(_stat(sdk, mid, "/d/f.bin"))
    rec(sdk.jfs_listdir(mid, "/d"))
    rec(sdk.jfs_close(mid, fd))
    rec(sdk.jfs_rename(mid, "/d/f.bin", "/d/g.bin"))
    rec(sdk.jfs_truncate(mid, "/d/g.bin", BS + 3))
    rec(_stat(sdk, mid, "/d/g.bin"))
    rec(sdk.jfs_rmdir(mid, "/d"))  # ENOTEMPTY
    rec(sdk.jfs_open(mid, "/missing", os.O_RDONLY, 0))  # ENOENT
    rec(_stat(sdk, mid, "/missing"))
    rec(sdk.jfs_pread(mid, 9999, 0, 1))  # EBADF
    rec(sdk.jfs_pwrite(mid, 9999, 0, b"x"))
    rec(sdk.jfs_listdir(mid, "/nope"))
    total, avail, iused, iavail = sdk.jfs_statvfs(mid)
    rec(iused)
    fd = sdk.jfs_open(mid, "/d/g.bin", os.O_RDONLY, 0)
    rec(sdk.jfs_pread(mid, fd, 0, 2 * BS) == bytes(data[:BS + 3]))
    rec(sdk.jfs_pwrite(mid, fd, 0, b"ro"))  # a read-only handle
    rec(sdk.jfs_close(mid, fd))
    rec(sdk.jfs_unlink(mid, "/d/g.bin"))
    rec(sdk.jfs_unlink(mid, "/d/g.bin"))  # ENOENT
    rec(sdk.jfs_rmdir(mid, "/d"))
    rec(sdk.jfs_term(mid))
    rec(sdk.jfs_listdir(mid, "/"))  # EBADF after term
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_sdk_calls_match_reference(tmp_path, seed):
    got = _session(port_sdk, _format(port_cmd.main, tmp_path, "port"), seed)
    want = _session(ref_sdk, _format(ref_cmd.main, tmp_path, "ref"), seed)
    assert got == want
    errnos = {-v for v in got if isinstance(v, int) and not isinstance(v, bool) and v < 0}
    assert errnos >= {errno.EEXIST, errno.ENOENT, errno.ENOTEMPTY, errno.EBADF}


def test_jfs_term_reports_blocks_left_without_a_row(tmp_path, caplog):
    """jfs_term warns with the drained indexer's counts when it left blocks
    without a digest row (the only account a C caller gets), and says
    nothing when every block was hashed."""
    data = np.random.default_rng(3).bytes(3 * BS)
    for fail in (False, True):
        url = _format(port_cmd.main, tmp_path, f"rep{int(fail)}")
        mid = port_sdk.jfs_init(url)
        assert mid > 0
        if fail:
            def refuse(_blocks):
                raise RuntimeError("hash backend unavailable")

            port_sdk._mounts[mid][1].store.indexer._pipe.hash_blocks = refuse
        fd = port_sdk.jfs_open(mid, "/f", os.O_CREAT | os.O_RDWR, 0o644)
        assert port_sdk.jfs_pwrite(mid, fd, 0, data) == len(data)
        assert port_sdk.jfs_flush(mid, fd) == 0
        assert port_sdk.jfs_close(mid, fd) == 0
        caplog.clear()
        with caplog.at_level("WARNING", logger="juicefs_tpu_torch.sdk"):
            assert port_sdk.jfs_term(mid) == 0
        lines = [r.getMessage() for r in caplog.records if r.name == "juicefs_tpu_torch.sdk"]
        if fail:
            assert lines == ["content index at jfs_term: 0 blocks hashed, 0 skipped under "
                             "load, 3 failed (gc --dedup backfills their digests)"]
        else:
            assert lines == []


@pytest.mark.parametrize("volume", ["pallas", "lz4"])
def test_jfs_init_needs_the_card_for_a_device_volume(tmp_path, volume):
    """jfs_init(meta_url) has no way to ask for the CPU: a volume hashed or
    compressed on the card fails with -EIO on a host without one, and
    leaves no session behind."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    if volume == "pallas":
        url = _format(ref_cmd.main, tmp_path, "dev", hash_backend="pallas")
    else:
        url = _format(port_cmd.main, tmp_path, "dev", compress="lz4")
    assert port_sdk.jfs_init(url) == -errno.EIO
    m, _fmt = port_cmd.open_meta(url)
    try:
        assert m.do_list_sessions() == []
    finally:
        m.client.close()


def _fragmented(sdk, url, pieces):
    """One file written as `pieces` flushed in turn: one slice each."""
    mid = sdk.jfs_init(url)
    fd = sdk.jfs_open(mid, "/frag.bin", os.O_CREAT | os.O_RDWR, 0o644)
    for off, piece in pieces:
        assert sdk.jfs_pwrite(mid, fd, off, piece) == len(piece)
        assert sdk.jfs_flush(mid, fd) == 0
    assert sdk.jfs_close(mid, fd) == 0
    assert sdk.jfs_term(mid) == 0


def _chunk(cmd_mod, url):
    m, _fmt = cmd_mod.open_meta(url)
    try:
        st, ino, _attr = m.lookup(_ctx(cmd_mod), 1, b"frag.bin")
        assert st == 0
        st, slices = m.read_chunk(ino, 0)
        assert st == 0
        return ino, [(s.pos, s.id, s.size, s.off, s.len) for s in slices]
    finally:
        m.client.close()


def _ctx(cmd_mod):
    if cmd_mod is port_cmd:
        from juicefs_tpu_torch.meta.context import Context
    else:
        from juicefs_tpu.meta.context import Context
    return Context(uid=0, gid=0)


def _read(sdk, url, n):
    mid = sdk.jfs_init(url)
    fd = sdk.jfs_open(mid, "/frag.bin", os.O_RDONLY, 0)
    data = sdk.jfs_pread(mid, fd, 0, n + 10)
    sdk.jfs_close(mid, fd)
    sdk.jfs_term(mid)
    return data


def test_gc_compact_matches_reference_compact_chunk(tmp_path, capsys):
    """`gc --compact` through the port's CLI merges the fragmented chunk
    into one slice: `compacted 1 chunks`, the same bytes, and the same
    merged slice layout as the JAX package's compact_chunk on a twin
    volume. A `--dedup` in the same run hashes the merged slice's blocks,
    which the content index lacks."""
    rng = np.random.default_rng(7)
    pieces = [(0, rng.bytes(BS + 100)), (BS // 2, rng.bytes(BS)), (3 * BS + 9, rng.bytes(77)),
              (10, rng.bytes(5))]
    size = max(off + len(p) for off, p in pieces)
    urls = {"port": _format(port_cmd.main, tmp_path, "port"),
            "ref": _format(ref_cmd.main, tmp_path, "ref")}
    _fragmented(port_sdk, urls["port"], pieces)
    _fragmented(ref_sdk, urls["ref"], pieces)
    before = {side: _chunk(mod, urls[side]) for side, mod in (("port", port_cmd),
                                                              ("ref", ref_cmd))}
    assert before["port"] == before["ref"] and len(before["port"][1]) == len(pieces)
    want = _read(ref_sdk, urls["ref"], size)
    assert _read(port_sdk, urls["port"], size) == want and len(want) == size

    capsys.readouterr()
    assert port_cmd.main(["gc", urls["port"], "--compact", "--dedup"] + CPU) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "compacted 1 chunks"
    stats = json.loads(lines[-1])
    merged_blocks = -(-size // BS)
    assert stats["hashed_now"] == merged_blocks and stats["from_index"] == 0

    # the JAX package's compact_chunk on the twin volume
    m, fmt = ref_cmd.open_meta(urls["ref"])
    store = ref_cmd.build_store(fmt, None, meta=m, with_indexer=False)
    try:
        assert ref_compact_chunk(m, store, before["ref"][0], 0) is True
    finally:
        store.close()
        m.client.close()
    after = {side: _chunk(mod, urls[side]) for side, mod in (("port", port_cmd),
                                                             ("ref", ref_cmd))}
    assert after["port"] == after["ref"]
    (pos, sid, ssize, off, length), = after["port"][1]
    assert (pos, ssize, off, length) == (0, size, 0, size)
    assert _read(port_sdk, urls["port"], size) == want
    assert _read(ref_sdk, urls["ref"], size) == want
    # the index now holds the merged slice's rows: the spec's digests
    m, _fmt = port_cmd.open_meta(urls["port"])
    try:
        rows = {(s, i): d for s, i, _b, d in m.scan_block_digests()}
    finally:
        m.client.close()
    assert {k: v for k, v in rows.items() if k[0] == sid} == {
        (sid, i): jth256(want[i * BS:(i + 1) * BS]) for i in range(merged_blocks)}
    # nothing left to compact
    capsys.readouterr()
    assert port_cmd.main(["gc", urls["port"], "--compact"] + CPU) == 0
    assert capsys.readouterr().out.splitlines()[0] == "compacted 0 chunks"
    assert port_compact.MIN_SLICES_TO_COMPACT == 2
