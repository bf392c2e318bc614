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
import os
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
from tests.test_torch_meta_sql import _close

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
        _close(m)


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


# ------------------------------------ objbench, bench and config (twins) --

def test_objbench(tmp_path, capsys):
    assert cmd.main(["objbench", f"file://{tmp_path}/ob", "--block-size", "1",
                     "--big-object-size", "4", "--small-objects", "8"]) == 0
    out = capsys.readouterr().out
    assert "functional: all checks passed" in out
    assert "hash" not in json.loads(out.strip().splitlines()[-1])  # "": no volume


def test_fs_bench(tmp_path, capsys):
    d = tmp_path / "plain"
    d.mkdir()
    assert cmd.main(["bench", str(d), "--big-file-size", "4",
                     "--small-file-count", "10", "--json"]) == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(results) == ["big_read_MiB_s", "big_write_MiB_s", "small_read_files_s",
                               "small_write_files_s", "stat_files_s"]
    assert all(v > 0 for v in results.values())
    assert list(d.iterdir()) == []  # the bench directory is removed


def test_config_show_and_update(tmp_path, capsys):
    meta_url = _format(tmp_path, "testvol", "none")
    capsys.readouterr()
    assert cmd.main(["config", meta_url]) == 0
    shown = json.loads(capsys.readouterr().out)
    assert shown["name"] == "testvol" and shown["trash_days"] == 0
    assert cmd.main(["config", meta_url, "--trash-days", "7", "--capacity", "5"]) == 0
    assert json.loads(capsys.readouterr().out) == {"updated": ["capacity", "trash_days"]}
    assert cmd.main(["config", meta_url]) == 0
    after = json.loads(capsys.readouterr().out)
    assert after["trash_days"] == 7 and after["capacity"] == 5 << 30
    assert after["uuid"] == shown["uuid"]  # identity preserved across updates


def test_config_hot_reload_reaches_live_client(tmp_path):
    """Another process's `config` change reaches a live client through the
    session refresher."""
    import time as _time

    meta_url = _format(tmp_path, "testvol", "none")
    m, fmt = cmd.open_meta(meta_url)
    m.new_session(heartbeat=0.1)
    try:
        seen = []
        m.on_reload(lambda f: seen.append(f.trash_days))
        assert cmd.main(["config", meta_url, "--trash-days", "9"]) == 0
        deadline = _time.time() + 5
        while _time.time() < deadline and not seen:
            _time.sleep(0.05)
        assert seen and seen[-1] == 9
        assert m.fmt.trash_days == 9
    finally:
        m.close_session()
        m.client.close()


# ------------------------------------ objbench and config vs the reference --

class _Recorder:
    """A BlockIndexer factory that keeps the indexers objbench builds and
    the raw bytes it submits (the payloads are rotations of a random seed
    drawn in the command)."""

    def __init__(self, cls):
        rec = self
        self.built = []

        class Recording(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.raw = {}
                rec.built.append(self)

            def submit_raw(self, sid, indx, bsize, raw):
                self.raw[(sid, indx)] = bytes(raw)
                super().submit_raw(sid, indx, bsize, raw)

        self.cls = Recording


def test_objbench_digests_match_the_spec_and_the_reference(tmp_path, capsys, monkeypatch):
    """`objbench --hash-backend cpu` on both packages hashes the same number
    of blocks; the port's in-memory digests of its payloads are the numpy
    spec's."""
    from juicefs_tpu_torch.chunk import indexer as port_indexer

    rec = _Recorder(port_indexer.BlockIndexer)
    monkeypatch.setattr(port_indexer, "BlockIndexer", rec.cls)
    argv = ["objbench", None, "--block-size", "1", "--big-object-size", "6",
            "--small-objects", "4", "--compress", "lz4", "--hash-backend", "cpu"]
    hashed = {}
    for side, main in (("ref", ref_main), ("port", cmd.main)):
        argv[1] = f"file://{tmp_path}/{side}"
        rc, lines = _run(main, argv, capsys)
        assert rc == 0 and "functional: all checks passed" in lines
        out = json.loads(lines[-1])
        assert out["compress"] == "lz4" and out["functional_failures"] == []
        hashed[side] = {k: out["hash"][k] for k in ("backend", "blocks", "bytes", "errors",
                                                   "dropped")}
    assert hashed["port"] == hashed["ref"] == {"backend": "cpu", "blocks": 6,
                                               "bytes": 6 << 20, "errors": 0, "dropped": 0}
    (ix,) = rec.built
    assert ix.meta is None and sorted(ix.digests) == [(0, i) for i in range(6)]
    raws = [ix.raw[(0, i)] for i in range(6)]
    assert raws[1] == raws[0][1:] + raws[0][:1]  # rotations of one seed
    assert [ix.digests[(0, i)] for i in range(6)] == [jth256(r) for r in raws]


@pytest.mark.parametrize("command", ["objbench", "config"])
def test_device_hash_backend_without_card_never_hashes_on_the_cpu(tmp_path, capsys,
                                                                  monkeypatch, command):
    """`objbench --hash-backend pallas` and `config --hash-backend pallas`
    need the card: with none, objbench exits 1 with no result line,
    config exits 1 with the Format record as it was, and nothing is
    hashed on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from juicefs_tpu_torch.gpu import pipeline

    hashed = []
    real = pipeline.HashPipeline.hash_stream
    monkeypatch.setattr(pipeline.HashPipeline, "hash_stream",
                        lambda self, *a, **kw: hashed.append(1) or real(self, *a, **kw))
    if command == "objbench":
        rc, lines = _run(cmd.main, ["objbench", f"file://{tmp_path}/ob", "--block-size", "1",
                                    "--big-object-size", "4", "--hash-backend", "pallas"],
                         capsys)
        assert rc == 1 and lines == ["functional: all checks passed"]
    else:
        meta_url = _format(tmp_path, "vol", "none")
        before = _run(cmd.main, ["config", meta_url], capsys)[1]
        rc, lines = _run(cmd.main, ["config", meta_url, "--hash-backend", "pallas",
                                    "--trash-days", "3"], capsys)
        assert rc == 1 and lines == []
        assert _run(cmd.main, ["config", meta_url], capsys)[1] == before
        assert json.loads("\n".join(before))["hash_backend"] == "cpu"
    assert hashed == []


def _shown(main, meta_url, capsys) -> dict:
    rc, lines = _run(main, ["config", meta_url], capsys)
    assert rc == 0
    return json.loads("\n".join(lines))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_config_record_reads_back_in_both_packages(tmp_path, capsys, writer):
    """A Format record formatted by one package and rewritten by the other
    package's `config` (the meta_version bump of hash_backend included)
    reads back identically in both."""
    mains = {"port": cmd.main, "ref": ref_main}
    other = "ref" if writer == "port" else "port"
    meta_url = f"sqlite3://{tmp_path}/vol.db"
    assert mains[other](["format", meta_url, "vol", "--storage", "file", "--bucket",
                         str(tmp_path / "blob"), "--trash-days", "0"]) == 0
    capsys.readouterr()
    rc, lines = _run(mains[writer], ["config", meta_url, "--trash-days", "4", "--capacity",
                                     "2", "--inodes", "1000", "--hash-backend", "cpu",
                                     "--enable-acl"], capsys)
    assert rc == 0
    assert json.loads(lines[-1]) == {"updated": ["capacity", "enable_acl", "hash_backend",
                                                 "inodes", "trash_days"]}
    shown = {side: _shown(mains[side], meta_url, capsys) for side in ("port", "ref")}
    assert shown["port"] == shown["ref"]
    assert shown["port"]["hash_backend"] == "cpu" and shown["port"]["meta_version"] >= 2
    assert (shown["port"]["trash_days"], shown["port"]["capacity"],
            shown["port"]["inodes"], shown["port"]["enable_acl"]) == (4, 2 << 30, 1000, True)


def test_cli_has_the_ported_subcommands(capsys):
    """All 27 of the reference's subcommands, `warmup` included, in the
    reference's order, with `create_storage` taking every scheme the
    reference registers."""
    from juicefs_tpu.object import _registry as ref_registry
    from juicefs_tpu_torch.object import _registry, create_storage

    import re

    def choices(main):
        with pytest.raises(SystemExit):
            main(["--help"])
        return re.search(r"\{([a-z,-]+)\}", capsys.readouterr().out)[1].split(",")

    port = choices(cmd.main)
    assert len(port) == 27 and "warmup" in port
    assert port == choices(ref_main)
    assert sorted(_registry) == sorted(ref_registry)
    for uri in ("s3://a:b@127.0.0.1:9/bkt", "minio://127.0.0.1:9/bkt",
                "webdav://127.0.0.1:9/base", "gs://t@127.0.0.1:9/bkt"):
        assert create_storage(uri).string().startswith(uri.split("://")[0].replace(
            "minio", "s3"))


def _sinks():
    """A Pushgateway stand-in (HTTP PUT) and a Graphite one (TCP), each
    keeping every payload it received."""
    import http.server
    import socket
    import threading

    got = {"gateway": [], "graphite": []}
    tcp = socket.socket()
    tcp.bind(("127.0.0.1", 0))
    tcp.listen(8)

    def accept():
        while True:
            try:
                conn, _ = tcp.accept()
            except OSError:
                return
            buf = b""
            while True:
                d = conn.recv(65536)
                if not d:
                    break
                buf += d
            conn.close()
            got["graphite"].append(buf.decode())

    class H(http.server.BaseHTTPRequestHandler):
        def do_PUT(self):  # noqa: N802
            n = int(self.headers.get("Content-Length") or 0)
            got["gateway"].append((self.path, self.rfile.read(n).decode()))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    hs = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=accept, daemon=True).start()
    threading.Thread(target=hs.serve_forever, daemon=True).start()

    def close():
        hs.shutdown()
        hs.server_close()
        tcp.close()

    return got, hs.server_port, tcp.getsockname()[1], close


def _fill(reg) -> None:
    """The same meters, labels and values in either package's registry."""
    reg.gauge("juicefs_test_gauge", "t").set(42)
    reg.counter("juicefs_test_counter", "t").inc(7)
    c = reg.counter("juicefs_test_labeled", "t", ("op", "peer"))
    c.labels("get", "10.0.0.1:7000").inc(3)
    c.labels("put", "a b/c").inc(1.5)
    h = reg.histogram("juicefs_test_seconds", "t", ("group",))
    for v in (0.0002, 0.03, 2.0):
        h.labels("g").observe(v)


def test_metrics_pusher_graphite_and_gateway(monkeypatch):
    """The twin of the reference's drill (Graphite plaintext over TCP and
    a Pushgateway PUT against local listeners, failures only counted),
    and on the same registry contents the port's Pushgateway body and
    Graphite lines equal the reference's (one fixed clock)."""
    import time as _time

    from juicefs_tpu.metric import MetricsPusher as RefMetricsPusher
    from juicefs_tpu.metric import Registry as RefRegistry
    from juicefs_tpu_torch.metric import MetricsPusher, Registry

    monkeypatch.setattr(_time, "time", lambda: 1767322800.0)
    got, hport, gport, close = _sinks()
    try:
        for cls, reg in ((MetricsPusher, Registry()), (RefMetricsPusher, RefRegistry())):
            _fill(reg)
            p = cls(reg, interval=3600, pushgateway=f"http://127.0.0.1:{hport}",
                    graphite=f"127.0.0.1:{gport}", job="test vol")
            p.push_once()
            p.stop()
            assert p.errors == 0 and p.pushes == 1
        deadline = _time.monotonic() + 10
        while len(got["graphite"]) < 2 and _time.monotonic() < deadline:
            _time.sleep(0.01)
    finally:
        close()
    port_gw, ref_gw = got["gateway"]
    assert port_gw == ref_gw and port_gw[0] == "/metrics/job/test%20vol"
    assert "juicefs_test_counter 7" in port_gw[1]
    port_gr, ref_gr = got["graphite"]
    assert port_gr == ref_gr
    assert "juicefs.juicefs_test_gauge 42 1767322800\n" in port_gr
    assert "juicefs.juicefs_test_labeled.put.a_b_c 1.5 1767322800\n" in port_gr

    # failure is silent: dead endpoints only bump the error counter
    p2 = MetricsPusher(Registry(), interval=3600, graphite="127.0.0.1:1",
                       pushgateway="http://127.0.0.1:1")
    p2.push_once()
    p2.stop()
    assert p2.errors == 1 and p2.pushes == 0


@pytest.mark.parametrize("algo", ["", "aes256ctr-rsa"])
@pytest.mark.parametrize("formatter,writer", [("port", "port"), ("port", "ref"),
                                              ("ref", "port")])
def test_encrypted_volume_opens_in_both_packages(tmp_path, capsys, formatter, writer, algo):
    """`format --encrypt-rsa-key` (and `--encrypt-algo aes256ctr-rsa`) by
    either package: a volume written by either opens in the other — the
    raw objects hide the plaintext, and both packages' `fsck
    --verify-data` verify every block against the same digest rows."""
    pytest.importorskip("cryptography", reason="cryptography is not installed")
    from juicefs_tpu_torch.object import generate_rsa_key_pem

    pem = tmp_path / "key.pem"
    pem.write_bytes(generate_rsa_key_pem())
    meta_url = f"sqlite3://{tmp_path}/enc.db"
    bucket = tmp_path / "blob"
    argv = ["format", meta_url, "enc", "--storage", "file", "--bucket", str(bucket),
            "--block-size", str(BS >> 10), "--compress", "lz4", "--hash-backend", "cpu",
            "--trash-days", "0", "--encrypt-rsa-key", str(pem)]
    if algo:
        argv += ["--encrypt-algo", algo]
    assert {"port": cmd.main, "ref": ref_main}[formatter](argv) == 0
    blocks = _plan()
    if writer == "port":
        assert _port_write(meta_url, blocks)["errors"] == 0
    else:
        _ref_vfs_write(meta_url, tmp_path, blocks)
    raw = [open(os.path.join(d, f), "rb").read() for d, _s, fs in os.walk(bucket) for f in fs]
    assert len(raw) >= len(blocks) - 3
    for b in blocks:
        assert not any(b[:4096] in r for r in raw), "plaintext at rest"
    outs = {}
    for side, main, extra in (("port", cmd.main, ["--compress-backend", "cpu",
                                                  "--hash-backend", "cpu"]),
                              ("ref", ref_main, [])):
        rc, outs[side] = _run(main, ["fsck", meta_url, "--verify-data"] + extra, capsys)
        assert rc == 0, (side, outs[side])
    assert outs["port"] == outs["ref"]
    assert outs["port"][0].startswith(f"verified {len(blocks)} blocks")
    assert "0 digest mismatches" in "\n".join(outs["port"])


# ---------------------------------------------------------------------------
# the meta subcommands: status/info/summary/rmr, quota/mdtest, clone,
# restore, destroy through both CLIs on identical volumes


def _meta_volume(tmp_path, scheme: str) -> str:
    """A volume of the port (trash kept a day): the planned blocks in
    /data.bin, and /d holding /d/x."""
    meta_url = f"{scheme}://{tmp_path}/vol.db"
    assert cmd.main(["format", meta_url, "vol", "--storage", "file", "--bucket",
                     str(tmp_path / "blob"), "--block-size", str(BS >> 10),
                     "--compress", "none", "--hash-backend", "cpu", "--trash-days", "1"]) == 0
    stats = _port_write(meta_url, _plan())
    assert stats["errors"] == 0
    m = new_client(meta_url)
    ctx = Context(uid=0, gid=0)
    st, d, _ = m.mkdir(ctx, 1, b"d", 0o755)
    assert st == 0
    st, x, _ = m.create(ctx, d, b"x", 0o600)
    assert st == 0 and m.close(ctx, x) == 0
    _close(m)
    return meta_url


def _json_lines(lines: list[str]):
    text = "\n".join(lines)
    try:
        return json.loads(text)
    except ValueError:
        return [json.loads(ln) for ln in lines]


def _no_volume_paths(doc: dict, tmp_path) -> dict:
    """status with the fields that name the volume's directory or its uuid
    (each side formats its own) blanked out."""
    doc = json.loads(json.dumps(doc).replace(str(tmp_path), "TMP"))
    doc["format"].pop("uuid")
    return doc


@pytest.mark.parametrize("scheme", ["sqlite3", "sql"])
def test_meta_subcommands_match_reference(tmp_path, capsys, scheme):
    out = {}
    for side, main in (("port", cmd.main), ("ref", ref_main)):
        url = _meta_volume(tmp_path / side, scheme)
        res = {}

        def run(*argv, rc=0):
            got, lines = _run(main, list(argv), capsys)
            assert got == rc, (side, argv, lines)
            return lines

        res["status"] = _no_volume_paths(_json_lines(run("status", url)), tmp_path / side)
        res["info"] = _json_lines(run("info", url, "/data.bin"))
        res["summary"] = _json_lines(run("summary", url, "/"))
        res["quota-set"] = run("quota", "set", url, "/d", "--inodes", "50", "--space", "1")
        res["quota-get"] = _json_lines(run("quota", "get", url, "/d"))
        res["quota-list"] = _json_lines(run("quota", "list", url))
        res["quota-check"] = _json_lines(run("quota", "check", url, "/d"))
        res["clone"] = run("clone", url, "/data.bin", "/d/c.bin")
        res["info-clone"] = _json_lines(run("info", url, "/d/c.bin"))
        res["clone-missing"] = run("clone", url, "/nope", "/d/n", rc=1)
        res["rmr"] = run("rmr", url, "/d")
        listing = run("restore", url)
        assert len(listing) == 1, listing  # one trash hour
        res["restore-list"] = listing[0].split(": ")[1]
        res["restore"] = run("restore", url, listing[0].split(":")[0])
        res["summary-after"] = _json_lines(run("summary", url, "/"))
        res["mdtest"] = sorted(_json_lines(run("mdtest", url, "--dirs", "2", "--files", "3",
                                               "--via-vfs")))
        res["summary-end"] = _json_lines(run("summary", url, "/"))
        blob = tmp_path / side / "blob"
        assert any(files for _d, _s, files in os.walk(blob))
        res["destroy-refused"] = run("destroy", url, rc=1)
        res["destroy"] = run("destroy", url, "--yes")
        assert not any(files for _d, _s, files in os.walk(blob)), \
            f"{side}: destroy left objects in the bucket"
        out[side] = res
    port, ref = out["port"], out["ref"]
    assert port.keys() == ref.keys()
    for key in port:
        assert port[key] == ref[key], key
    assert port["info"]["length"] == sum(len(b) for b in _plan())
    assert port["quota-get"]["inode_limit"] == 50
    assert port["quota-check"]["drifted"] is False
    assert port["info-clone"]["chunks"] == port["info"]["chunks"]
    assert port["summary-after"]["files"] == port["summary"]["files"] + 1
    assert "dir_create_per_s" in port["mdtest"] and "vfs_stat_warm_per_s" in port["mdtest"]
    assert port["destroy"][0].startswith("destroyed volume vol: ")


def test_mdtest_via_vfs_touches_no_device(tmp_path, capsys, monkeypatch):
    """`mdtest --via-vfs` builds a throwaway store for the VFS: it stays
    on the host, so no CUDA call is made even where a card could be."""
    url = _format(tmp_path, "md", "none")
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: calls.append(1) or False)
    monkeypatch.setattr(torch.cuda, "init", lambda: calls.append(2))
    rc, lines = _run(cmd.main, ["mdtest", url, "--dirs", "1", "--files", "2", "--via-vfs"],
                     capsys)
    assert rc == 0 and "vfs_stat_cold_per_s" in json.loads(lines[-1])
    assert calls == [] and not torch.cuda.is_initialized()


def test_destroy_removes_content_addressed_blocks(tmp_path, capsys):
    """A volume written with inline dedup keeps one leader object per
    content, which content refs alias: `destroy` deletes every object under
    the volume, leaders included, and the volume's meta is gone."""
    url = _format(tmp_path, "cas", "none")
    blocks = _plan()
    m, fmt = cmd.open_meta(url)
    store = cmd.build_store(fmt, types.SimpleNamespace(compress_backend="cpu", cache_size=1),
                            meta=m)
    store.ingest = IngestPipeline(store, store.content_refs, backend="cpu", device="cpu",
                                  flush_timeout=0.0, bypass=False)
    try:
        ctx = Context(uid=0, gid=0)
        st, ino, _ = m.create(ctx, 1, b"cas.bin", 0o644)
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
        store.flush_all()
        store.ingest.flush()
        assert store.ingest.stats()["put_elided"] == 3
    finally:
        store.close()
        m.client.close()
    m, fmt = cmd.open_meta(url)
    assert sorted(m.scan_content_aliases()) and sorted(m.scan_content_refs())
    objects = sum(1 for _ in cmd.storage_for(fmt).list_all(""))
    m.client.close()
    assert objects >= len(blocks) - 3
    rc, lines = _run(cmd.main, ["destroy", url, "--yes"], capsys)
    assert rc == 0 and lines[-1] == f"destroyed volume cas: {objects} objects removed, " \
        "metadata wiped"
    assert sum(1 for _ in cmd.storage_for(fmt).list_all("")) == 0
    assert cmd.main(["gc", url] + CPU) == 1  # no volume left to collect
