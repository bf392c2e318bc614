"""The port's `mount`/`umount`, `dump`/`load` and background jobs
(juicefs_tpu_torch/cmd/mount.py, cmd/dump.py, meta/dump.py, vfs/backup.py)
against the JAX package's.

On the CPU a mount hashes and compresses on the host: the volume is
formatted `--hash-backend cpu` and mounted `--compress-backend cpu`. A
volume whose blocks would be hashed on the card fails to mount on a host
without one, before anything is mounted. `start_mount` is driven
in-process over a SOCK_SEQPACKET socketpair (no /dev/fuse needed); the
`mount` subcommand runs as a process where FUSE is available, and every
such mount is lazily unmounted in `finally`.
"""

import argparse
import dataclasses
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from juicefs_tpu import cmd as ref_cmd
from juicefs_tpu.meta import new_client as ref_new_client
from juicefs_tpu.meta.context import Context as RefContext
from juicefs_tpu.meta.dump import dump_doc as ref_dump_doc
from juicefs_tpu.tpu.jth256 import jth256 as ref_jth256
from juicefs_tpu.vfs import VFS as RefVFS
from juicefs_tpu.vfs.backup import BackgroundJobs as RefBackgroundJobs
from juicefs_tpu.vfs.backup import cleanup_trash as ref_cleanup_trash
from juicefs_tpu_torch import cmd
from juicefs_tpu_torch.cmd import mount as mount_cmd
from juicefs_tpu_torch.fuse import kernel as k
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.meta.dump import dump_doc
from juicefs_tpu_torch.vfs import ROOT_INO, VFS
from juicefs_tpu_torch.vfs.backup import BackgroundJobs, cleanup_trash

from torch_fuse_wire import FuseWire, socketpair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 1 << 20
CTX = Context(uid=0, gid=0, pid=1)
REF_CTX = RefContext(uid=0, gid=0, pid=1)


def _fuse_available() -> bool:
    return os.path.exists("/dev/fuse") and shutil.which("fusermount") is not None


def _format(tmp_path, name: str = "vol", hash_backend: str = "cpu",
            compress: str = "lz4") -> str:
    meta_url = f"sqlite3://{tmp_path}/{name}.db"
    assert cmd.main(["format", meta_url, name, "--storage", "file", "--bucket",
                     str(tmp_path / f"{name}-blob"), "--block-size", str(BS >> 10),
                     "--compress", compress, "--hash-backend", hash_backend,
                     "--trash-days", "0"]) == 0
    return meta_url


def _plan(seed: int):
    """Files of 1 MiB blocks with planted duplicates, and the duplicate
    count: blocks whose bytes an earlier block already had."""
    rng = np.random.default_rng(seed)
    uniq = [rng.bytes(BS) for _ in range(6)]
    order = [0, 1, 2, 0, 3, 1, 4, 0, 5, 2]
    files = {f"f{i}.bin": [uniq[j] for j in order[i * 3:i * 3 + 3]] for i in range(3)}
    files["tail.bin"] = [uniq[order[9]], rng.bytes(BS // 3 + 7)]
    seen, planted = set(), 0
    for blocks in files.values():
        for b in blocks:
            planted += id(b) in seen
            seen.add(id(b))
    return files, planted


def _spec_rows(m, files) -> None:
    """Every index row of every file's blocks equals the numpy spec (the
    JAX package's jth256); each file is one slice."""
    n = 0
    rows = {(sid, indx): d for sid, indx, _b, d in m.scan_block_digests()}
    for name, blocks in files.items():
        st, ino, _ = m.lookup(CTX, ROOT_INO, name.encode())
        assert st == 0, name
        st, slcs = m.read_chunk(ino, 0)
        assert st == 0 and len(slcs) == 1, (name, slcs)
        for i, data in enumerate(blocks):
            assert rows[(slcs[0].id, i)] == ref_jth256(data), (name, i)
            n += 1
    assert n == sum(len(b) for b in files.values())


# ---------------------------------------------------------------------------
# start_mount in-process, over a socketpair


def _parse_mount(argv):
    parser = argparse.ArgumentParser()
    mount_cmd.add_parser(parser.add_subparsers())
    return parser.parse_args(["mount", *argv])


@pytest.fixture
def runtime_dir(tmp_path, monkeypatch):
    """Takeover sockets go under XDG_RUNTIME_DIR: keep them in tmp_path."""
    path = tmp_path / "run"
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(path))
    return str(path)


def _start(args):
    a, b = socketpair()
    mounted = mount_cmd.start_mount(args, fuse_fd=b.fileno())
    t = threading.Thread(target=mounted.srv.serve, daemon=True)
    t.start()
    wire = FuseWire(a)
    wire.check(k.INIT, 0, k.INIT_IN.pack(7, 36, 1 << 20, k.FUSE_BIG_WRITES | k.FUSE_MAX_PAGES))
    return mounted, t, wire, (a, b)


def _stop(mounted, t, ends) -> None:
    ends[0].shutdown(socket.SHUT_RDWR)
    t.join(60)
    assert not t.is_alive()
    mounted.close()
    mounted.meta.client.close()
    for s in ends:
        s.close()


def test_start_mount_over_a_socketpair_elides_planted_duplicates(tmp_path, runtime_dir):
    """`start_mount` with --inline-dedup serves raw FUSE requests: every
    planted duplicate is elided, the index rows equal the spec, a fresh
    mount reads every file back, and `fsck --verify-data` agrees."""
    meta_url = _format(tmp_path)
    files, planted = _plan(1)
    args = _parse_mount([meta_url, str(tmp_path / "mp"), "--inline-dedup", "--no-dedup-bypass",
                         "--compress-backend", "cpu", "--no-watchdog", "--no-bgjobs"])
    mounted, t, wire, ends = _start(args)
    try:
        assert mounted.store.ingest.backend == "cpu"
        assert mounted.store.indexer.backend == "cpu"
        for name, blocks in files.items():
            wire.write_file(name, b"".join(blocks))
        mounted.store.ingest.flush()
        st = mounted.store.ingest.stats()
    finally:
        _stop(mounted, t, ends)
    n_blocks = sum(len(b) for b in files.values())
    assert (st["put_elided"], st["uploaded"], st["passthrough"], st["errors"]) == \
        (planted, n_blocks - planted, 0, 0)
    m, fmt = cmd.open_meta(meta_url)
    try:
        assert sum(1 for _ in cmd.storage_for(fmt).list_all("chunks/")) == n_blocks - planted
        _spec_rows(m, files)
    finally:
        m.client.close()

    mounted, t, wire, ends = _start(args)
    try:
        for name, blocks in files.items():
            assert wire.read_file(name) == b"".join(blocks), name
    finally:
        _stop(mounted, t, ends)
    assert cmd.main(["fsck", meta_url, "--verify-data", "--compress-backend", "cpu"]) == 0


@pytest.mark.parametrize("hash_backend,extra", [("pallas", []), ("", ["--inline-dedup"])],
                         ids=["pallas", "none-inline-dedup"])
def test_start_mount_raises_without_a_card(tmp_path, runtime_dir, hash_backend, extra):
    """A device hash backend (pallas), or --inline-dedup on a volume with
    none, hashes on the card: with no card the store cannot be built and
    nothing is served; the session is closed again."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    meta_url = f"sqlite3://{tmp_path}/dev.db"
    m = new_client(meta_url)
    assert m.init(Format(name="dev", storage="file", bucket=str(tmp_path / "blob"),
                         hash_backend=hash_backend, trash_days=0), force=True) == 0
    m.client.close()
    args = _parse_mount([meta_url, str(tmp_path / "mp"), "--compress-backend", "cpu",
                         "--no-watchdog", *extra])
    a, b = socketpair()
    try:
        with pytest.raises(RuntimeError, match="(?i)cuda|card|gpu"):
            mount_cmd.start_mount(args, fuse_fd=b.fileno())
    finally:
        a.close()
        b.close()
    m = new_client(meta_url)
    assert m.load().hash_backend == hash_backend
    assert list(m.do_list_sessions()) == []
    m.client.close()


@pytest.mark.parametrize("served,unmounted,force,rc,stops", [
    (True, True, False, 0, True),
    (True, True, True, 0, False),
    (True, False, False, 1, False),
    (False, True, False, 0, False),
], ids=["served", "served-lazy", "refused", "unserved"])
def test_umount_tells_the_serving_process_its_mount_is_gone(tmp_path, runtime_dir, monkeypatch,
                                                           served, unmounted, force, rc, stops):
    """A FUSE device may not tell the serving process of an unmount made
    by another one (gVisor's keeps the connection open), so a plain
    `umount` that succeeded tells the server over its control socket and
    the request loops stop. A lazy one does not (the detached mount still
    serves the files left open); a refused one exits 1 and leaves the
    server serving; with no server listening, `umount` still exits 0."""
    import importlib

    fuse_mount = importlib.import_module("juicefs_tpu_torch.fuse.mount")
    monkeypatch.setattr(fuse_mount, "umount", lambda mountpoint, lazy=True: unmounted)
    mp = str(tmp_path / "mp")
    umount_args = argparse.Namespace(mountpoint=mp, force=force)
    if not served:
        assert mount_cmd.run_umount(umount_args) == rc
        return
    meta_url = _format(tmp_path)
    args = _parse_mount([meta_url, mp, "--compress-backend", "cpu", "--no-watchdog",
                         "--no-bgjobs"])
    mounted, t, wire, (a, b) = _start(args)
    try:
        assert mount_cmd.run_umount(umount_args) == rc
        t.join(10 if stops else 1)
        assert t.is_alive() != stops
        assert mounted.srv._stop.is_set() == stops
    finally:
        a.shutdown(socket.SHUT_RDWR)
        t.join(10)
        mounted.close()
        mounted.meta.client.close()
        a.close()
        if mounted.srv._fd == b.fileno():
            b.close()
        else:
            b.detach()  # the server closed its end once its loops stopped


# ---------------------------------------------------------------------------
# the mount subcommand as a process


def _mount_proc(meta_url, mp, *extra, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "juicefs_tpu_torch.cmd", "mount", meta_url, str(mp),
         "--no-watchdog", *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)


def _is_fuse_mount(mp) -> bool:
    with open("/proc/mounts") as f:
        return any(line.split()[1] == str(mp) and "fuse" in line.split()[2] for line in f)


def _wait_mounted(mp, proc, timeout: float = 60.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline and proc.poll() is None:
        try:
            if _is_fuse_mount(mp) and os.statvfs(mp).f_namemax:
                return True
        except OSError:
            pass
        time.sleep(0.1)
    return False


def _stop_proc(mp, *procs) -> None:
    subprocess.run(["fusermount", "-u", "-z", str(mp)], capture_output=True, timeout=30)
    for p in procs:
        if p is None:
            continue
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.send_signal(signal.SIGTERM)
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        if p.stdout is not None:
            p.stdout.close()


def _stats(mp, name: str) -> float:
    for line in open(os.path.join(mp, ".stats")).read().splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return 0.0


def test_mount_process_inline_dedup_matches_reference_gc(tmp_path, capsys, runtime_dir):
    """`python -m juicefs_tpu_torch.cmd mount --inline-dedup` elides the
    planted duplicates written through the kernel; after `umount` the index
    rows equal the spec, and the JAX package's `gc --dedup` on the same
    volume finds the same duplicate groups as the port's."""
    if not _fuse_available():
        pytest.skip("FUSE not available: needs /dev/fuse and fusermount")
    meta_url = _format(tmp_path)
    mp = tmp_path / "mnt"
    mp.mkdir()
    files, planted = _plan(2)
    p = _mount_proc(meta_url, mp, "--inline-dedup", "--no-dedup-bypass",
                    "--compress-backend", "cpu", "--no-kernel-writeback")
    try:
        assert _wait_mounted(mp, p), p.poll()
        before = _stats(mp, "juicefs_ingest_put_elided")
        for name, blocks in files.items():
            with open(mp / name, "wb") as f:
                for b in blocks:
                    f.write(b)
                f.flush()
                os.fsync(f.fileno())
        assert _stats(mp, "juicefs_ingest_put_elided") - before == planted
        assert (mp / "f1.bin").read_bytes() == b"".join(files["f1.bin"])
        rc = subprocess.run([sys.executable, "-m", "juicefs_tpu_torch.cmd", "umount", str(mp)],
                            cwd=REPO, timeout=60).returncode
        assert rc == 0
        assert p.wait(timeout=60) == 0
    finally:
        _stop_proc(mp, p)
    assert not _is_fuse_mount(mp)

    m, _fmt = cmd.open_meta(meta_url)
    _spec_rows(m, files)
    m.client.close()
    out = {}
    for side, main, extra in (("port", cmd.main, ["--compress-backend", "cpu"]),
                              ("ref", ref_cmd.main, [])):
        index = tmp_path / f"{side}-dedup.json"
        capsys.readouterr()
        assert main(["gc", meta_url, "--dedup", "--dedup-index", str(index)] + extra) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        out[side] = ({key: stats[key] for key in ("duplicate_blocks", "dedup_groups",
                                                   "blocks", "content_refs")},
                     json.loads(index.read_text()))
    assert out["port"] == out["ref"]
    assert out["port"][0]["duplicate_blocks"] == planted


@pytest.mark.parametrize("hash_backend,extra", [("pallas", []), ("", ["--inline-dedup"])],
                         ids=["pallas", "none-inline-dedup"])
def test_mount_process_fails_without_a_card(tmp_path, runtime_dir, hash_backend, extra):
    """No silent CPU: the mount process exits non-zero and the mountpoint
    is never mounted."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    meta_url = f"sqlite3://{tmp_path}/dev.db"
    m = new_client(meta_url)
    assert m.init(Format(name="dev", storage="file", bucket=str(tmp_path / "blob"),
                         hash_backend=hash_backend, trash_days=0), force=True) == 0
    m.client.close()
    mp = tmp_path / "mnt"
    mp.mkdir()
    p = _mount_proc(meta_url, mp, "--compress-backend", "cpu", *extra)
    try:
        out, _ = p.communicate(timeout=120)
        assert p.returncode != 0, out
        assert "cuda" in out.lower() or "card" in out.lower(), out
        assert not _is_fuse_mount(mp)
    finally:
        _stop_proc(mp, p)


def test_open_fd_survives_takeover(tmp_path, runtime_dir):
    """A second port mount process takes over the live FUSE fd, the open
    handles and the session from the first: the application's fd keeps
    working across the swap."""
    if not _fuse_available():
        pytest.skip("FUSE not available: needs /dev/fuse and fusermount")
    meta_url = _format(tmp_path, compress="none")
    mp = tmp_path / "mnt"
    mp.mkdir()
    p1 = _mount_proc(meta_url, mp, "--compress-backend", "cpu")
    p2 = None
    fd = -1
    try:
        assert _wait_mounted(mp, p1)
        fd = os.open(str(mp / "survivor.txt"), os.O_RDWR | os.O_CREAT, 0o644)
        os.write(fd, b"written-before-upgrade\n")
        os.fsync(fd)
        p2 = _mount_proc(meta_url, mp, "--compress-backend", "cpu", "--takeover")
        out1, _ = p1.communicate(timeout=60)  # the old process exits cleanly
        assert p1.returncode == 0, out1
        assert _wait_mounted(mp, p2)
        os.write(fd, b"written-after-upgrade\n")
        os.fsync(fd)
        os.lseek(fd, 0, os.SEEK_SET)
        assert os.read(fd, 4096) == b"written-before-upgrade\nwritten-after-upgrade\n"
        (mp / "post-upgrade.txt").write_bytes(b"fresh")
        assert (mp / "post-upgrade.txt").read_bytes() == b"fresh"
        assert sorted(os.listdir(mp)) == ["post-upgrade.txt", "survivor.txt"]
    finally:
        if fd >= 0:
            os.close(fd)
        _stop_proc(mp, p1, p2)


def test_importing_mount_leaves_cuda_uninitialised():
    """`mount -d` forks twice before the worker builds its store: nothing
    on that way may initialise CUDA (importing and parsing included)."""
    code = ("import torch, argparse\n"
            "from juicefs_tpu_torch.cmd import mount, main\n"
            "p = argparse.ArgumentParser(); mount.add_parser(p.add_subparsers())\n"
            "p.parse_args(['mount', 'sqlite3:///x.db', '/mp', '-d', '--inline-dedup'])\n"
            "print(torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False"


# ---------------------------------------------------------------------------
# the cmd plumbing against the reference's


@pytest.mark.parametrize("argv", [
    ["sqlite3:///m.db", "/mnt/jfs", "-o", "ro,defaults,cache-size=512,writeback,_netdev"],
    ["redis://h/1", "/jfs", "-o", "background,inline_dedup,no_usage_report"],
    ["sqlite3:///m.db", "/jfs", "-s", "-f", "-o", "rw,compress-backend=cpu,upload_limit=80"],
    ["mem://", "/jfs"],
])
def test_fstab_shim_matches_reference(argv):
    assert cmd.fstab_shim(argv) == ref_cmd.fstab_shim(argv)


_OPTIONS = {
    "cache_dir": "/tmp/a:/tmp/b", "cache_size": 64, "writeback": True, "upload_limit": 80.0,
    "download_limit": 8.0, "op_deadline": 7.5, "attempt_timeout": 2.5, "no_hedge": True,
    "compress_lanes": 3, "no_dedup_bypass": True,
}


@pytest.mark.parametrize("option", sorted(_OPTIONS) + ["all"])
def test_chunk_conf_matches_reference(option):
    """Every mount option the port's chunk_conf reads sets the same
    ChunkConfig fields as the reference's."""
    from juicefs_tpu.meta.types import Format as RefFormat

    opts = dict(_OPTIONS) if option == "all" else {option: _OPTIONS[option]}
    args = types.SimpleNamespace(compress_backend="cpu", **opts)
    port = cmd.chunk_conf(Format(name="v", block_size=1024, compression="lz4"), args)
    ref = ref_cmd.chunk_conf(RefFormat(name="v", block_size=1024, compression="lz4"), args)
    fields = [f.name for f in dataclasses.fields(ref)]
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}


# ---------------------------------------------------------------------------
# dump / load and the background jobs


def _port_vfs(meta_url, tmp_path, n=0):
    m, fmt = cmd.open_meta(meta_url)
    m.new_session()
    store = cmd.build_store(fmt, types.SimpleNamespace(
        compress_backend="cpu", cache_dir=str(tmp_path / f"c{n}")), meta=m)
    return VFS(m, store, fmt=fmt)


def _ref_vfs(meta_url, tmp_path, n=0):
    m, fmt = ref_cmd.open_meta(meta_url)
    m.new_session()
    store = ref_cmd.build_store(fmt, types.SimpleNamespace(
        cache_dir=str(tmp_path / f"r{n}"), writeback=False, cache_size=0), meta=m)
    return RefVFS(m, store, fmt=fmt)


def _close(v) -> None:
    v.close()
    v.store.close()
    v.meta.close_session()
    v.meta.client.close()  # one sqlite file, two packages: one client at a time


def _populate(v, ctx, seed: int) -> None:
    rng = np.random.default_rng(seed)
    st, dino, _ = v.mkdir(ctx, ROOT_INO, b"dir", 0o755)
    assert st == 0
    for i, parent in enumerate((ROOT_INO, dino, dino)):
        st, ino, _, fh = v.create(ctx, parent, b"f%d" % i, 0o644)
        assert st == 0
        assert v.write(ctx, ino, fh, 0, rng.bytes(int(rng.integers(1, 3 * BS)))) == 0
        assert v.release(ctx, ino, fh) == 0
    assert v.setxattr(ctx, dino, b"user.k", b"v", 0) == 0


def test_dump_doc_matches_reference(tmp_path):
    """The same sqlite3:// volume dumps to the same document through either
    package (one client closed before the other opens the file)."""
    meta_url = _format(tmp_path, hash_backend="cpu")
    v = _port_vfs(meta_url, tmp_path)
    _populate(v, CTX, 3)
    _close(v)
    m = new_client(meta_url)
    m.load()
    port = dump_doc(m)
    m.client.close()
    rm = ref_new_client(meta_url)
    rm.load()
    ref = ref_dump_doc(rm)
    rm.client.close()
    assert port == ref
    assert port["engine"] == "sqlite3" and len(port["records"]) > 10


def test_dump_load_roundtrip(tmp_path, capsys):
    meta_url = _format(tmp_path, compress="none")
    v = _port_vfs(meta_url, tmp_path)
    st, ino, _, fh = v.create(CTX, ROOT_INO, b"keep.bin", 0o644)
    assert v.write(CTX, ino, fh, 0, b"payload!") == 0
    v.release(CTX, ino, fh)
    assert v.mkdir(CTX, ROOT_INO, b"dir", 0o755)[0] == 0
    _close(v)
    dump_file = str(tmp_path / "dump.json")
    assert cmd.main(["dump", meta_url, dump_file]) == 0
    meta2 = f"sqlite3://{tmp_path}/meta2.db"
    assert cmd.main(["load", meta2, dump_file]) == 0
    assert "loaded" in capsys.readouterr().out
    assert cmd.main(["load", meta2, dump_file]) == 1  # not empty: needs --force
    assert cmd.main(["load", meta2, dump_file, "--force"]) == 0
    v2 = _port_vfs(meta2, tmp_path, 2)
    try:
        st, ino, attr = v2.lookup(CTX, ROOT_INO, b"keep.bin")
        assert st == 0 and attr.length == 8
        st, attr, fh = v2.open(CTX, ino, os.O_RDONLY)
        assert v2.read(CTX, ino, fh, 0, 8) == (0, b"payload!")
        v2.release(CTX, ino, fh)
        assert v2.lookup(CTX, ROOT_INO, b"dir")[0] == 0
    finally:
        _close(v2)


def _trash_volume(tmp_path, name: str) -> str:
    meta_url = f"sqlite3://{tmp_path}/{name}.db"
    assert cmd.main(["format", meta_url, name, "--storage", "file", "--bucket",
                     str(tmp_path / f"{name}-blob"), "--block-size", "64", "--compress",
                     "none", "--hash-backend", "cpu"]) == 0  # trash_days 1
    return meta_url


def test_background_jobs_and_trash_match_reference(tmp_path):
    """The same steps on two identical volumes: BackgroundJobs.run_once
    and cleanup_trash give the same stats in both packages, and the
    backup lands under meta/ in both."""
    out = {}
    for side, open_vfs, jobs, cleanup, ctx in (
            ("port", _port_vfs, BackgroundJobs, cleanup_trash, CTX),
            ("ref", _ref_vfs, RefBackgroundJobs, ref_cleanup_trash, REF_CTX)):
        meta_url = _trash_volume(tmp_path, side)
        v = open_vfs(meta_url, tmp_path)
        try:
            _populate(v, ctx, 5)
            assert v.unlink(ctx, ROOT_INO, b"f0") == 0  # into the trash
            bg = jobs(v.meta, v.store, interval=3600)
            assert bg._elect()
            stats = bg.run_once()
            backup = stats.pop("backup")
            assert backup.startswith("meta/dump-") and backup.endswith(".json.gz")
            fresh = cleanup(v.meta, v.meta.fmt.trash_days)
            expired = cleanup(v.meta, -1)
            again = bg.run_once()
            out[side] = (stats, fresh, expired, again)
        finally:
            _close(v)
    assert out["port"] == out["ref"]
    assert out["port"][1:3] == (0, 2)  # the hour dir and the file in it


# ---------------------------------------------------------------------------
# --meta-replica, and the meta subcommands on a live mount


def _replica_reads() -> int:
    from juicefs_tpu_torch.meta.cache import _REPLICA_READS

    return _REPLICA_READS.value


def test_meta_replica_reads_reach_the_replica(tmp_path, runtime_dir):
    """`mount --meta-replica` on a redis:// volume served by the port's
    meta-server and its read replica: files written before the mount
    read back through FUSE with their lookups and attrs served by the
    replica, and the mount's client routes reads there."""
    from juicefs_tpu_torch.meta.redis_kv import RedisKV, RespConnection
    from juicefs_tpu_torch.meta.redis_server import RedisServer

    pri = RedisServer()
    pport = pri.start()
    rep = RedisServer(replica_of=f"127.0.0.1:{pport}")
    rport = rep.start()
    meta_url = f"redis://127.0.0.1:{pport}/1"
    try:
        assert cmd.main(["format", meta_url, "rep", "--storage", "file", "--bucket",
                         str(tmp_path / "blob"), "--block-size", str(BS >> 10),
                         "--compress", "none", "--hash-backend", "cpu",
                         "--trash-days", "0"]) == 0
        files, _ = _plan(3)
        writer = _parse_mount([meta_url, str(tmp_path / "w"), "--compress-backend", "cpu",
                               "--no-watchdog", "--no-bgjobs"])
        mounted, t, wire, ends = _start(writer)
        try:
            for name, blocks in files.items():
                wire.write_file(name, b"".join(blocks))
        finally:
            _stop(mounted, t, ends)

        def epoch(port):
            conn = RespConnection("127.0.0.1", port, db=1)
            try:
                return int(conn.execute(b"GET", RedisKV.EPOCH_KEY) or 0)
            finally:
                conn.close()

        target = epoch(pport)
        deadline = time.time() + 30
        while epoch(rport) < target:
            assert time.time() < deadline, "the replica never caught up"
            time.sleep(0.05)

        args = _parse_mount([meta_url, str(tmp_path / "mp"), "--meta-replica",
                             f"127.0.0.1:{rport}", "--compress-backend", "cpu",
                             "--no-watchdog", "--no-bgjobs"])
        assert args.meta_replica == f"127.0.0.1:{rport}"
        mounted, t, wire, ends = _start(args)
        try:
            assert mounted.meta.replica_available()
            before = _replica_reads()
            for name, blocks in files.items():
                assert wire.read_file(name) == b"".join(blocks), name
            assert _replica_reads() > before
        finally:
            _stop(mounted, t, ends)
    finally:
        rep.stop()
        pri.stop()


def test_meta_subcommands_on_a_mounted_volume(tmp_path, runtime_dir, capsys):
    """The `mount` subcommand as a process; then `clone` given the
    mountpoint goes through the mount's `.control` file (no object
    added, the clone reads back through the kernel), and `stats`,
    `debug` and `profile` read the mount's virtual files, the port's
    CLI and the reference's alike."""
    if not _fuse_available():
        pytest.skip("FUSE not available: needs /dev/fuse and fusermount")
    meta_url = _format(tmp_path, compress="none")
    mp = tmp_path / "mp"
    mp.mkdir()
    proc = _mount_proc(meta_url, mp, "--compress-backend", "cpu", "--no-bgjobs")
    try:
        if not _wait_mounted(mp, proc):
            pytest.skip(f"cannot mount: {proc.stdout.read() if proc.poll() is not None else ''}")
        data = np.random.default_rng(9).bytes(BS + 777)
        (mp / "d").mkdir()
        with open(mp / "f.bin", "wb") as f:
            f.write(data)
        m, fmt = cmd.open_meta(meta_url)
        n_objects = sum(1 for _ in cmd.storage_for(fmt).list_all("chunks/"))
        capsys.readouterr()
        assert cmd.main(["clone", str(mp), "/f.bin", "/d/g.bin"]) == 0
        assert capsys.readouterr().out.startswith("cloned /f.bin -> /d/g.bin (inode ")
        with open(mp / "d" / "g.bin", "rb") as f:
            assert f.read() == data
        assert sum(1 for _ in cmd.storage_for(fmt).list_all("chunks/")) == n_objects
        m.client.close()
        assert cmd.main(["clone", str(mp), "/missing", "/d/x"]) == 1

        lines = {}
        for side, main in (("port", cmd.main), ("ref", ref_cmd.main)):
            capsys.readouterr()
            assert main(["stats", str(mp), "--filter", "^juicefs_torch_"]) == 0
            lines[side] = capsys.readouterr().out.splitlines()
            assert main(["debug", str(mp), "--out", str(tmp_path / f"debug-{side}")]) == 0
            assert main(["profile", str(mp), "--duration", "0.2"]) == 0
        names = {side: {ln.split()[0] for ln in ls} for side, ls in lines.items()}
        assert names["port"] and names["port"] == names["ref"]
        assert sorted(os.listdir(tmp_path / "debug-port")) == \
            sorted(os.listdir(tmp_path / "debug-ref")) == ["config.txt", "stats.txt", "statvfs.txt"]
    finally:
        _stop_proc(mp, proc)


# ---------------------------------------------------------------------------
# the cache group and the metrics pusher on a mount


def _push_sink():
    """A Pushgateway stand-in: keeps every PUT body."""
    import http.server

    bodies = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_PUT(self):  # noqa: N802
            bodies.append(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    hs = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=hs.serve_forever, daemon=True).start()
    return hs, bodies


def test_mount_accepts_the_cache_group_and_push_flags():
    """The six flags the reference's mount takes, parsed as there."""
    from juicefs_tpu.cmd import mount as ref_mount_cmd

    argv = ["sqlite3:///x.db", "/mp", "--cache-group", "g", "--group-weight", "3",
            "--group-listen", "0.0.0.0:7000", "--metrics-push", "http://h:9091",
            "--graphite", "h:2003", "--push-interval", "2.5"]
    port = _parse_mount(argv)
    p = argparse.ArgumentParser()
    ref_mount_cmd.add_parser(p.add_subparsers())
    ref = p.parse_args(["mount", *argv])
    keys = ("cache_group", "group_weight", "group_listen", "metrics_push", "graphite",
            "push_interval")
    assert {k: getattr(port, k) for k in keys} == {k: getattr(ref, k) for k in keys} == {
        "cache_group": "g", "group_weight": 3, "group_listen": "0.0.0.0:7000",
        "metrics_push": "http://h:9091", "graphite": "h:2003", "push_interval": 2.5}


def test_cache_group_members_serve_each_other(tmp_path, runtime_dir, monkeypatch):
    """Two members of one volume mounted with --cache-group: each
    publishes its peer address in its session, the second discovers the
    first through the meta sessions, and its cold reads of the first's
    file are served by the first's peer server with zero object-store
    GETs. The first also pushes the port's registry to a Pushgateway
    every --push-interval; Mounted.close() stops the peer server and the
    pusher."""
    from juicefs_tpu_torch.metric import global_registry
    from juicefs_tpu_torch.object.file import FileStorage
    from juicefs_tpu_torch.vfs.internal import STATUS_INO

    meta_url = _format(tmp_path, compress="lz4")
    hs, bodies = _push_sink()
    common = ["--cache-group", "train", "--compress-backend", "cpu", "--no-watchdog",
              "--no-bgjobs", "--heartbeat", "1"]
    a = _start(_parse_mount([meta_url, str(tmp_path / "mpa"), "--cache-dir",
                             str(tmp_path / "ca"), "--metrics-push",
                             f"http://127.0.0.1:{hs.server_port}", "--push-interval", "0.2",
                             *common]))
    b = None
    try:
        ma = a[0]
        assert ma.peer_srv is not None and ma.pusher is not None
        addr_a = ma.peer_srv.addr
        blob = np.random.default_rng(9).bytes(3 * BS + 12345)
        v = ma.vfs
        st, ino, _, fh = v.create(CTX, ROOT_INO, b"shared.bin", 0o644)
        assert st == 0 and v.write(CTX, ino, fh, 0, blob) == 0
        assert v.flush(CTX, ino, fh) == 0 and v.release(CTX, ino, fh) == 0
        ma.store.flush_all()
        st, slices = ma.meta.read_chunk(ino, 0)
        deadline = time.monotonic() + 30
        while sum(ma.store.check_cache(s.id, s.size) for s in slices if s.id) < 4:
            assert time.monotonic() < deadline, "A's cache never held the file"
            time.sleep(0.01)

        b = _start(_parse_mount([meta_url, str(tmp_path / "mpb"), "--cache-dir",
                                 str(tmp_path / "cb"), "--group-weight", "2", *common]))
        mb = b[0]
        addr_b = mb.peer_srv.addr
        sessions = {s.peer_addr: s for s in mb.meta.do_list_sessions() if s.peer_addr}
        assert {k: (s.cache_group, s.group_weight) for k, s in sessions.items()} == {
            addr_a: ("train", 1), addr_b: ("train", 2)}
        assert mb.store.cache_group.ring.members == {addr_a: 1, addr_b: 2}
        mb.vfs.internal.open(STATUS_INO, 5)
        status = json.loads(mb.vfs.internal.read(STATUS_INO, 5, 0, 1 << 20)[1])
        assert status["cache_group"]["members"] == {addr_a: 1, addr_b: 2}

        gets = []
        real = FileStorage.get
        monkeypatch.setattr(FileStorage, "get",
                            lambda self, k, off=0, limit=-1: gets.append(k) or real(self, k, off, limit))
        hits = global_registry()._metrics["juicefs_cache_group_peer_hits"]
        h0 = hits.value
        st, ino_b, _ = mb.vfs.lookup(CTX, ROOT_INO, b"shared.bin")
        st, _, fh_b = mb.vfs.open(CTX, ino_b, os.O_RDONLY)
        st, got = mb.vfs.read(CTX, ino_b, fh_b, 0, len(blob))
        mb.vfs.release(CTX, ino_b, fh_b)
        assert st == 0 and bytes(got) == blob
        assert [k for k in gets if "chunks/" in k] == []
        assert hits.value - h0 == 4
        deadline = time.monotonic() + 30
        while not any(b"juicefs_cache_group_peer_hits" in body for body in bodies):
            assert time.monotonic() < deadline, "no push reached the Pushgateway"
            time.sleep(0.05)
    finally:
        for side in (b, a):
            if side is not None:
                _stop(side[0], side[1], side[3])
        hs.shutdown()
        hs.server_close()
    assert not a[0].pusher._thread.is_alive() and a[0].peer_srv._httpd is None
