"""The port's `sync` (juicefs_tpu_torch/cmd/sync.py) against the JAX
package's.

First the cases of tests/test_sync_cluster.py and `test_sync_and_check` of
tests/test_cmd.py run on the port: ranged multipart copies, the manager
with two worker processes, bootstrapped workers (the default local launch
and a --worker-launch template), a dead launch failing the manager,
--bwlimit, and S3 -> WebDAV through the port's two gateways. Every
subprocess runs `python -m juicefs_tpu_torch.cmd`.

Then the two changes from the JAX package's copy: bootstrapped workers run
the port's CLI, and a worker that reaches a finished manager exits 0 with
zero tasks while a worker that dies mid-batch still fails the sync. Last,
both packages' `sync` of one seeded file:// tree give identical
destination trees and stats, also with --check-all after a planted
same-size corruption. Tolerance: byte-identical.
"""

import json
import os
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest

from juicefs_tpu.cmd import main as ref_main
from juicefs_tpu_torch.cmd import main
from juicefs_tpu_torch.cmd import sync as port_sync
from juicefs_tpu_torch.object import create_storage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLI = [sys.executable, "-m", "juicefs_tpu_torch.cmd"]


def _fill(root, objs):
    for rel, data in objs.items():
        p = os.path.join(root, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, root)
            if rel.startswith(".uploads"):
                continue
            with open(p, "rb") as f:
                out[rel] = f.read()
    return out


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _manager(src, dst, *extra) -> tuple[subprocess.Popen, str]:
    mgr = subprocess.Popen(
        [*PORT_CLI, "sync", f"file://{src}", f"file://{dst}",
         "--manager-listen", "127.0.0.1:0", *extra],
        stdout=subprocess.PIPE, text=True, cwd=REPO)
    return mgr, json.loads(mgr.stdout.readline())["manager"]


# ------------------------------------------ tests/test_sync_cluster.py --

def test_multipart_copy_uses_ranged_parts(tmp_path):
    """An object over the threshold moves via ranged part GETs, never a
    whole-object load (constant memory per worker)."""
    src_root, dst_root = tmp_path / "src", tmp_path / "dst"
    src_root.mkdir(), dst_root.mkdir()
    big = os.urandom(5 << 20)
    _fill(str(src_root), {"big.bin": big})
    src = create_storage(f"file://{src_root}")
    dst = create_storage(f"file://{dst_root}")
    max_get = [0]
    real_get = src.get

    def spy_get(key, off=0, limit=-1):
        data = real_get(key, off, limit)
        max_get[0] = max(max_get[0], len(bytes(data)))
        return data

    src.get = spy_get
    args = types.SimpleNamespace(big_threshold=1, part_size=1)  # 1 MiB / 1 MiB
    stats = port_sync._new_stats()
    obj = next(o for o in src.list_all("") if o.key == "big.bin")
    port_sync._copy_object(src, dst, obj, args, stats)
    assert (dst_root / "big.bin").read_bytes() == big
    assert stats["copied_bytes"] == len(big)
    assert max_get[0] <= 1 << 20  # never loaded more than one part


def test_sync_big_threshold_end_to_end(tmp_path, capsys):
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    blob = os.urandom(3 << 20)
    _fill(str(src), {"a/big.bin": blob, "small.txt": b"tiny"})
    rc = main(["sync", f"file://{src}", f"file://{dst}",
               "--big-threshold", "1", "--part-size", "1", "--check-new"])
    assert rc == 0
    stats = _last_json(capsys.readouterr().out)
    assert stats["copied"] == 2 and stats["mismatch"] == 0
    assert _tree(str(dst)) == {"a/big.bin": blob, "small.txt": b"tiny"}


def test_cluster_mode_two_workers(tmp_path):
    """The manager serves the diff over HTTP; two worker processes drain it
    and the union of their work covers the keyspace."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    objs = {f"d{i % 4}/f{i:03d}": os.urandom(256 + i) for i in range(600)}
    _fill(str(src), objs)
    mgr, addr = _manager(src, dst)
    try:
        workers = [
            subprocess.Popen(
                [*PORT_CLI, "sync", f"file://{src}", f"file://{dst}",
                 "--worker", "--manager", addr, "--threads", "4"],
                stdout=subprocess.PIPE, text=True, cwd=REPO)
            for _ in range(2)
        ]
        wstats = []
        for w in workers:
            out, _ = w.communicate(timeout=60)
            assert w.returncode == 0, out
            wstats.append(_last_json(out))
        out, _ = mgr.communicate(timeout=30)
        totals = _last_json(out)
    finally:
        mgr.kill()
    assert mgr.returncode == 0
    assert _tree(str(dst)) == objs
    assert totals["copied"] == len(objs)
    # a worker that arrives after the queue drained gets zero tasks
    assert sum(s["copied"] for s in wstats) == len(objs)
    assert all(s["mismatch"] == 0 and s["skipped"] == 0 for s in wstats)


def test_cluster_bootstrap_local_two_workers(tmp_path):
    """--worker-hosts launches the workers as local subprocesses and the
    sync completes end to end."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    objs = {f"d{i % 3}/f{i:03d}": os.urandom(128 + i) for i in range(400)}
    _fill(str(src), objs)
    p = subprocess.run(
        [*PORT_CLI, "sync", f"file://{src}", f"file://{dst}",
         "--manager-listen", "127.0.0.1:0",
         "--worker-hosts", "localhost,localhost", "--threads", "4"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert p.returncode == 0, p.stdout + p.stderr
    totals = _last_json(p.stdout)
    assert totals["copied"] == len(objs)
    assert totals["tasks_done"] == totals["dispatched"] == len(objs)
    assert _tree(str(dst)) == objs


def test_cluster_bootstrap_launch_template(tmp_path):
    """--worker-launch substitutes {host} and {cmd} and runs through the
    shell (the 'ssh {host} {cmd}' shape, with env as the transport)."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    objs = {f"f{i:02d}": os.urandom(64 + i) for i in range(40)}
    _fill(str(src), objs)
    p = subprocess.run(
        [*PORT_CLI, "sync", f"file://{src}", f"file://{dst}",
         "--manager-listen", "127.0.0.1:0", "--worker-hosts", "hostA",
         "--worker-launch",
         f"env WORKER_HOST={{host}} {sys.executable} -m juicefs_tpu_torch.cmd {{cmd}}"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert p.returncode == 0, p.stdout + p.stderr
    assert _last_json(p.stdout)["copied"] == len(objs)
    assert _tree(str(dst)) == objs


def test_cluster_bootstrap_dead_worker_fails_manager(tmp_path):
    """A bootstrapped worker that cannot run (broken launch template) fails
    the sync, never a silent partial one."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    _fill(str(src), {"a": b"x"})
    p = subprocess.run(
        [*PORT_CLI, "sync", f"file://{src}", f"file://{dst}",
         "--manager-listen", "127.0.0.1:0", "--worker-hosts", "hostA",
         "--worker-launch", "false # {host} {cmd}"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert p.returncode != 0


def test_bwlimit_throttles_copy(tmp_path, capsys):
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    _fill(str(src), {f"f{i}": os.urandom(512 << 10) for i in range(4)})  # 2 MiB
    t0 = time.perf_counter()
    rc = main(["sync", f"file://{src}", f"file://{dst}", "--bwlimit", "8"])
    elapsed = time.perf_counter() - t0
    assert rc == 0
    assert _last_json(capsys.readouterr().out)["copied"] == 4
    # 2 MiB at 8 Mbps (1 MB/s) with a 1 s burst allowance: >= ~1 s
    assert elapsed >= 0.9, f"bwlimit not applied ({elapsed:.2f}s)"
    assert _tree(str(dst)) == _tree(str(src))


def test_cross_protocol_sync_s3_to_webdav(tmp_path, capsys):
    """The port's S3 gateway as the source and its WebDAV server as the
    destination: the port's object drivers interchange."""
    from tests.test_torch_object_remote import _server_stack

    gw, v1, _fs1, s3ep = _server_stack("port", tmp_path / "s3", "s3")
    dav, v2, _fs2, davep = _server_stack("port", tmp_path / "dav", "webdav")
    try:
        src = create_storage(s3ep + "/bkt")
        src.create()
        blobs = {f"d/{i}.bin": os.urandom(20_000 + i) for i in range(6)}
        for k, b in blobs.items():
            src.put(k, b)
        rc = main(["sync", s3ep + "/bkt", davep + "/vol", "--check-new"])
        assert rc == 0
        stats = _last_json(capsys.readouterr().out)
        assert stats["copied"] == 6 and stats["mismatch"] == 0
        dst = create_storage(davep + "/vol")
        for k, b in blobs.items():
            assert bytes(dst.get(k)) == b
    finally:
        gw.stop()
        dav.stop()
        for v in (v1, v2):
            v.close()
            v.store.close()


# ----------------------------------------------- tests/test_cmd.py:184 --

def test_sync_and_check(tmp_path, capsys):
    src_dir, dst_dir = tmp_path / "s", tmp_path / "d"
    src = create_storage(f"file://{src_dir}")
    src.create()
    for i in range(10):
        src.put(f"k{i:02d}", os.urandom(1000 + i))
    src.put("skipme.tmp", b"x")
    assert main(["sync", f"file://{src_dir}", f"file://{dst_dir}",
                 "--exclude", "*.tmp", "--check-new"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["copied"] == 10 and stats["mismatch"] == 0
    dst = create_storage(f"file://{dst_dir}")
    assert bytes(dst.get("k03")) == bytes(src.get("k03"))
    with pytest.raises(Exception):
        dst.get("skipme.tmp")
    assert main(["sync", f"file://{src_dir}", f"file://{dst_dir}",
                 "--exclude", "*.tmp"]) == 0
    assert json.loads(capsys.readouterr().out)["copied"] == 0
    dst.put("extraneous", b"zzz")
    assert main(["sync", f"file://{src_dir}", f"file://{dst_dir}",
                 "--exclude", "*.tmp", "--delete-dst"]) == 0
    assert json.loads(capsys.readouterr().out)["deleted"] == 1


# ------------------------------------------- changes from the reference --

def test_bootstrapped_workers_run_the_port(monkeypatch):
    """The default launch spawns this package's CLI, never the JAX
    package's."""
    spawned = []

    class FakePopen:
        def __init__(self, argv, **kw):
            spawned.append(argv)

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    args = types.SimpleNamespace(worker_hosts="a, b", worker_launch="", src="file:///s",
                                 dst="file:///d", threads=3)
    port_sync._launch_workers(args, "127.0.0.1:1", ["--check-new"])
    assert spawned == [[*PORT_CLI, "sync", "file:///s", "file:///d", "--check-new",
                        "--worker", "--manager", "127.0.0.1:1", "--threads", "3"]] * 2


def test_straggler_after_the_queue_drained_exits_zero(tmp_path, capsys):
    """The second worker starts only after the first has drained the queue
    and reported: it gets `done` at /register and exits 0 with zero tasks,
    and the manager reports the full sync."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    objs = {f"f{i:03d}": os.urandom(100 + i) for i in range(300)}
    _fill(str(src), objs)
    mgr, addr = _manager(src, dst)
    try:
        worker = ["sync", f"file://{src}", f"file://{dst}", "--worker", "--manager", addr]
        assert main(worker) == 0
        first = _last_json(capsys.readouterr().out)
        assert first["copied"] == len(objs)
        assert main(worker) == 0
        late = _last_json(capsys.readouterr().out)
        assert late == port_sync._new_stats()
        out, _ = mgr.communicate(timeout=60)
    finally:
        mgr.kill()
    assert mgr.returncode == 0
    totals = _last_json(out)
    assert totals["copied"] == totals["tasks_done"] == totals["dispatched"] == len(objs)
    assert _tree(str(dst)) == objs


def _post(addr: str, path: str, payload: dict) -> dict:
    req = urllib.request.Request(f"http://{addr}{path}", data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read() or b"{}")


def test_worker_dying_mid_batch_still_fails_the_sync(tmp_path, capsys):
    """A worker that fetched a batch and reported none of it done fails
    the sync; a straggler that comes afterwards exits 0 and changes
    nothing."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    _fill(str(src), {f"f{i:02d}": b"x" * i for i in range(20)})
    mgr, addr = _manager(src, dst)
    try:
        assert _post(addr, "/register", {}) == {"done": False}
        assert len(_post(addr, "/fetch", {"n": 256})["tasks"]) == 20
        _post(addr, "/stats", {})  # died: nothing done
        assert main(["sync", f"file://{src}", f"file://{dst}", "--worker",
                     "--manager", addr]) == 0
        assert _last_json(capsys.readouterr().out)["tasks_done"] == 0
        out, _ = mgr.communicate(timeout=60)
    finally:
        mgr.kill()
    assert mgr.returncode == 1
    totals = _last_json(out)
    assert totals["dispatched"] == 20 and totals["tasks_done"] == 0


# ----------------------------------------- parity with the JAX package --

def _seeded_tree(root, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    objs = {}
    for i in range(40):
        n = int(rng.choice([0, 1, 4096, 70_000, (1 << 20) + 5, (2 << 20) + 17]))
        objs[f"{['a', 'b/c', 'd'][i % 3]}/o{i:02d}.bin"] = rng.bytes(n)
    objs["skip/me.tmp"] = b"excluded"
    _fill(str(root), objs)
    return objs


def _run_both(argv_of, capsys) -> dict:
    out = {}
    for side, entry in (("ref", ref_main), ("port", main)):
        rc = entry(argv_of(side))
        stats = _last_json(capsys.readouterr().out)
        stats.pop("seconds")
        out[side] = (rc, stats)
    return out


def test_sync_matches_reference_on_a_seeded_tree(tmp_path, capsys):
    """Both packages' `sync` of one seeded tree (multipart above 1 MiB, an
    exclude rule) give identical trees and stats; a second run copies
    nothing; after the same same-size corruption in both destinations a
    plain run sees nothing, --check-all finds exactly it (rc 1), and
    --delete-dst removes the same extraneous object."""
    src = tmp_path / "src"
    objs = _seeded_tree(src, 23)
    dst = {side: tmp_path / f"dst-{side}" for side in ("ref", "port")}
    base = ["--big-threshold", "1", "--part-size", "1", "--exclude", "*.tmp",
            "--threads", "4"]

    def argv(*extra):
        return lambda side: ["sync", f"file://{src}", f"file://{dst[side]}", *base, *extra]

    got = _run_both(argv("--check-new"), capsys)
    assert got["port"] == got["ref"]
    rc, stats = got["port"]
    want = {k: v for k, v in objs.items() if not k.endswith(".tmp")}
    assert rc == 0 and stats["copied"] == len(want) and stats["mismatch"] == 0
    assert _tree(str(dst["port"])) == _tree(str(dst["ref"])) == want

    got = _run_both(argv(), capsys)
    assert got["port"] == got["ref"] and got["port"][1]["copied"] == 0

    victim = sorted(k for k, v in want.items() if len(v) > 4096)[1]
    bad = bytes(b ^ 0xFF for b in want[victim])
    for side in dst:
        _fill(str(dst[side]), {victim: bad})
    got = _run_both(argv(), capsys)
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0 and got["port"][1]["mismatch"] == 0
    got = _run_both(argv("--check-all"), capsys)
    assert got["port"] == got["ref"]
    rc, stats = got["port"]
    assert rc == 1 and stats["mismatch"] == 1 and stats["checked"] == len(want)

    for side in dst:
        _fill(str(dst[side]), {"extra/zz.bin": b"zzz"})
    got = _run_both(argv("--delete-dst"), capsys)
    assert got["port"] == got["ref"] and got["port"][1]["deleted"] == 1
    assert _tree(str(dst["port"])) == _tree(str(dst["ref"]))
