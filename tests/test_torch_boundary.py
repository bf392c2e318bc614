"""Import boundary of the port: juicefs_tpu_torch and chip_smoke.py load
neither JAX nor any juicefs_tpu module.

A subprocess is needed because this suite's conftest imports jax first.
Note that "juicefs_tpu" is a prefix of "juicefs_tpu_torch": names are
compared as whole dotted components.
"""

import ast
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "juicefs_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "juicefs_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    for dirpath, _dirs, files in os.walk(PORT):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def test_forbidden_prefix_rule():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("juicefs_tpu") and _forbidden("juicefs_tpu.tpu.jth256")
    assert not _forbidden("juicefs_tpu_torch")
    assert not _forbidden("juicefs_tpu_torch.gpu.hash_torch")
    assert not _forbidden("jaxtyping_free")


def test_importing_every_port_module_loads_no_jax():
    code = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {REPO!r})
import juicefs_tpu_torch
names = ["juicefs_tpu_torch"]
for mod in pkgutil.walk_packages(juicefs_tpu_torch.__path__, "juicefs_tpu_torch."):
    names.append(mod.name)
for n in names:
    importlib.import_module(n)
print(json.dumps({{"imported": names, "loaded": sorted(sys.modules)}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True, cwd=REPO)
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert "juicefs_tpu_torch.gpu.hash_torch" in doc["imported"]
    for name in ("cmd.gc", "cmd.fsck", "cmd.format", "meta.kv", "meta.redis_kv",
                 "utils.txnwatch", "utils.lockwatch", "object.sharding",
                 "chunk.indexer", "vfs.vfs", "vfs.internal", "vfs.compact", "fs",
                 "sdk", "gateway.s3", "gateway.serve", "object.s3", "cmd.gateway",
                 "fuse", "fuse.kernel", "fuse.mount", "fuse.passfd", "fuse.server",
                 "cmd.mount", "cmd.dump", "vfs.backup", "meta.dump", "metric.usage",
                 "gpu.sharding", "multichip", "object.webdav", "gateway.webdav",
                 "cmd.objbench", "cmd.bench", "cmd.sync", "cmd.config", "meta.sql",
                 "meta.redis_server", "meta.fault", "cmd.meta_server", "cmd.info",
                 "cmd.quota", "cmd.stats", "cache", "cache.ring", "cache.group",
                 "cache.server", "cmd.warmup", "object.checksum", "object.fault",
                 "object.encrypt", "object.dbstore", "object.gs", "object.azure"):
        assert "juicefs_tpu_torch." + name in doc["imported"]
    bad = [n for n in doc["loaded"] if _forbidden(n)]
    assert bad == []


def test_sources_import_no_jax():
    found = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert found == []


def test_c_shim_embeds_only_the_port():
    """The port's C shim (sdk_c/*.cpp, *.c) imports no module of the
    reference: every module name it passes to CPython is the port's."""
    found = []
    sdk_c = os.path.join(PORT, "sdk_c")
    sources = [fn for fn in sorted(os.listdir(sdk_c)) if fn.endswith((".cpp", ".c", ".h"))]
    assert "libjfs.cpp" in sources
    for fn in sources:
        with open(os.path.join(sdk_c, fn)) as f:
            text = f.read()
        for name in re.findall(r'PyImport_\w+\(\s*"([\w.]+)"', text):
            if _forbidden(name) or not name.startswith("juicefs_tpu_torch"):
                found.append(f"{fn}: {name}")
        found += [f"{fn}: {m}" for m in re.findall(r'"(juicefs_tpu(?:\.[\w.]*)?)"', text)]
    assert found == []


def test_package_import_is_light():
    """Importing the top package loads no subpackage and builds nothing."""
    code = f"""
import json, sys
sys.path.insert(0, {REPO!r})
import juicefs_tpu_torch
print(json.dumps(sorted(n for n in sys.modules if n.startswith("juicefs_tpu_torch"))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=REPO)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == ["juicefs_tpu_torch"]


def test_lazy_imports_of_the_client_core_load_no_jax(tmp_path):
    """The imports inside function bodies of the vfs, the SDK, the gateway
    subcommand and `gc --compact` are reached by calling them: the
    virtual `.control` compact op and `.status` (compact, the object
    plane's resilience snapshot, the staging length, the gateway status),
    `.stats`, `jfs_init`/`jfs_term`, a gateway started and stopped, and
    `gc --compact`. None of them may load jax or a juicefs_tpu module."""
    code = f"""
import json, os, sys, types
sys.path.insert(0, {REPO!r})
from juicefs_tpu_torch import cmd, sdk
from juicefs_tpu_torch.cmd import gateway
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.vfs import ROOT_INO
from juicefs_tpu_torch.vfs.internal import CONTROL_INO, STATS_INO, STATUS_INO
url = "sqlite3://{tmp_path}/lazy.db"
assert cmd.main(["format", url, "lazy", "--storage", "file", "--bucket",
                 "{tmp_path}/blob", "--compress", "none", "--hash-backend", "cpu"]) == 0
mid = sdk.jfs_init(url)
fd = sdk.jfs_open(mid, "/f", os.O_CREAT | os.O_RDWR, 0o644)
for i in range(3):
    sdk.jfs_pwrite(mid, fd, i * 10, b"x" * 10)
    sdk.jfs_flush(mid, fd)
sdk.jfs_close(mid, fd)
st = sdk.jfs_stat(mid, "/f")
sdk.jfs_term(mid)
args = types.SimpleNamespace(meta_url=url, address="127.0.0.1", port=0, cache_dir="",
                             cache_size=0, writeback=False, compress_backend="cpu",
                             access_key="", secret_key="", tenant_key=[], max_inflight=4)
gw, vfs, m = gateway.start_gateway(args)
ctx = Context(uid=0, gid=0, pid=1)
st, ino, _ = vfs.lookup(ctx, ROOT_INO, b"f")
vfs.internal.open(CONTROL_INO, 1)
assert vfs.internal.write(ctx, CONTROL_INO, 1, json.dumps({{"op": "compact", "inode": ino}}).encode()) == 0
out = json.loads(vfs.internal.read(CONTROL_INO, 1, 0, 4096)[1])
assert out == {{"errno": 0, "compacted": 1}}, out
for i, name in enumerate(("info", "warmup")):
    vfs.internal.write(ctx, CONTROL_INO, 1, json.dumps({{"op": name, "inode": ino}}).encode())
for n, ino_ in ((2, STATUS_INO), (3, STATS_INO)):
    vfs.internal.open(ino_, n)
    assert vfs.internal.read(ino_, n, 0, 1 << 20)[1]
status = json.loads(vfs.internal.read(STATUS_INO, 2, 0, 1 << 20)[1])
assert "gateway" in status and "staging" in status, sorted(status)
gw.stop(); vfs.close(); vfs.store.close(); m.close_session(); m.client.close()
assert cmd.main(["gc", url, "--compact", "--hash-backend", "cpu", "--compress-backend", "cpu"]) == 0
print(json.dumps(sorted(sys.modules)))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("vfs.compact", "gateway.serve", "object.resilient", "chunk.cached_store",
                 "sdk", "cmd.gateway", "metric"):
        assert "juicefs_tpu_torch." + name in loaded
    assert [n for n in loaded if _forbidden(n)] == []


def test_lazy_imports_of_mount_and_dump_load_no_jax(tmp_path):
    """The imports inside `cmd/mount.py`'s function bodies (`start_mount`:
    the fuse server, the vfs, the meta message types, the background jobs,
    compaction, the takeover socket, the usage reporter, the metrics
    server; `run_umount`: fuse.mount, fuse.passfd) and `dump`/`load` are reached by
    calling them: a mount served over a socketpair with --takeover,
    --usage-report-url and --metrics, its background jobs run once, then
    `umount`, `dump` and `load`. None of them may load jax or a
    juicefs_tpu module."""
    code = f"""
import argparse, json, os, socket, sys, threading, types
sys.path.insert(0, {REPO!r})
os.environ["XDG_RUNTIME_DIR"] = "{tmp_path}/run"
from juicefs_tpu_torch import cmd
from juicefs_tpu_torch.cmd import mount
from juicefs_tpu_torch.fuse import kernel as k
url = "sqlite3://{tmp_path}/lazy.db"
assert cmd.main(["format", url, "lazy", "--storage", "file", "--bucket",
                 "{tmp_path}/blob", "--compress", "none", "--hash-backend", "cpu"]) == 0
p = argparse.ArgumentParser()
mount.add_parser(p.add_subparsers())
args = p.parse_args(["mount", url, "{tmp_path}/mp", "--inline-dedup", "--compress-backend",
                     "cpu", "--takeover", "--metrics", "127.0.0.1:0", "--no-watchdog",
                     "--usage-report-url", "http://127.0.0.1:9/usage"])
a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_SEQPACKET)
mounted = mount.start_mount(args, fuse_fd=b.fileno())
assert mounted.usage is not None and mounted.metrics_srv is not None
t = threading.Thread(target=mounted.srv.serve, daemon=True)
t.start()
a.send(k.IN_HEADER.pack(k.IN_HEADER_SIZE + k.INIT_IN.size, k.INIT, 1, 0, 0, 0, 1, 0)
       + k.INIT_IN.pack(7, 36, 1 << 20, 0))
assert k.OUT_HEADER.unpack_from(a.recv(4096))[1] == 0
assert "backup" in mounted.bg.run_once()
a.shutdown(socket.SHUT_RDWR)
t.join(60)
mounted.close()
mounted.meta.client.close()
try:
    mount.run_umount(types.SimpleNamespace(mountpoint="{tmp_path}/mp", force=True))
except OSError:
    pass  # no fusermount on this host: the import was reached first
assert cmd.main(["dump", url, "{tmp_path}/dump.json"]) == 0
assert cmd.main(["load", "sqlite3://{tmp_path}/copy.db", "{tmp_path}/dump.json"]) == 0
print(json.dumps(sorted(sys.modules)))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("fuse.server", "fuse.passfd", "fuse.mount", "vfs.backup", "vfs.compact",
                 "meta.interface", "meta.dump", "metric.usage", "cmd.dump", "chunk.ingest"):
        assert "juicefs_tpu_torch." + name in loaded
    assert [n for n in loaded if _forbidden(n)] == []


def test_lazy_imports_of_the_sharding_plane_load_no_jax():
    """The imports inside the sharding plane's and the multichip run's
    function bodies (the estimator's compress_batch, the chunk store, the
    meta engine, gc) are reached by calling them: `gpu.ShardPlane` over a
    2 x 2 mesh of CPU devices hashes, scans and estimates a batch, and
    `dryrun_multichip` ingests and scans a small volume on it. None of
    them may load jax or a juicefs_tpu module."""
    code = f"""
import json, sys
sys.path.insert(0, {REPO!r})
import torch
from juicefs_tpu_torch import gpu
from juicefs_tpu_torch.gpu.jth256 import pack_blocks
from juicefs_tpu_torch.multichip import dryrun_multichip
plane = gpu.ShardPlane([torch.device("cpu")] * 4)
packed = pack_blocks([b"a" * 70000, b"b", b"a" * 70000], pad_lanes=2)
sp = plane.put_packed(*packed)
assert plane.hash_packed(*sp, n=sp.batch).shape == (3, 8)
assert plane.scan_packed(*packed)[1].tolist() == [False, False, True]
with plane.advised() as advice:
    plane.hash_async(*sp)
assert advice[0].shape == (4,)
assert dryrun_multichip([torch.device("cpu")] * 4, gib=9 / 1024)["identity_ok"]
print(json.dumps(sorted(sys.modules)))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("gpu.sharding", "gpu.compress_batch", "multichip", "cmd.gc",
                 "chunk.ingest", "meta.kv"):
        assert "juicefs_tpu_torch." + name in loaded
    assert [n for n in loaded if _forbidden(n)] == []


def test_lazy_imports_of_the_object_clients_and_new_subcommands_load_no_jax(tmp_path):
    """The imports inside the function bodies of `objbench` (the resilience
    wrapper, the compressor, the BlockIndexer), `bench`, `config`, `sync`
    (local and as a manager with a worker process), the `webdav`
    subcommand's server and the S3/WebDAV clients are reached by calling
    them. Neither this process nor the sync worker process, launched
    through a --worker-launch template with -X importtime, may load jax or
    a juicefs_tpu module."""
    imports = tmp_path / "worker-imports.txt"
    code = f"""
import json, os, sys, types
sys.path.insert(0, {REPO!r})
from juicefs_tpu_torch import cmd
from juicefs_tpu_torch.cmd import gateway
from juicefs_tpu_torch.object import create_storage
t = "{tmp_path}"
assert cmd.main(["objbench", "file://" + t + "/ob", "--block-size", "1", "--big-object-size",
                 "2", "--small-objects", "2", "--compress", "lz4", "--hash-backend", "cpu"]) == 0
os.makedirs(t + "/plain")
assert cmd.main(["bench", t + "/plain", "--big-file-size", "1", "--small-file-count", "2"]) == 0
url = "sqlite3://" + t + "/v.db"
assert cmd.main(["format", url, "v", "--storage", "file", "--bucket", t + "/blob",
                 "--compress", "none", "--hash-backend", "cpu"]) == 0
assert cmd.main(["config", url, "--trash-days", "2"]) == 0
args = types.SimpleNamespace(meta_url=url, address="127.0.0.1", port=0, cache_dir="",
                             cache_size=0, writeback=False, compress_backend="cpu")
srv, vfs, m = gateway.start_webdav(args)
dav = create_storage("webdav://127.0.0.1:%d/vol" % srv.port)
dav.put("a/b", b"x" * 100)
assert [o.key for o in dav.list_all()] == ["a/b"]
os.makedirs(t + "/src")
open(t + "/src/f", "wb").write(b"y" * 10)
assert cmd.main(["sync", "file://" + t + "/src", "webdav://127.0.0.1:%d/vol" % srv.port,
                 "--check-new"]) == 0
assert create_storage("s3://a:b@127.0.0.1:9/bkt").bucket == "bkt"
launch = sys.executable + " -X importtime -m juicefs_tpu_torch.cmd {{cmd}} 2> {imports}"
assert cmd.main(["sync", "file://" + t + "/src", "file://" + t + "/dst", "--manager-listen",
                 "127.0.0.1:0", "--worker-hosts", "h", "--worker-launch", launch]) == 0
srv.stop(); vfs.close(); vfs.store.close(); m.close_session(); m.client.close()
print(json.dumps(sorted(sys.modules)))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("cmd.objbench", "cmd.bench", "cmd.config", "cmd.sync", "gateway.webdav",
                 "object.webdav", "object.s3", "object.resilient", "compress", "chunk.indexer"):
        assert "juicefs_tpu_torch." + name in loaded
    assert [n for n in loaded if _forbidden(n)] == []
    worker = [line.rsplit("|", 1)[-1].strip() for line in imports.read_text().splitlines()
              if line.startswith("import time:")]
    assert "juicefs_tpu_torch.cmd.sync" in worker and "juicefs_tpu_torch.object.resilient" in worker
    assert [n for n in worker if _forbidden(n)] == []


def test_lazy_imports_of_the_meta_plane_and_meta_subcommands_load_no_jax(tmp_path):
    """The imports inside the function bodies of the meta plane (the sql
    engine behind `new_client`, the RESP server with its AOF and replica
    pull loop, FaultyMeta under the resilience guard) and of the meta
    subcommands (`status` with its object-plane probe, `info`, `summary`,
    `quota`, `mdtest --via-vfs`, `clone`, `rmr`, `restore`, `destroy`,
    and `meta-server` as a process) are reached by calling them. None of
    them may load jax or a juicefs_tpu module, in this process or in the
    meta-server process, launched with -X importtime."""
    imports = tmp_path / "server-imports.txt"
    code = f"""
import json, signal, subprocess, sys
sys.path.insert(0, {REPO!r})
from juicefs_tpu_torch import cmd
from juicefs_tpu_torch.meta import new_client
from juicefs_tpu_torch.meta.fault import FaultyMeta
from juicefs_tpu_torch.meta.redis_server import RedisServer
t = "{tmp_path}"
pri = RedisServer(data_path=t + "/m.aof", fsync="always")
pport = pri.start()
rep = RedisServer(replica_of="127.0.0.1:%d" % pport)
rep.start()
for url in ("sql://" + t + "/v.db", "redis://127.0.0.1:%d/1" % pport):
    name = url.split(":")[0]
    assert cmd.main(["format", url, name, "--storage", "file", "--bucket", t + "/" + name,
                     "--compress", "none", "--hash-backend", "cpu", "--trash-days", "1"]) == 0
    for argv in (["status", url], ["summary", url, "/"], ["info", url, "/"],
                 ["quota", "set", url, "/", "--inodes", "99"], ["quota", "check", url, "/"],
                 ["mdtest", url, "--dirs", "1", "--files", "1", "--via-vfs"],
                 ["clone", url, "/", "/c"], ["rmr", url, "/c"], ["restore", url],
                 ["destroy", url, "--yes"]):
        assert cmd.main(argv) in (0, 1), argv
m = new_client("memkv://")
from juicefs_tpu_torch.meta import Format
m.init(Format(name="f", trash_days=0), force=True)
m.load()
FaultyMeta(m, error_rate=0.0)
m.configure_meta_retries(max_attempts=2)
assert m.do_getattr(1)[0] == 0
m.resilience.close()
rep.stop(); pri.stop()
p = subprocess.Popen([sys.executable, "-X", "importtime", "-m", "juicefs_tpu_torch.cmd",
                      "meta-server", "--host", "127.0.0.1", "--port", "0"],
                     cwd={REPO!r}, stdout=subprocess.PIPE, stderr=open("{imports}", "w"),
                     text=True)
assert "listening" in p.stdout.readline()
p.terminate()
assert p.wait(30) == -signal.SIGTERM
print(json.dumps(sorted(sys.modules)))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("meta.sql", "meta.redis_server", "meta.fault", "cmd.info", "cmd.quota",
                 "cmd.stats", "object.resilient", "vfs.vfs", "chunk.cached_store"):
        assert "juicefs_tpu_torch." + name in loaded
    assert [n for n in loaded if _forbidden(n)] == []
    server = [line.rsplit("|", 1)[-1].strip() for line in imports.read_text().splitlines()
              if line.startswith("import time:")]
    assert "juicefs_tpu_torch.cmd.meta_server" in server
    assert "juicefs_tpu_torch.meta.redis_server" in server
    assert [n for n in server if _forbidden(n)] == []


def test_lazy_imports_of_the_cache_group_stores_and_pusher_load_no_jax(tmp_path):
    """The imports inside the function bodies of the cache group (a mount
    with --cache-group serving its peer block server, with --metrics-push
    and --graphite pushing the registry), `warmup --cache-group`, the
    object registry's factories (gs, azure, sqlite3, redis), the
    checksum and encryption wrappers behind `storage_for` on an encrypted
    volume, and FaultyStore are reached by calling them. None of them may
    load jax or a juicefs_tpu module."""
    code = f"""
import argparse, json, os, socket, sys, threading, base64
sys.path.insert(0, {REPO!r})
os.environ["XDG_RUNTIME_DIR"] = "{tmp_path}/run"
from juicefs_tpu_torch import cmd
from juicefs_tpu_torch.cmd import mount
from juicefs_tpu_torch.meta.redis_server import RedisServer
from juicefs_tpu_torch.object import create_storage, new_checksummed, new_encrypted
from juicefs_tpu_torch.object import generate_rsa_key_pem
from juicefs_tpu_torch.object.fault import FaultyStore
t = "{tmp_path}"
url = "sqlite3://" + t + "/g.db"
assert cmd.main(["format", url, "g", "--storage", "file", "--bucket", t + "/blob",
                 "--compress", "none", "--hash-backend", "cpu"]) == 0
sink = socket.socket(); sink.bind(("127.0.0.1", 0)); sink.listen(4)
p = argparse.ArgumentParser()
mount.add_parser(p.add_subparsers())
args = p.parse_args(["mount", url, t + "/mp", "--cache-group", "grp", "--compress-backend",
                     "cpu", "--no-watchdog", "--no-bgjobs", "--graphite",
                     "127.0.0.1:%d" % sink.getsockname()[1], "--push-interval", "0.05"])
a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_SEQPACKET)
mounted = mount.start_mount(args, fuse_fd=b.fileno())
th = threading.Thread(target=mounted.srv.serve, daemon=True)
th.start()
conn, _ = sink.accept()
assert conn.recv(1 << 16)
conn.close()
addr = mounted.peer_srv.addr
assert cmd.main(["warmup", url, "/", "--cache-group", "grp", "--group-self", addr,
                 "--cache-dir", t + "/wc"]) == 0
a.shutdown(socket.SHUT_RDWR)
th.join(60)
mounted.close()
mounted.meta.client.close()
srv = RedisServer()
port = srv.start()
create_storage("redis://127.0.0.1:%d/2" % port).put("k", b"v")
srv.stop()
create_storage("sqlite3://" + t + "/o.db").put("k", b"v")
create_storage("gs://tok@127.0.0.1:9/b").string()
create_storage("azure://a:" + base64.b64encode(b"k").decode() + "@127.0.0.1:9/c").string()
f = FaultyStore(new_checksummed(create_storage("mem://")), error_rate=0.0)
f.put("k", b"v")
pem = generate_rsa_key_pem()
open(t + "/key.pem", "wb").write(pem)
enc = "sqlite3://" + t + "/e.db"
assert cmd.main(["format", enc, "e", "--storage", "file", "--bucket", t + "/eblob",
                 "--compress", "none", "--hash-backend", "cpu", "--encrypt-rsa-key",
                 t + "/key.pem", "--encrypt-algo", "aes256ctr-rsa"]) == 0
assert cmd.main(["gc", enc, "--hash-backend", "cpu", "--compress-backend", "cpu"]) == 0
print(json.dumps(sorted(sys.modules)))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("cache.group", "cache.server", "cache.ring", "cmd.warmup", "object.gs",
                 "object.azure", "object.dbstore", "object.encrypt", "object.checksum",
                 "object.fault", "meta.redis_kv", "metric"):
        assert "juicefs_tpu_torch." + name in loaded
    assert [n for n in loaded if _forbidden(n)] == []
