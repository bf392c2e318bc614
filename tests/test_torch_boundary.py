"""Import boundary of the port: juicefs_tpu_torch and chip_smoke.py load
neither JAX nor any juicefs_tpu module.

A subprocess is needed because this suite's conftest imports jax first.
Note that "juicefs_tpu" is a prefix of "juicefs_tpu_torch": names are
compared as whole dotted components.
"""

import ast
import json
import os
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
                 "sdk", "gateway.s3", "gateway.serve", "object.s3", "cmd.gateway"):
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
