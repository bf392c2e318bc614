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
                 "chunk.indexer"):
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
