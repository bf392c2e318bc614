"""The port's libjfs C shim (juicefs_tpu_torch/sdk_c), driven by compiled C
programs: the twin of tests/test_sdk_c.py.

The shim is built through `sdk_c.build()`; the reference's consumer
`sdk/c/example.c` and the port's `jfs_copy.c` are compiled against the
port's `jfs.h` and library and run as separate processes. `jfs_copy` also
runs against the reference's shim (`sdk/c/libjfs.cpp`, built here the way
the reference's test builds it) on a twin volume, so one C program drives
both packages through one ABI. On a host with no card the volumes are
formatted `--hash-backend cpu --compress none`; a device-hashed volume
makes `jfs_init` fail with -EIO.
"""

from __future__ import annotations

import errno
import json
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

from juicefs_tpu import cmd as ref_cmd
from juicefs_tpu.fs import FileSystem as RefFileSystem
from juicefs_tpu.vfs import VFS as RefVFS
from juicefs_tpu_torch import cmd as port_cmd
from juicefs_tpu_torch import sdk_c
from juicefs_tpu_torch.fs import FileSystem
from juicefs_tpu_torch.gpu.jth256 import jth256
from juicefs_tpu_torch.meta.context import BACKGROUND
from juicefs_tpu_torch.vfs import VFS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SDK = os.path.join(REPO, "sdk", "c")
BS = 4 << 20

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("python3-config") is None,
    reason="native toolchain not available",
)


def _declarations(path: str) -> list[str]:
    """The struct and function declarations of a C header, comments and
    whitespace normalised."""
    text = re.sub(r"/\*.*?\*/", " ", open(path).read(), flags=re.S)
    text = re.sub(r"#.*", " ", text)
    text = re.sub(r"\s+", " ", text)
    decls = re.findall(r"struct jfs_stat \{[^}]*\};", text)
    decls += re.findall(r"[\w ]+\*? ?jfs_\w+ ?\([^)]*\);", text)
    return [d.strip() for d in decls]


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """The port's shim and its two consumers, and jfs_copy built against
    the reference's shim and header."""
    so = sdk_c.build()
    port = {"so": so, "example": sdk_c.build_program(os.path.join(REF_SDK, "example.c")),
            "jfs_copy": sdk_c.build_program(sdk_c.JFS_COPY)}
    ref_dir = tmp_path_factory.mktemp("ref_libjfs")
    cflags, ldflags = sdk_c.embed_flags()
    ref_so = ref_dir / "libjfs.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-O2", "-o", str(ref_so),
                    os.path.join(REF_SDK, "libjfs.cpp"), *cflags, *ldflags], check=True)
    ref_copy = ref_dir / "jfs_copy"
    subprocess.run(["gcc", "-O2", "-o", str(ref_copy), sdk_c.JFS_COPY, f"-I{REF_SDK}",
                    str(ref_so), f"-Wl,-rpath,{ref_dir}"], check=True)
    return {"port": port, "ref_jfs_copy": str(ref_copy)}


def _format(main, tmp_path, name, hash_backend="cpu"):
    url = f"sqlite3://{tmp_path}/{name}.db"
    assert main(["format", url, name, "--storage", "file", "--bucket",
                 str(tmp_path / f"{name}-blob"), "--compress", "none",
                 "--hash-backend", hash_backend, "--trash-days", "0"]) == 0
    return url


def _run(exe, *args):
    return subprocess.run([exe, *args], env=sdk_c.child_env(), capture_output=True,
                          text=True, timeout=180)


def test_shim_embeds_only_the_port(programs):
    src = open(sdk_c.SHIM).read()
    assert 'PyImport_ImportModule("juicefs_tpu_torch.sdk")' in src
    assert '"juicefs_tpu.sdk"' not in src
    assert os.path.dirname(programs["port"]["so"]).startswith(sdk_c.BUILD_DIR)
    nm = subprocess.run(["nm", "-D", "--defined-only", programs["port"]["so"]],
                        capture_output=True, text=True, check=True).stdout
    exported = set(re.findall(r"\b(jfs_\w+)$", nm, flags=re.M))
    declared = {re.search(r"(jfs_\w+) ?\(", d).group(1)
                for d in _declarations(sdk_c.HEADER) if "(" in d}
    assert declared and exported >= declared


def test_consumer_compiles_against_the_ports_header(programs, tmp_path):
    """build_program finds the port's jfs.h even where the consumer's own
    directory holds another one, as sdk/c/ does for example.c."""
    (tmp_path / "jfs.h").write_text("#error not the port's jfs.h\n")
    src = tmp_path / "probe.c"
    src.write_text('#include "jfs.h"\n'
                   "int main(void) { return jfs_sdk_version() == 1 ? 0 : 1; }\n")
    # compiled where it lies, the source finds the header beside it first
    in_place = subprocess.run(["gcc", "-fsyntax-only", f"-I{sdk_c.SDK_DIR}", str(src)],
                              capture_output=True, text=True)
    assert in_place.returncode != 0 and "not the port's jfs.h" in in_place.stderr
    exe = sdk_c.build_program(str(src))
    assert os.path.dirname(exe) == os.path.dirname(programs["port"]["so"])
    assert _run(exe).returncode == 0


def test_headers_declare_the_same_abi():
    port, ref = _declarations(sdk_c.HEADER), _declarations(os.path.join(REF_SDK, "jfs.h"))
    assert len(port) == 17  # struct jfs_stat and 16 functions
    assert port == ref


def test_reference_example_runs_on_the_port(programs, tmp_path):
    url = _format(port_cmd.main, tmp_path, "cvol")
    out = _run(programs["port"]["example"], url)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ALL OK" in out.stdout and "FAIL" not in out.stdout
    # the writes were real, and the program unlinked what it made
    m, _fmt = port_cmd.open_meta(url)
    try:
        st, entries = m.readdir(BACKGROUND, 1)
        assert st == 0
        assert {bytes(e.name) for e in entries} - {b".", b".."} == set()
        assert m.do_list_sessions() == []
    finally:
        m.client.close()


def _read_back(fs_cls, vfs_cls, main_mod, url, path):
    m, fmt = main_mod.open_meta(url)
    store = main_mod.build_store(fmt, None, meta=m, with_indexer=False)
    vfs = vfs_cls(m, store, fmt=fmt)
    try:
        f = fs_cls(vfs).open(path)
        data = f.pread(0, 1 << 30)
        f.close()
    finally:
        vfs.close()
        store.close()
        m.client.close()
    return bytes(data)


def _digest_rows(main_mod, url):
    m, _fmt = main_mod.open_meta(url)
    try:
        return sorted((indx, bsize, bytes(d)) for _sid, indx, bsize, d in
                      m.scan_block_digests())
    finally:
        m.client.close()


def test_jfs_copy_matches_the_reference(programs, tmp_path):
    """jfs_copy through the port's shim and through the reference's, on
    twin volumes: both read back exact, both packages' FileSystems read
    the port's file equal to the host file, and the port's indexer rows
    equal the reference's (and the numpy spec)."""
    data = np.random.default_rng(12).integers(0, 256, (16 << 20) + 7, np.uint8).tobytes()
    host = tmp_path / "plan.bin"
    host.write_bytes(data)
    port_url = _format(port_cmd.main, tmp_path, "port")
    ref_url = _format(ref_cmd.main, tmp_path, "ref")
    results = {}
    for side, exe, url in (("port", programs["port"]["jfs_copy"], port_url),
                           ("ref", programs["ref_jfs_copy"], ref_url)):
        out = _run(exe, url, str(host), "/plan.bin")
        assert out.returncode == 0, out.stdout + out.stderr
        results[side] = json.loads(out.stdout.strip().splitlines()[-1])
    for res in results.values():
        assert res["bytes"] == len(data) and res["pieces"] == 17
        assert res["mismatches"] == 0
    assert _read_back(FileSystem, VFS, port_cmd, port_url, "/plan.bin") == data
    assert _read_back(RefFileSystem, RefVFS, ref_cmd, port_url, "/plan.bin") == data
    port_rows = _digest_rows(port_cmd, port_url)
    assert port_rows == _digest_rows(ref_cmd, ref_url)
    spec = sorted((i, len(data[o:o + BS]), jth256(data[o:o + BS]))
                  for i, o in enumerate(range(0, len(data), BS)))
    assert port_rows == spec


def test_jfs_init_on_a_device_volume_fails_with_eio(programs, tmp_path):
    """On a host with no card, jfs_init of a volume hashed on the card
    returns -EIO through the C ABI and leaves no session behind."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    url = _format(ref_cmd.main, tmp_path, "dev", hash_backend="pallas")
    out = _run(programs["port"]["jfs_copy"], url, os.devnull, "/x")
    assert out.returncode == 1
    assert f"jfs_init failed: {-errno.EIO}" in out.stderr
    m, _fmt = port_cmd.open_meta(url)
    try:
        assert m.do_list_sessions() == []
    finally:
        m.client.close()
