"""Twin of tests/test_takeover.py on the port: the mount-wiring drill.

The other case of that file, the open fd surviving a takeover, is
`tests/test_torch_mount.py::test_open_fd_survives_takeover`. Here a volume
formatted with a hash backend gets write-path fingerprinting through the
real `mount` command: files written through the kernel land digest rows
in the meta content index, each equal to the port's numpy spec and to the
reference's hash of the stored raw block.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from juicefs_tpu.tpu.jth256 import jth256 as ref_jth256
from juicefs_tpu_torch import cmd as port_cmd
from juicefs_tpu_torch.chunk.cached_store import block_key
from juicefs_tpu_torch.gpu.jth256 import jth256

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not os.path.exists("/dev/fuse") or shutil.which("fusermount") is None,
    reason="FUSE not available",
)


@pytest.fixture
def runtime_dir(tmp_path, monkeypatch):
    """Takeover sockets go under XDG_RUNTIME_DIR: keep them in tmp_path."""
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path / "run"))


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


def _mounted_write(tmp_path, payload: bytes) -> str:
    """Format a `--hash-backend cpu` volume, mount it with the port's
    `mount` process, write `payload` through the kernel and read it back,
    unmount; returns the meta URL."""
    meta_url = f"sqlite3://{tmp_path}/meta.db"
    assert port_cmd.main(["format", meta_url, "hvol", "--storage", "file", "--bucket",
                          str(tmp_path / "blobs"), "--hash-backend", "cpu",
                          "--trash-days", "0"]) == 0
    mp = tmp_path / "mnt"
    mp.mkdir()
    p = subprocess.Popen([sys.executable, "-m", "juicefs_tpu_torch.cmd", "mount", meta_url,
                          str(mp), "--no-watchdog", "--compress-backend", "cpu"], cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        assert _wait_mounted(mp, p), p.poll()
        with open(mp / "indexed.bin", "wb") as f:
            f.write(payload)
        with open(mp / "indexed.bin", "rb") as f:
            assert f.read() == payload
    finally:
        subprocess.run(["fusermount", "-u", str(mp)], capture_output=True, timeout=30)
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.send_signal(signal.SIGTERM)
            p.wait(timeout=10)
        p.stdout.close()
    return meta_url


def test_mount_wires_content_indexer_end_to_end(tmp_path, runtime_dir):
    payload = np.random.default_rng(7).bytes(300_000)
    m, fmt = port_cmd.open_meta(_mounted_write(tmp_path, payload))
    store = port_cmd.build_store(fmt, None, with_indexer=False)
    try:
        rows = list(m.scan_block_digests())
        assert rows, "mount did not index written blocks"
        # every row is the spec hash of its stored raw block
        total = 0
        for sid, indx, bsize, digest in rows:
            raw = store._load_block(block_key(sid, indx, bsize), bsize)
            assert digest == jth256(raw) == ref_jth256(raw)
            total += bsize
    finally:
        store.close()
        m.client.close()
    assert total >= 300_000
