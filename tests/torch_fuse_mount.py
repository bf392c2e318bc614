"""The port's copy of tests/conftest.py `fuse_mount`: the full stack of
juicefs_tpu_torch on mem:// meta + mem:// objects, mounted through the
kernel, for the twins of the reference's real-syscall drills
(test_torch_trace, test_torch_posix_oracle, test_torch_takeover)."""

from __future__ import annotations

import contextlib
import os
import shutil
import time

import pytest


@contextlib.contextmanager
def fuse_mount(tmp_path, block_size=1 << 20, cache_dirs=("memory",),
               meta_url="mem://", vfs_conf=None, **format_kw):
    """Build the port's stack, mount it, wait for the kernel INIT
    handshake, yield the mountpoint, and tear down."""
    if not os.path.exists("/dev/fuse") or shutil.which("fusermount") is None:
        pytest.skip("FUSE not available")
    from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
    from juicefs_tpu_torch.fuse import Server
    from juicefs_tpu_torch.meta import Format, new_client
    from juicefs_tpu_torch.object import create_storage
    from juicefs_tpu_torch.vfs import VFS

    format_kw.setdefault("name", "fusetest")
    format_kw.setdefault("storage", "mem")
    m = new_client(meta_url)
    m.init(Format(block_size=block_size >> 10, **format_kw), force=False)
    m.load()
    m.new_session()
    store = CachedStore(
        create_storage("mem://"),
        ChunkConfig(block_size=block_size, cache_dirs=tuple(cache_dirs),
                    compress_backend="cpu"),
    )
    v = VFS(m, store, conf=vfs_conf)
    mp = tmp_path / "mnt"
    mp.mkdir(exist_ok=True)
    srv = Server(v, str(mp))
    try:
        srv.serve_background()
    except OSError as e:
        pytest.skip(f"cannot mount: {e}")
    deadline = time.time() + 5
    while time.time() < deadline:
        try:
            os.statvfs(mp)
            break
        except OSError:
            time.sleep(0.05)
    try:
        yield str(mp)
    finally:
        srv.unmount()
        time.sleep(0.1)
        v.close()
        store.close()
