"""Local-disk object store (a copy of juicefs_tpu/object/file.py;
reference pkg/object/file.go).

Keys map to paths under the root; writes are atomic (temp file + rename) so
a crashed writer never leaves a half-written block visible — the same
guarantee the reference relies on for its disk-backed stores.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import uuid
from typing import Iterator

from .interface import MultipartUpload, NotFoundError, Obj, ObjectStorage, Part


class FileStorage(ObjectStorage):
    def __init__(self, root: str):
        # file:///abs/path arrives as "/abs/path"; relative allowed for tests
        self.root = root if root.endswith("/") else root + "/"
        # ensured-directory cache: the block
        # namespace reuses a handful of chunks/a/b dirs, and the
        # per-PUT makedirs walk costs 3+ stats per call — expensive on
        # network filesystems. delete()'s empty-dir pruning invalidates;
        # put() additionally retries once on a lost race.
        self._dirs: set[str] = set()
        self._dirs_lock = threading.Lock()

    def _ensure_dir(self, d: str) -> None:
        with self._dirs_lock:
            if d in self._dirs:
                return
        os.makedirs(d, exist_ok=True)
        with self._dirs_lock:
            if len(self._dirs) >= 4096:
                self._dirs.clear()  # unbounded key space: cheap reset
            self._dirs.add(d)

    def _forget_dir(self, d: str) -> None:
        with self._dirs_lock:
            self._dirs.discard(d)

    def string(self) -> str:
        return f"file://{self.root}"

    def create(self) -> None:
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                if off:
                    f.seek(off)
                return f.read() if limit < 0 else f.read(limit)
        except FileNotFoundError:
            raise NotFoundError(key) from None
        except IsADirectoryError:
            raise NotFoundError(key) from None

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        d = os.path.dirname(path)
        for attempt in (0, 1):
            self._ensure_dir(d)
            try:
                fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp.")
            except FileNotFoundError:
                # lost the race against delete()'s empty-dir pruning:
                # the cached dir vanished between check and create —
                # recreate and retry once (once the temp file exists the
                # dir is non-empty, so rmdir cannot take it again)
                self._forget_dir(d)
                if attempt:
                    raise
                continue
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
                return
            except BaseException:
                try:
                    os.unlink(tmp)
                except FileNotFoundError:
                    pass
                raise

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except (FileNotFoundError, IsADirectoryError):
            pass
        # opportunistically prune empty parent dirs up to the root
        d = os.path.dirname(self._path(key))
        root = self.root.rstrip("/")
        while len(d) > len(root):
            try:
                os.rmdir(d)
            except OSError:
                break
            self._forget_dir(d)
            d = os.path.dirname(d)

    def head(self, key: str) -> Obj:
        try:
            st = os.stat(self._path(key))
        except FileNotFoundError:
            raise NotFoundError(key) from None
        if os.path.isdir(self._path(key)):
            raise NotFoundError(key)
        return Obj(key=key, size=st.st_size, mtime=st.st_mtime)

    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        root = self.root
        if not os.path.isdir(root):
            return
        keys: list[str] = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for fn in filenames:
                if fn.startswith(".tmp."):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix) and key > marker:
                    keys.append(key)
        keys.sort()
        for key in keys:
            try:
                st = os.stat(self._path(key))
            except FileNotFoundError:
                continue
            yield Obj(key=key, size=st.st_size, mtime=st.st_mtime)

    def create_multipart_upload(self, key: str):
        uid = uuid.uuid4().hex
        os.makedirs(os.path.join(self.root, ".uploads", uid), exist_ok=True)
        return MultipartUpload(min_part_size=1 << 20, max_count=10000, upload_id=uid)

    def upload_part(self, key: str, upload_id: str, num: int, data: bytes) -> Part:
        path = os.path.join(self.root, ".uploads", upload_id, str(num))
        with open(path, "wb") as f:
            f.write(data)
        return Part(num=num, etag=str(num), size=len(data))

    def complete_upload(self, key: str, upload_id: str, parts: list[Part]) -> None:
        updir = os.path.join(self.root, ".uploads", upload_id)
        buf = []
        for p in sorted(parts, key=lambda p: p.num):
            with open(os.path.join(updir, str(p.num)), "rb") as f:
                buf.append(f.read())
        self.put(key, b"".join(buf))
        self.abort_upload(key, upload_id)

    def abort_upload(self, key: str, upload_id: str) -> None:
        import shutil

        shutil.rmtree(os.path.join(self.root, ".uploads", upload_id), ignore_errors=True)
