"""ObjectStorage contract (a copy of juicefs_tpu/object/interface.py;
reference pkg/object/interface.go:73-125).

Methods raise `NotFoundError` for missing keys and return bytes for data:
the chunk store sizes every request at <= one 4 MiB block.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterator, Optional


class NotFoundError(KeyError):
    """Object does not exist (reference: os.ErrNotExist mapping)."""


@dataclass
class Obj:
    key: str
    size: int
    mtime: float = field(default_factory=time.time)
    is_dir: bool = False


@dataclass
class MultipartUpload:
    min_part_size: int
    max_count: int
    upload_id: str


@dataclass
class Part:
    num: int
    etag: str
    size: int


class ObjectStorage:
    def string(self) -> str:
        raise NotImplementedError

    def create(self) -> None:
        """Create the bucket/root if missing (reference interface.go Create)."""

    def get(self, key: str, off: int = 0, limit: int = -1) -> bytes:
        """Ranged read; limit < 0 means to EOF."""
        raise NotImplementedError

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Idempotent: deleting a missing key succeeds."""
        raise NotImplementedError

    def head(self, key: str) -> Obj:
        raise NotImplementedError

    def copy(self, dst: str, src: str) -> None:
        self.put(dst, self.get(src))

    def list_all(self, prefix: str = "", marker: str = "") -> Iterator[Obj]:
        """All keys with prefix, ordered, strictly after `marker`."""
        raise NotImplementedError

    def list(
        self, prefix: str = "", marker: str = "", limit: int = 1000
    ) -> list[Obj]:
        out = []
        for o in self.list_all(prefix, marker):
            out.append(o)
            if len(out) >= limit:
                break
        return out

    # multipart (reference interface.go:105-125); local stores emulate it
    def create_multipart_upload(self, key: str) -> Optional[MultipartUpload]:
        return None

    def upload_part(self, key: str, upload_id: str, num: int, data: bytes) -> Part:
        raise NotImplementedError

    def complete_upload(self, key: str, upload_id: str, parts: list[Part]) -> None:
        raise NotImplementedError

    def abort_upload(self, key: str, upload_id: str) -> None:
        pass

    def limits(self) -> dict:
        return {"min_part_size": 5 << 20, "max_part_count": 10000}
