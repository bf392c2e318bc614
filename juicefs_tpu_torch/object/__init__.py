"""Object storage layer of the port: the contract, the file:// and mem://
stores, and the metering and resilience wrappers (copies of their
juicefs_tpu/object counterparts)."""

from .file import FileStorage
from .interface import (
    MultipartUpload,
    NotFoundError,
    Obj,
    ObjectStorage,
    Part,
    PermanentError,
    ThrottleError,
)
from .mem import MemStorage

__all__ = ["FileStorage", "MemStorage", "MultipartUpload", "NotFoundError",
           "Obj", "ObjectStorage", "Part", "PermanentError", "ThrottleError"]
