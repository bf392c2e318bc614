"""Object storage layer of the port: the contract plus the file:// and mem://
stores (copies of their juicefs_tpu/object counterparts)."""

from .file import FileStorage
from .interface import MultipartUpload, NotFoundError, Obj, ObjectStorage, Part
from .mem import MemStorage

__all__ = ["FileStorage", "MemStorage", "MultipartUpload", "NotFoundError",
           "Obj", "ObjectStorage", "Part"]
