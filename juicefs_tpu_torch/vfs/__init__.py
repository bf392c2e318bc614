"""VFS core of the port (a copy of juicefs_tpu/vfs; reference: pkg/vfs).

The filesystem layer every presentation adapter (FUSE, S3 gateway, WebDAV,
SDK) serves: handle table, buffered slice-ordered DataWriter, readahead
DataReader, and the VFS facade tying them to the meta engine + chunk store.
"""

from .handles import Handle, HandleTable
from .reader import DataReader, FileReader
from .vfs import ROOT_INO, VFS, VFSConfig
from .writer import DataWriter, FileWriter

__all__ = [
    "VFS",
    "VFSConfig",
    "ROOT_INO",
    "Handle",
    "HandleTable",
    "DataReader",
    "FileReader",
    "DataWriter",
    "FileWriter",
]
