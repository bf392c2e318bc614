"""Command line of the port (a copy of juicefs_tpu/cmd/__init__.py;
reference: cmd/).

`python -m juicefs_tpu_torch.cmd <command>` runs the commands ported so
far: `format`, `gc`, `fsck` and `gateway`. Each command module exposes
`add_parser(sub)` and a `run(args)`.

Shared plumbing here: open the meta client, load the volume Format, build
the object store with its wrappers (prefix/shard — reference
cmd/mount.go:387 NewReloadableStorage), and assemble the chunk store with
its content indexer and content-ref plane.
"""

from __future__ import annotations

import argparse

from ..chunk import CachedStore, ChunkConfig
from ..meta import new_client
from ..meta.types import Format
from ..object import create_storage, sharded, with_prefix
from ..utils import get_logger

logger = get_logger("cmd")


def open_meta(addr: str, **kw):
    m = new_client(addr, **kw)
    fmt = m.load()
    return m, fmt


def storage_for(fmt: Format):
    """Build the blob store stack from a volume Format (reference
    cmd/mount.go:387 + pkg/object wrappers)."""
    if fmt.encrypt_key:
        # object/encrypt.py (and the cryptography package it needs) is not
        # ported: an encrypted volume cannot be opened by the port
        raise ValueError("invalid object storage: encrypted volumes need "
                         "object/encrypt.py, which the port does not have")
    bucket = fmt.bucket or ""
    scheme = fmt.storage or "file"
    if fmt.shards > 1:
        stores = [
            create_storage(f"{scheme}://{bucket}{i:02d}") for i in range(fmt.shards)
        ]
        store = sharded(stores)
    else:
        uri = f"{scheme}://{bucket}" if "://" not in bucket else bucket
        store = create_storage(uri)
    # Keep volume objects namespaced like the reference ({name}/ prefix)
    if scheme not in ("mem",):
        store = with_prefix(store, fmt.name + "/")
    return store


def chunk_conf(fmt: Format, args=None) -> ChunkConfig:
    """The chunk store's config from the volume Format and the options of
    the ported commands (`--cache-dir`, `--cache-size` MiB, `--writeback`,
    `--compress-backend`). The reference's other mount options (limits,
    resilience knobs, compress lanes, the dedup bypass) come with `mount`."""
    cache_dirs = ("memory",)
    writeback = False
    if args is not None:
        if getattr(args, "cache_dir", None):
            cache_dirs = tuple(str(args.cache_dir).split(":"))
        writeback = bool(getattr(args, "writeback", False))
    conf = ChunkConfig(
        block_size=fmt.block_size * 1024,
        compress=fmt.compression,
        cache_dirs=cache_dirs,
        writeback=writeback,
    )
    if getattr(args, "cache_size", None):
        conf.cache_size = int(args.cache_size) << 20
    if getattr(args, "compress_backend", None):
        conf.compress_backend = str(args.compress_backend)
    return conf


def build_store(fmt: Format, args=None, meta=None,
                with_indexer: bool = True) -> CachedStore:
    """Assemble the chunk store; with `meta` and a volume hash_backend,
    every uploaded block is fingerprinted into the meta content index by a
    `BlockIndexer` (the write-path hashing seam, role-match to the
    reference upload hook pkg/chunk/cached_store.go:371-413). A device
    hash backend (tpu | xla | pallas) hashes on the card and raises
    without one.

    Any meta-attached store also gets the content-ref plane: reads resolve
    elided blocks through aliases and deletes decref — required for
    correctness on any volume an inline-dedup writer may have written to.
    The ingest elision stage itself (`store.ingest`) comes with `mount`'s
    --inline-dedup, which is not ported. Read-only admin commands
    (fsck/gc) pass with_indexer=False: they need alias resolution but
    never upload."""
    conf = chunk_conf(fmt, args)
    store = CachedStore(storage_for(fmt), conf)
    try:
        # bulk commands (gc --threads) run at BACKGROUND class; widen the
        # shared lanes so the command's fetch window can actually go that
        # deep — foreground config (max_download) is left untouched
        threads = int(getattr(args, "threads", 0) or 0)
        if threads > 0:
            store.scheduler.widen("download", threads)
            store.scheduler.widen("bulk", threads)
        if meta is not None:
            from ..chunk.ingest import ContentRefs

            store.content_refs = ContentRefs(meta)
            if fmt.hash_backend and with_indexer:
                from ..chunk.indexer import BlockIndexer, pipeline_backend

                store.indexer = BlockIndexer(
                    meta=meta,
                    backend=pipeline_backend(fmt.hash_backend),
                    block_size=conf.block_size,
                    device=conf.device,
                )
                conf.fingerprint = store.indexer.submit
    except BaseException:
        # a device backend with no card raises here: release the store's
        # pools instead of leaking them with the half-built store
        store.close()
        raise
    return store


def main(argv: list[str] | None = None) -> int:
    from . import format as format_cmd, fsck, gateway, gc

    parser = argparse.ArgumentParser(
        prog="juicefs-tpu-torch",
        description="JuiceFS-capability distributed file system, "
                    "content hashing on an NVIDIA GPU",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for mod in (format_cmd, gc, fsck, gateway):
        mod.add_parser(sub)
    args = parser.parse_args(argv)
    try:
        return args.func(args) or 0
    except KeyboardInterrupt:
        return 130
    except BrokenPipeError:
        return 0  # output piped into head/less that exited early
    except Exception as e:
        logger.error("%s: %s", args.command, e)
        return 1
