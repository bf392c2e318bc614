"""Command line of the port (a copy of juicefs_tpu/cmd/__init__.py;
reference: cmd/).

`python -m juicefs_tpu_torch.cmd <command>` runs the reference's 27
commands. Each command module exposes `add_parser(sub)` and a
`run(args)`.

Shared plumbing here: open the meta client, load the volume Format, build
the object store with its wrappers (prefix/shard — reference
cmd/mount.go:387 NewReloadableStorage), and assemble the chunk store with
its content indexer and content-ref plane.
"""

from __future__ import annotations

import argparse
import os
import sys

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
    if fmt.encrypt_key:
        from ..object import new_encrypted

        # encrypt_algo selects the body cipher (aes256gcm-rsa default,
        # aes256ctr-*); the key side (RSA-OAEP vs ECIES) follows the PEM
        store = new_encrypted(store, fmt.encrypt_key.encode(),
                              algo=fmt.encrypt_algo or "aes256gcm")
    return store


def chunk_conf(fmt: Format, args=None) -> ChunkConfig:
    """The chunk store's config from the volume Format and the command's
    options: the cache (`--cache-dir`, `--cache-size` MiB, `--writeback`),
    the write buffer bound (`--buffer-size` MiB), the bandwidth limits,
    the object-plane resilience knobs and the compress plane's backend,
    lanes and elision bypass."""
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
    # the write buffer bound (mount --buffer-size, MiB; 0 = none)
    if getattr(args, "buffer_size", None):
        conf.buffer_size = int(args.buffer_size) << 20
    # bandwidth shaping (qos/limiter.py): CLI limits are Mbps, the
    # config carries bytes/s
    if getattr(args, "upload_limit", None):
        conf.upload_limit = float(args.upload_limit) * 1e6 / 8
    if getattr(args, "download_limit", None):
        conf.download_limit = float(args.download_limit) * 1e6 / 8
    # object-plane resilience knobs (object/resilient.py)
    if getattr(args, "op_deadline", None):
        conf.op_deadline = float(args.op_deadline)
    if getattr(args, "attempt_timeout", None):
        conf.attempt_timeout = float(args.attempt_timeout)
    if getattr(args, "no_hedge", False):
        conf.hedge = False
    # batched compression plane + elision bypass
    if getattr(args, "compress_backend", None):
        conf.compress_backend = str(args.compress_backend)
    if getattr(args, "compress_lanes", None):
        conf.compress_lanes = int(args.compress_lanes)
    if getattr(args, "no_dedup_bypass", False):
        conf.dedup_bypass = False
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
    The ingest elision stage itself (`store.ingest`) is opt-in via
    `mount --inline-dedup`; it hashes with the volume's hash backend, and
    a volume formatted with none hashes on the card (the reference hashes
    it on the CPU). Read-only admin commands (fsck/gc) pass
    with_indexer=False: they need alias resolution but never upload."""
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
            if getattr(args, "inline_dedup", False):
                from ..chunk.indexer import pipeline_backend
                from ..chunk.ingest import IngestPipeline

                flush_ms = getattr(args, "ingest_flush_ms", None)
                if flush_ms is None:
                    flush_ms = 5.0  # explicit 0 means "flush immediately"
                store.ingest = IngestPipeline(
                    store,
                    store.content_refs,
                    backend=pipeline_backend(fmt.hash_backend or "cuda"),
                    flush_timeout=max(0.0, float(flush_ms)) / 1e3,
                    bypass=conf.dedup_bypass,
                )
    except BaseException:
        # a device backend with no card raises here: release the store's
        # pools instead of leaking them with the half-built store
        store.close()
        raise
    return store


def main(argv: list[str] | None = None) -> int:
    from . import (
        bench,
        config,
        dump,
        format as format_cmd,
        fsck,
        gateway,
        gc,
        info,
        meta_server,
        mount,
        objbench,
        quota,
        stats,
        sync,
        warmup,
    )

    parser = argparse.ArgumentParser(
        prog="juicefs-tpu-torch",
        description="JuiceFS-capability distributed file system, "
                    "content hashing on an NVIDIA GPU",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for mod in (
        format_cmd, mount, bench, objbench, gc, fsck, sync, dump, warmup,
        info, gateway, stats, quota, meta_server, config,
    ):
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


def fstab_shim(argv: list[str]) -> list[str]:
    """Translate mount(8) helper arguments into `mount` command args
    (reference cmd/main.go:107-121: /sbin/mount.juicefs shim).

    mount(8) invokes: mount.juicefs SPEC DIR [-sfnv] [-o opt1,opt2...]
    """
    spec, mountpoint = argv[0], argv[1]
    out = ["mount", spec, mountpoint]
    it = iter(argv[2:])
    for a in it:
        if a == "-o":
            for opt in next(it, "").split(","):
                if not opt or opt in ("rw", "defaults", "auto", "noauto",
                                      "user", "nouser", "exec", "noexec",
                                      "suid", "nosuid", "dev", "nodev",
                                      "_netdev"):
                    continue
                if opt == "ro":
                    out.append("--readonly")
                elif opt == "background":
                    out.append("-d")
                elif "=" in opt:
                    k, v = opt.split("=", 1)
                    out += [f"--{k.replace('_', '-')}", v]
                else:
                    out.append(f"--{opt.replace('_', '-')}")
        # -s/-f/-n/-v from mount(8) have no meaning here: ignore
    if "-d" not in out:
        out.append("-d")  # fstab mounts must daemonize
    return out


def cli_entry() -> None:
    if os.path.basename(sys.argv[0]).startswith("mount.") and len(sys.argv) >= 3:
        sys.exit(main(fstab_shim(sys.argv[1:])))
    sys.exit(main())
