"""A volume of the port as a configuration file states it, assembled by
the port's own `build_store` with the options its command line gives
(`gc` or `mount` and the file's flags).

The file's `meta`, `storage`, `cache` and `chunk_mib` are honoured or
refused: a value this harness cannot build raises before anything runs,
so a configuration never measures another deployment than it names."""

from __future__ import annotations

import argparse
import os

# meta engine -> its URL in the run's scratch directory
META_URLS = {"sqlite3": lambda workdir: f"sqlite3://{os.path.join(workdir, 'meta.db')}"}
# object stores that need no path or server (upstream pkg/object/mem.go)
STORAGES = ("mem",)
# block cache -> the chunk store's cache_dirs
CACHES = {"memory": ("memory",)}


def command_args(command: str, meta_url: str, flags: list, workdir: str):
    """The parsed options of the port's `command` with `flags`, defaults
    and all, as its command line would give them."""
    from juicefs_tpu_torch.cmd import gc, mount

    module = {"gc": gc, "mount": mount}[command]
    parser = argparse.ArgumentParser(prog="juicefs")
    module.add_parser(parser.add_subparsers())
    positional = [meta_url]
    if command == "mount":
        positional.append(os.path.join(workdir, "mnt"))  # never mounted
    return parser.parse_args([command, *positional, *flags])


def _refuse(cfg: dict, key: str, known) -> None:
    if cfg[key] not in known:
        raise ValueError(f"configuration {cfg['name']!r}: {key} {cfg[key]!r} is not one "
                         f"this harness builds ({sorted(known)})")


def open_volume(cfg: dict, workdir: str, with_indexer: bool):
    """Format the volume, open its meta and build its chunk store.
    Returns (meta, format, store, parsed command options)."""
    from juicefs_tpu_torch.cmd import build_store
    from juicefs_tpu_torch.meta import new_client
    from juicefs_tpu_torch.meta.types import CHUNK_SIZE, Format

    _refuse(cfg, "meta", META_URLS)
    _refuse(cfg, "storage", STORAGES)
    _refuse(cfg, "cache", CACHES)
    if cfg["chunk_mib"] << 20 != CHUNK_SIZE:
        raise ValueError(f"configuration {cfg['name']!r}: chunk_mib {cfg['chunk_mib']}; "
                         f"the port's chunk is fixed at {CHUNK_SIZE >> 20} MiB")
    url = META_URLS[cfg["meta"]](workdir)
    meta = new_client(url)
    fmt = Format(name=cfg["name"], storage=cfg["storage"], bucket=cfg["name"],
                 block_size=cfg["block_size_kib"],
                 compression="" if cfg["compression"] == "none" else cfg["compression"],
                 hash_backend=cfg["hash_backend"], trash_days=0)
    if meta.init(fmt, force=True) != 0:
        raise RuntimeError(f"formatting {url} failed")
    fmt = meta.load()
    flags = list(cfg["flags"])
    if cfg["command"] == "mount":
        flags += ["--cache-dir", ":".join(CACHES[cfg["cache"]])]
    args = command_args(cfg["command"], url, flags, workdir)
    store = build_store(fmt, args, meta=meta, with_indexer=with_indexer)
    if store.conf.cache_dirs != CACHES[cfg["cache"]]:
        store.close()
        raise ValueError(f"configuration {cfg['name']!r}: the store's cache is "
                         f"{store.conf.cache_dirs}, not {cfg['cache']!r}")
    return meta, fmt, store, args


def close_meta(meta) -> None:
    client = getattr(meta, "client", None)
    if client is not None:
        client.close()
