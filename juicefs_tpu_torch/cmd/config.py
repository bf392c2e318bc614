"""`config`: show or change volume settings (a copy of
juicefs_tpu/cmd/config.py; reference cmd/config.go).

The Format record lives in the meta engine; changes here propagate to
every live client through the session refresher's hot-reload check
(meta/base.py _check_reload — reference OnReload interface.go:445).

`--hash-backend` keeps the reference's choices, so the record stays
readable by both packages. Change from the reference: a device backend
(tpu | xla | pallas: the card, for the port) runs `format`'s probe first,
and with no card `config` fails before the record is rewritten.
"""

from __future__ import annotations

import json

from ..utils import get_logger
from .format import DEVICE_BACKENDS, probe_device_bandwidth

logger = get_logger("cmd.config")


def add_parser(sub):
    p = sub.add_parser("config", help="show / change volume settings")
    p.add_argument("meta_url")
    p.add_argument("--trash-days", type=int, default=None)
    p.add_argument("--capacity", type=int, default=None, help="GiB (0=unlimited)")
    p.add_argument("--inodes", type=int, default=None, help="0=unlimited")
    p.add_argument("--hash-backend", default=None,
                   choices=["", "none", "cpu", "tpu", "xla", "pallas"])
    import argparse as _argparse

    p.add_argument("--enable-acl", dest="enable_acl", default=None,
                   action=_argparse.BooleanOptionalAction,
                   help="--enable-acl / --no-enable-acl")
    p.set_defaults(func=run)


def run(args) -> int:
    from . import open_meta

    m, fmt = open_meta(args.meta_url)
    changes = {}
    if args.trash_days is not None:
        changes["trash_days"] = args.trash_days
    if args.capacity is not None:
        changes["capacity"] = args.capacity << 30
    if args.inodes is not None:
        changes["inodes"] = args.inodes
    if args.hash_backend is not None:
        changes["hash_backend"] = (
            "" if args.hash_backend == "none" else args.hash_backend
        )
    if args.enable_acl is not None:
        changes["enable_acl"] = args.enable_acl

    if not changes:
        print(fmt.remove_secret().to_json())
        return 0

    if changes.get("hash_backend") in DEVICE_BACKENDS:
        probe_device_bandwidth(changes["hash_backend"])
    for k, v in changes.items():
        setattr(fmt, k, v)
    if "hash_backend" in changes and changes["hash_backend"]:
        # hash_backend is v2-gated: Format.from_json drops an explicit
        # value on v1 records, so the opt-in must bump the version or it
        # silently never takes effect
        fmt.meta_version = max(fmt.meta_version, 2)
    st = m.init(fmt, force=True)  # same-uuid overwrite of the record
    if st:
        print(f"config update: errno {st}")
        return 1
    print(json.dumps({"updated": sorted(changes)}))
    return 0
