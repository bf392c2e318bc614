"""`format`: create/overwrite a volume (a copy of juicefs_tpu/cmd/format.py;
reference cmd/format.go).

Writes the Format JSON into the meta engine and smoke-tests the object
store with a put/get/delete round trip, as the reference does.

`--hash-backend` keeps the reference's choices, so a volume formatted here
also opens in the JAX package. Changes from the reference: a device hash
backend (tpu | xla | pallas: the card, for the port) is probed with a
pageable host-to-card copy, and with no card `format` fails instead of
warning and formatting a volume whose writers would hash on the CPU.
`--encrypt-rsa-key` stores the PEM key in the Format, and every client
then envelope-encrypts the volume's objects (object/encrypt.py, which
needs the `cryptography` package).
"""

from __future__ import annotations

import time

from ..meta import new_client
from ..meta.types import Format
from ..utils import get_logger

logger = get_logger("cmd.format")

DEVICE_BACKENDS = ("tpu", "xla", "pallas")


def add_parser(sub):
    p = sub.add_parser("format", help="format a volume")
    p.add_argument("meta_url", help="meta engine address (sqlite3://..., mem://)")
    p.add_argument("name", help="volume name")
    p.add_argument("--storage", default="file", help="object store scheme")
    p.add_argument("--bucket", default="", help="bucket / base path")
    p.add_argument("--block-size", type=int, default=4096, help="block size KiB")
    p.add_argument("--compress", default="", choices=["", "none", "lz4", "zstd"])
    p.add_argument("--shards", type=int, default=0)
    p.add_argument("--capacity", type=int, default=0, help="capacity GiB (0=unlimited)")
    p.add_argument("--inodes", type=int, default=0)
    p.add_argument("--trash-days", type=int, default=1)
    p.add_argument("--enable-acl", action="store_true",
                   help="enable POSIX ACLs (system.posix_acl_* xattrs)")
    p.add_argument("--hash-backend", default="",
                   choices=["", "none", "cpu", "tpu", "xla", "pallas"],
                   help="fingerprint every written block into the meta "
                        "content index using this hash plane (tpu, xla "
                        "and pallas all hash on the CUDA card)")
    p.add_argument("--encrypt-rsa-key", default="",
                   help="PEM private key path (RSA -> OAEP wrap, EC P-256 "
                        "-> ECIES wrap)")
    p.add_argument("--encrypt-algo", default=None,
                   choices=["aes256gcm-rsa", "aes256ctr-rsa"],
                   help="object body cipher (reference encrypt.go variants); "
                        "requires --encrypt-rsa-key")
    p.add_argument("--force", action="store_true", help="overwrite existing format")
    p.set_defaults(func=run)


def run(args) -> int:
    fmt = Format(
        name=args.name,
        storage=args.storage,
        bucket=args.bucket,
        block_size=args.block_size,
        compression="" if args.compress == "none" else args.compress,
        shards=args.shards,
        capacity=args.capacity << 30,
        inodes=args.inodes,
        trash_days=args.trash_days,
        enable_acl=args.enable_acl,
        hash_backend="" if args.hash_backend == "none" else args.hash_backend,
    )
    if args.encrypt_algo and not args.encrypt_rsa_key:
        logger.error("--encrypt-algo has no effect without --encrypt-rsa-key")
        return 1
    if args.encrypt_rsa_key:
        with open(args.encrypt_rsa_key) as f:
            fmt.encrypt_key = f.read()
        fmt.encrypt_algo = args.encrypt_algo or "aes256gcm-rsa"

    # before anything is written: a device backend needs the card
    if fmt.hash_backend in DEVICE_BACKENDS:
        probe_device_bandwidth(fmt.hash_backend)

    from . import storage_for

    store = storage_for(fmt)
    store.create()
    # object store smoke test (reference format.go test() round trip)
    probe = "testing/probe"
    store.put(probe, b"juicefs-tpu")
    if bytes(store.get(probe)) != b"juicefs-tpu":
        raise IOError("object storage probe read mismatch")
    store.delete(probe)

    m = new_client(args.meta_url)
    st = m.init(fmt, force=args.force)
    if st != 0:
        logger.error("init meta: errno %d", st)
        return 1
    print(f"volume {args.name} formatted: meta={args.meta_url} "
          f"storage={fmt.storage}://{fmt.bucket} block={fmt.block_size}KiB")
    return 0


def probe_device_bandwidth(backend: str, probe_mb: int = 16) -> None:
    """Measured host->card sanity probe before opting a volume into a
    device hash backend: write-path fingerprinting streams every block to
    the card, so a thin host link makes the backend pointless for the
    foreground path (the indexer then drops and gc backfills). Prints the
    pageable copy's GiB/s and the card's name; raises without a card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--hash-backend {backend} hashes on a CUDA card and none is "
            "visible; use --hash-backend cpu on this host")
    name = torch.cuda.get_device_name(0)
    buf = torch.zeros(probe_mb << 20, dtype=torch.uint8)
    dev = torch.empty_like(buf, device="cuda")
    dev.copy_(buf)  # warm: allocator + context setup
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev.copy_(buf)
    torch.cuda.synchronize()
    gibs = probe_mb / 1024 / (time.perf_counter() - t0)
    print(f"hash backend {backend}: h2d probe {gibs:.3f} GiB/s "
          f"({probe_mb} MiB pageable) on {name}")
    if gibs < 1.0:
        logger.warning(
            "--hash-backend %s: host->card bandwidth measured at %.3f GiB/s "
            "(%s) — far below block-write rates, so the write-path indexer "
            "will mostly drop-and-backfill; consider --hash-backend cpu for "
            "this host", backend, gibs, name,
        )
