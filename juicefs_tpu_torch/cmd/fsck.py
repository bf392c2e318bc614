"""`fsck`: verify data integrity (a copy of juicefs_tpu/cmd/fsck.py;
reference cmd/fsck.go:75-230).

Lists `chunks/` objects, walks every slice from meta, and checks each
expected block exists with the right size. --verify-data additionally GETs
and decompresses every block and streams it through the JTH-256 pipeline
on the card, checking each digest against the one the write path recorded
in the meta content index: a mismatch is silent corruption (bitrot) that
an existence/size check cannot see. --hash-index writes the content index
as JSON.

Changes from the reference: `--compress-backend` (default cuda) picks where
the compress plane of the command's store runs, as it does for `mount`;
`--hash-backend` takes cpu | cuda (tpu | xla | pallas map to cuda), and the
cuda backend raises without a card; a volume formatted with no hash backend
is hashed on the card, not on the host.
"""

from __future__ import annotations

import json

from ..chunk.cached_store import block_key
from ..utils import get_logger

logger = get_logger("cmd.fsck")


def add_parser(sub):
    p = sub.add_parser("fsck", help="check volume integrity")
    p.add_argument("meta_url")
    p.add_argument("--verify-data", action="store_true",
                   help="GET + decompress + hash every block")
    p.add_argument("--hash-index", default="",
                   help="also hash every block; write content index JSON here")
    p.add_argument("--hash-backend", default=None,
                   help="cpu|cuda (tpu|xla|pallas map to cuda; default: "
                        "volume format hash_backend, cuda where it has none)")
    p.add_argument("--compress-backend", default="cuda", choices=["cpu", "cuda"],
                   help="where the compress plane of the command's store runs")
    p.set_defaults(func=run)


def run(args) -> int:
    from . import build_store, open_meta

    m, fmt = open_meta(args.meta_url)
    # meta-attached store: reads of PUT-elided blocks resolve through the
    # content-ref plane — without it every alias is "unreadable".
    # No indexer: fsck never uploads, and hashes through its own pipeline.
    store = build_store(fmt, args, meta=m, with_indexer=False)
    try:
        return _run(args, m, fmt, store)
    finally:
        store.close()


def _run(args, m, fmt, store) -> int:
    bs = fmt.block_size * 1024

    stored = {o.key: o.size for o in store.storage.list_all("chunks/")}
    slices = m.list_slices()

    # inline dedup: an elided block's bytes live under its canonical —
    # existence checks must translate through the alias plane
    try:
        from ..chunk.ingest import alias_map

        aliases = alias_map(m)
    except Exception:
        aliases = {}

    broken: list[str] = []
    checked = blocks = 0
    expected: dict[str, int] = {}
    for ino, slcs in slices.items():
        file_broken = False
        for s in slcs:
            if s.id == 0 or s.size == 0:
                continue
            for i in range((s.size + bs - 1) // bs):
                bsize = min(bs, s.size - i * bs)
                key = block_key(s.id, i, bsize)
                expected[key] = bsize
                blocks += 1
                if key not in stored and aliases.get(key, key) not in stored:
                    logger.error("ino %d: missing block %s", ino, key)
                    file_broken = True
                elif key not in stored:
                    pass  # deduped: bytes verified under the canonical key
                elif not fmt.compression and store.compressor.name == "" and stored[key] != bsize:
                    logger.error(
                        "ino %d: block %s size %d != %d", ino, key, stored[key], bsize
                    )
                    file_broken = True
        checked += 1
        if file_broken:
            broken.append(str(ino))

    if args.verify_data or args.hash_index:
        from ..chunk.indexer import pipeline_backend
        from ..gpu.jth256 import LANE_BYTES, digest_hex
        from ..gpu.pipeline import HashPipeline, PipelineConfig

        # a volume formatted without a hash backend is verified on the
        # card too: only an explicit cpu hashes on the host
        backend = pipeline_backend(args.hash_backend or fmt.hash_backend or "cuda")
        pipe = HashPipeline(
            PipelineConfig(backend=backend, pad_lanes=max(1, bs // LANE_BYTES))
        )
        # Digests recorded by the write path (meta content index): a block
        # whose recomputed digest disagrees is silent corruption the
        # reference's existence/size fsck cannot see.
        recorded = {
            block_key(sid, indx, bsize): digest
            for sid, indx, bsize, digest in m.scan_block_digests()
        }

        def readable():
            for key, bsize in expected.items():
                if key not in stored and key not in aliases:
                    continue  # reported missing above; nothing to read
                try:
                    yield key, store._load_block(key, bsize, cache_after=False)
                except Exception as e:
                    logger.error("block %s unreadable: %s", key, e)
                    broken.append(key)

        bitrot = 0
        index = {}
        for k, d in pipe.hash_stream(readable()):
            index[k] = digest_hex(d)
            want = recorded.get(k)
            if want is not None and want != d:
                logger.error("block %s content digest mismatch (bitrot?)", k)
                broken.append(k)
                bitrot += 1
        if args.hash_index:
            with open(args.hash_index, "w") as f:
                json.dump(index, f, indent=1)
        print(
            f"verified {len(index)} blocks ({backend}); "
            f"{len(recorded)} indexed, {bitrot} digest mismatches"
        )

    print(f"checked {checked} files / {blocks} blocks; {len(broken)} broken")
    return 1 if broken else 0
