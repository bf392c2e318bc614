"""Bytes the ingest stage shipped to the card per byte it hashed in the
window: the driver's deltas of `juicefs_torch_h2d_bytes` over
`juicefs_torch_hash_bytes`. 1.0 for a pack sized to its blocks; a 128 KiB
block padded to the 4 MiB block size reads 32."""


def read(rec):
    w = rec["window"]
    if w.get("hash_bytes", 0) <= 0 or "h2d_bytes" not in w:
        return None
    return w["h2d_bytes"] / w["hash_bytes"]
