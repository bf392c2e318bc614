"""Chunk layer of the port: block keys, the ordered parallel-fetch stage and
the hash-backend mapping. `CachedStore` and inline ingest are still to be
ported; `cmd/gc.py` takes any store with `_load_block` and `_bulk_pool`."""
