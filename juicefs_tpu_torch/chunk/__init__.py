"""Chunk layer of the port (the counterpart of juicefs_tpu/chunk): the
cached block store with its writeback ladder, inline-dedup ingest, the
elision governor, singleflight, block keys, the ordered parallel-fetch
stage and the hash-backend mapping."""

from .bypass import ElisionGovernor  # noqa: F401
from .cached_store import CachedStore, ChunkConfig, block_key, parse_block_key  # noqa: F401
from .ingest import ContentRefs, IngestPipeline  # noqa: F401
from .singleflight import SingleFlight  # noqa: F401
