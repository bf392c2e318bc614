"""Device plane of the port: the counterpart of juicefs_tpu/tpu/.

  jth256.py     the normative JTH-256 spec (numpy copy) and batch packing
  hash_torch.py batched JTH-256: CUDA row-chain kernel + torch fold ops
  dedup.py      duplicate grouping over digest batches
  sharding.py   the multi-device (data x lane) plane every device consumer
                goes through: ShardPlane, get_plane
  pipeline.py   streaming host->device hash pipeline
  kernels/      CUDA sources and their loader (built at first launch)

Submodules are imported explicitly; this package imports none eagerly
(`ShardPlane` and `get_plane` load gpu/sharding.py at first use).
"""

__all__ = ["ShardPlane", "get_plane"]


def __getattr__(name):
    if name in __all__:
        from . import sharding

        return getattr(sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
