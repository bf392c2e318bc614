"""Device plane of the port: the counterpart of juicefs_tpu/tpu/.

  jth256.py     the normative JTH-256 spec (numpy copy) and batch packing
  hash_torch.py batched JTH-256: CUDA row-chain kernel + torch fold ops
  dedup.py      duplicate grouping over digest batches
  pipeline.py   streaming host->device hash pipeline
  kernels/      CUDA sources and their loader (built at first launch)

Submodules are imported explicitly; this package imports none eagerly.
"""
