"""juicefs_tpu_torch: the PyTorch/CUDA port of juicefs_tpu.

The port mirrors the reference package's layout (`gpu/` is the
counterpart of `tpu/`) and keeps its own copy of every helper it needs, so
it never imports `jax` or any `juicefs_tpu` module. Importing this package
loads no subpackage and builds no CUDA code: the row-chain kernel is
compiled from `gpu/kernels/` at its first launch.
"""

__all__: list[str] = []
