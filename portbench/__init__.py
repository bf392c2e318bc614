"""The benchmark of the PyTorch/CUDA port (`juicefs_tpu_torch`).

One run of one cell:

    python3 -m portbench.run --workload gc-cold.plain-4m --seed 7 --seconds 20 --trace 0

`BENCHMARK.json` at the checkout's root names the cells. Everything that
belongs to one configuration, traffic mix or per-layer metric is a file of
its own, found by name: `configs/<config>.json`, `traffic/<mix>.json`
(which names its load generator, `drivers/<driver>.py`) and
`metrics/<metric>.py`. The plain reference that decides `correct` is in
`reference/`. Nothing here imports `jax`, `jaxlib` or the JAX package.
"""
