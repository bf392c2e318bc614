"""The benchmark's plain reference: a frozen NumPy copy of the JTH-256
spec (`jth256.py`) and plain-dict duplicate verdicts (`verdicts.py`).

It imports nothing of the program, of `jax` or of the JAX package, and
works only from the inputs the benchmark made (the seeded block bytes).
"""
