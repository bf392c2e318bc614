"""Hash-backend names of a volume's format, mapped onto the port's pipeline.

A volume formatted by the JAX package stores `hash_backend` as one of
"" | cpu | tpu | xla | pallas. The port reads such a volume as it stands:
every device name maps to the CUDA backend, "" (no content indexing) and
"cpu" to the numpy backend. No reference name is rejected. The
`BlockIndexer` write-path worker is still to be ported.
"""

from __future__ import annotations

_BACKENDS = {"": "cpu", "cpu": "cpu", "tpu": "cuda", "xla": "cuda",
             "pallas": "cuda", "cuda": "cuda"}


def pipeline_backend(hash_backend: str) -> str:
    """Map a Format.hash_backend value to a port HashPipeline backend."""
    try:
        return _BACKENDS[hash_backend]
    except KeyError:
        raise ValueError(
            f"unknown hash backend {hash_backend!r} "
            f"(want one of {sorted(_BACKENDS)})") from None
