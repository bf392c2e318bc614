"""Batched JTH-256 in PyTorch: the counterpart of juicefs_tpu/tpu/hash_jax.py.

The row chain, which reads every input word once and does nearly all of
the work, runs in the hand-written CUDA kernel `gpu/kernels/
jth256_row_chain.cu` (counterpart of the Pallas `_pallas_row_chain`). The
lane fold and combine (`lane_accs`, `combine_accs`, `fmix`, counterparts
of hash_jax.py:57-128) are torch ops on the same device.

`row_chain` runs the kernel for a CUDA tensor and its plain torch version
`row_chain_ref` only for a tensor on the CPU; it never falls back from the
card to the CPU. `device=None` means the card: without one it raises.

Torch has no right shift on uint32 on the CPU, and a right shift on int32
keeps the sign, so the torch ops carry words as int64 values in
[0, 2^32) and mask with 0xFFFFFFFF after every multiply, shift and add
(the low 32 bits of a wrapped int64 product are the uint32 product).
Words cross into the kernel as int32 tensors with the uint32 bits.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from . import kernels
from .jth256 import (
    COLS,
    IV,
    LANE_BYTES,
    ROWS,
    digests_to_bytes,
    pack_blocks,
)
from .jth256 import jth256 as _jth256_ref

MASK = 0xFFFFFFFF
_P1 = 0x9E3779B1
_P2 = 0x85EBCA77
_P3 = 0xC2B2AE3D
_P4 = 0x27D4EB2F
_P5 = 0x165667B1
_FM1 = 0x85EBCA6B
_FM2 = 0xC2B2AE35

VERIFY_SIZES = (0, 1, 100, LANE_BYTES, LANE_BYTES + 7, 3 * LANE_BYTES)

_LAST_KERNEL_MODE: str | None = None


def last_kernel_mode() -> str | None:
    """'cuda' | 'torch-cpu' for the most recent row_chain, else None."""
    return _LAST_KERNEL_MODE


def resolve_device(device=None) -> torch.device:
    """None means the card; without one that raises instead of running on
    the CPU. Pass device='cpu' to run the plain torch path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port does not fall back to the CPU; "
                "pass device='cpu' to run the plain torch path")
        return torch.device("cuda")
    return torch.device(device)


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * c) & MASK


def _rotl(x: torch.Tensor, k: int) -> torch.Tensor:
    return ((x << k) | (x >> (32 - k))) & MASK


def _widen(x: torch.Tensor) -> torch.Tensor:
    """32-bit words (any integer dtype) -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK


def _narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64-carried uint32 values."""
    x = x ^ (x >> 16)
    x = _mul(x, _FM1)
    x = x ^ (x >> 13)
    x = _mul(x, _FM2)
    return x ^ (x >> 16)


def _check_words(words_flat: torch.Tensor, m: int) -> None:
    if words_flat.dtype != torch.int32:
        raise TypeError(f"words must be int32 (uint32 bits), got {words_flat.dtype}")
    if words_flat.dim() != 3 or tuple(words_flat.shape[1:]) != (ROWS, COLS):
        raise ValueError(f"words must be (L, {ROWS}, {COLS}), got {tuple(words_flat.shape)}")
    if not words_flat.is_contiguous():
        raise ValueError("words must be contiguous")
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")


def row_chain_ref(words_flat: torch.Tensor, m: int, tweak: int = 0) -> torch.Tensor:
    """Plain torch row chain: int32 (L, 128, 128) -> int32 (L, 128) states.

    Lane l starts from s[j] = P5 ^ j*P1 ^ (l mod m)*P3 and takes 128 row
    steps s = (s ^ (W[r] ^ tweak))*P1; s = rotl(s,13)*P2; s ^= s>>15.
    """
    _check_words(words_flat, m)
    dev = words_flat.device
    lanes = torch.arange(words_flat.shape[0], dtype=torch.int64, device=dev) % m
    j = torch.arange(COLS, dtype=torch.int64, device=dev)
    s = _P5 ^ _mul(j, _P1)[None, :] ^ _mul(lanes, _P3)[:, None]
    tw = int(tweak) & MASK
    for r in range(ROWS):
        w = _widen(words_flat[:, r, :]) ^ tw
        s = _mul(s ^ w, _P1)
        s = _mul(_rotl(s, 13), _P2)
        s = s ^ (s >> 15)
    return _narrow(s)


def row_chain(words_flat: torch.Tensor, m: int, tweak: int = 0) -> torch.Tensor:
    """Row chain: int32 (L, 128, 128) -> int32 (L, 128) lane states.

    A CUDA tensor goes through the hand kernel (one launch, counted in
    kernels.LAUNCHES); a CPU tensor through `row_chain_ref`. Any other
    device raises.
    """
    global _LAST_KERNEL_MODE
    _check_words(words_flat, m)
    if words_flat.device.type == "cpu":
        _LAST_KERNEL_MODE = "torch-cpu"
        return row_chain_ref(words_flat, m, tweak)
    if words_flat.device.type != "cuda":
        raise ValueError(f"row_chain runs on cuda or cpu, not {words_flat.device}")
    n_lanes = words_flat.shape[0]
    out = torch.empty((n_lanes, COLS), dtype=torch.int32, device=words_flat.device)
    if n_lanes:
        fn = kernels.row_chain_function()
        with torch.cuda.device(words_flat.device):
            stream = torch.cuda.current_stream(words_flat.device).cuda_stream
            rc = fn(words_flat.data_ptr(), out.data_ptr(), n_lanes, m,
                    int(tweak) & MASK, stream)
        if rc != 0:
            raise RuntimeError(f"jth256_row_chain launch failed: CUDA error {rc}")
        kernels.LAUNCHES["jth256_row_chain"] += 1
    _LAST_KERNEL_MODE = "cuda"
    return out


def lane_accs(s: torch.Tensor) -> torch.Tensor:
    """Fold lane states (B, M, 128) -> per-lane digests (B, M, 8), int64."""
    s = _widen(s)
    b, m = s.shape[0], s.shape[1]
    dev = s.device
    lanes = torch.arange(m, dtype=torch.int64, device=dev)
    k8 = torch.arange(8, dtype=torch.int64, device=dev)
    g = s.reshape(b, m, 16, 8)
    acc = (_P4 ^ _mul(lanes, _P2)[:, None] ^ _mul(k8, _P1)[None, :]).expand(b, m, 8)
    for gi in range(16):
        acc = (_rotl(_mul(acc ^ g[:, :, gi, :], _P3), 11) + ((gi * _P5) & MASK)) & MASK
    return acc


def combine_accs(acc: torch.Tensor, lane_counts: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Sequentially combine per-lane digests (B, M, 8) -> digests (B, 8),
    int64; lanes at or past lane_counts[b] leave the state unchanged."""
    b, m = acc.shape[0], acc.shape[1]
    dev = acc.device
    k8 = torch.arange(8, dtype=torch.int64, device=dev)
    h = torch.tensor(IV.astype(np.int64), device=dev).expand(b, 8)
    counts = lane_counts.to(device=dev, dtype=torch.int64)
    for li in range(m):
        hn = (_rotl(_mul(h ^ acc[:, li, :], _P2), 17) + ((li * _P1) & MASK)) & MASK
        h = torch.where((counts > li)[:, None], hn, h)
    lens = lengths.to(device=dev, dtype=torch.int64) & MASK
    h = h ^ ((lens[:, None] + _mul(k8, _P4)[None, :]) & MASK)
    return fmix(h)


def _as_words(words, dev: torch.device) -> torch.Tensor:
    if isinstance(words, torch.Tensor):
        t = words if words.dtype == torch.int32 else words.view(torch.int32)
        return t.to(dev).contiguous()
    arr = np.ascontiguousarray(words)
    if arr.dtype.itemsize != 4:
        raise TypeError(f"words must hold 32-bit words, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32)).to(dev)


def _as_int64(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.int64)
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)


def hash_device(words: torch.Tensor, lane_counts: torch.Tensor,
                lengths: torch.Tensor, tweak: int = 0) -> torch.Tensor:
    """Digests of a packed batch already on its device: int32 words
    (B, M, 128, 128) -> int64 (B, 8) holding the uint32 digest words."""
    b, m = words.shape[0], words.shape[1]
    s = row_chain(words.reshape(b * m, ROWS, COLS), m, tweak).reshape(b, m, COLS)
    return combine_accs(lane_accs(s), lane_counts, lengths)


def digests_to_numpy(h: torch.Tensor) -> np.ndarray:
    return h.cpu().numpy().astype(np.uint32)


def hash_packed(words, lane_counts, lengths, device=None, tweak: int = 0) -> np.ndarray:
    """(B, M, 128, 128) words -> (B, 8) uint32 digests (numpy).

    Inputs are numpy arrays or tensors; they are moved to `device` (None:
    the card, which must exist). `tweak` xors a scalar into every word
    inside the row chain (0 hashes the words as they are)."""
    dev = resolve_device(device)
    h = hash_device(_as_words(words, dev), _as_int64(lane_counts, dev),
                    _as_int64(lengths, dev), tweak)
    return digests_to_numpy(h)


def make_hash_fn(impl: str = "cuda", device=None):
    """Return the (words, lane_counts, lengths) -> (B, 8) hash function."""
    if impl != "cuda":
        raise ValueError(f"unknown hash impl {impl!r} (want cuda)")
    return functools.partial(hash_packed, device=device)


def hash_blocks(blocks, device=None, pad_lanes: int | None = None) -> list[bytes]:
    """Hash a batch of bytes blocks on `device` (None: the card)."""
    blocks = list(blocks)
    if not blocks:
        return []
    words, counts, lengths = pack_blocks(blocks, pad_lanes=pad_lanes)
    return digests_to_bytes(hash_packed(words, counts, lengths, device=device))


def verify_backend(device=None, seed: int = 0,
                   sizes: Sequence[int] = VERIFY_SIZES) -> bool:
    """Self-check: digests on `device` byte-identical to the numpy spec."""
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in sizes]
    return hash_blocks(blocks, device=device) == [_jth256_ref(b) for b in blocks]
