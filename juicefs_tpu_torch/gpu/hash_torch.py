"""Batched JTH-256 in PyTorch: the counterpart of juicefs_tpu/tpu/hash_jax.py.

A hash batch on the card is one launch of a hand-written CUDA kernel:
the row chain with the lane fold and the per-block combine in its
epilogue (`gpu/kernels/jth256_row_chain.cu`, entry `jth256_block_digests`,
counterpart of the Pallas `_pallas_row_chain` with `_lane_accs`,
`_combine_accs` and `_fmix`). An ingest hash batch, whose words the
compress plane estimates too, takes the entry that also estimates them
(`jth256_block_digests_estimate`, `hash_estimate_device`). A batch of
short blocks (at most `kernels.CTA_BLOCK_LANES` lanes each) takes either
entry's one-CTA design, a block in one CTA (`kernels.block_entry`). A
lane shard of a mesh holds only part of each block, so it runs the entry
that stops after the lane fold (`jth256_lane_digests`, `chain_digests`),
and the mesh combines the gathered lane digests with
`gpu/kernels/jth256_combine.cu` (`combine`). Each row-chain launch takes
the ring depth `kernels.ring_depth` picks for its lane count on its card.

Every wrapper launches its kernel for a CUDA tensor and runs its plain
torch version only for a tensor on the CPU: `row_chain_ref`,
`chain_digests_ref` (= `row_chain_ref` + `lane_accs`) and `combine_accs`
(with `fmix`), counterparts of hash_jax.py:57-128. It never falls back
from the card to the CPU. `device=None` means the card: without one it
raises. `row_chain` (the lane states) is the plain version alone: no
entry of the kernel writes the states out.

Torch has no right shift on uint32 on the CPU, and a right shift on int32
keeps the sign, so the torch ops carry words as int64 values in
[0, 2^32) and mask with 0xFFFFFFFF after every multiply, shift and add
(the low 32 bits of a wrapped int64 product are the uint32 product).
Words and per-lane digests cross into the kernels as int32 tensors with
the uint32 bits.
"""

from __future__ import annotations

import contextlib
import functools
import threading
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
_LAST_FOLD_MODE: str | None = None


def last_kernel_mode() -> str | None:
    """'cuda' | 'torch-cpu' for the most recent row chain (`row_chain`,
    `chain_digests` or `hash_device`), else None."""
    return _LAST_KERNEL_MODE


def last_fold_mode() -> str | None:
    """How the most recent fold ran, else None: 'cuda' (the row chain's
    epilogue or the combine kernel), 'torch-cpu' (the plain versions on
    the CPU) or 'torch-cuda' (a plain `lane_accs`/`combine_accs` given a
    CUDA tensor: only a comparison with the kernels does that)."""
    return _LAST_FOLD_MODE


def _plain_fold(x: torch.Tensor) -> None:
    global _LAST_FOLD_MODE
    _LAST_FOLD_MODE = "torch-cuda" if x.device.type == "cuda" else "torch-cpu"


def cuda_device_count() -> int:
    """The number of local cards; without one this raises instead of
    running on the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device: the port does not fall back to the CPU; "
            "pass device='cpu' to run the plain torch path")
    return n


def resolve_device(device=None) -> torch.device:
    """None means the card; without one that raises instead of running on
    the CPU. Pass device='cpu' to run the plain torch path."""
    if device is None:
        cuda_device_count()
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


def row_chain_ref(words_flat: torch.Tensor, m: int, tweak: int = 0,
                  lane_offset: int = 0) -> torch.Tensor:
    """Plain torch row chain: int32 (L, 128, 128) -> int32 (L, 128) states.

    Lane l starts from s[j] = P5 ^ j*P1 ^ (lane_offset + l mod m)*P3 and
    takes 128 row steps s = (s ^ (W[r] ^ tweak))*P1; s = rotl(s,13)*P2;
    s ^= s>>15. `lane_offset` gives a device holding lanes
    [lane_offset, lane_offset + m) of each block their global indices.
    """
    _check_words(words_flat, m)
    dev = words_flat.device
    # _mul keeps the low 32 bits, so an offset past 2^32 wraps as in uint32
    lanes = torch.arange(words_flat.shape[0], dtype=torch.int64, device=dev) % m + lane_offset
    j = torch.arange(COLS, dtype=torch.int64, device=dev)
    s = _P5 ^ _mul(j, _P1)[None, :] ^ _mul(lanes, _P3)[:, None]
    tw = int(tweak) & MASK
    for r in range(ROWS):
        w = _widen(words_flat[:, r, :]) ^ tw
        s = _mul(s ^ w, _P1)
        s = _mul(_rotl(s, 13), _P2)
        s = s ^ (s >> 15)
    return _narrow(s)


def _cuda_words(words: torch.Tensor, entry: str) -> None:
    if words.device.type != "cuda":
        raise ValueError(f"{entry} runs on cuda or cpu, not {words.device}")
    if words.data_ptr() % 16:
        raise ValueError("words must start on a 16-byte boundary (TMA bulk copies)")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_rc(entry: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


# per (entry, lanes a CTA, card): the SM count and the entry's resident
# CTAs an SM at each ring depth, read once
_RING_TABLES: dict[tuple[str, int, int], tuple[int, dict[int, int]]] = {}


def _ring(entry: str, dev: torch.device, n_lanes: int, m: int) -> tuple[int, int]:
    """(depth, waves) of a row-chain launch of `entry` over n_lanes lanes,
    m a block, on the card `dev`, by `kernels.ring_depth`; called with
    `dev` current. A cross-CTA block entry's ring also holds a block's
    lane digests (32 B a lane) for its combine; a one-CTA entry's CTA
    holds a block's m lanes, each with a ring of 8 KiB chunks."""
    cta = kernels.is_cta_entry(entry)
    per_cta = m if cta else 1
    table = _RING_TABLES.get((entry, per_cta, dev.index))
    if table is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        table = _RING_TABLES[entry, per_cta, dev.index] = (
            sms, kernels.row_chain_occupancy(entry, per_cta))
    sms, ctas = table
    if cta:
        depth = kernels.ring_depth(n_lanes, sms, ctas, lanes_per_cta=per_cta,
                                   chunk_bytes=kernels.CTA_CHUNK_BYTES)
    else:
        staged = 0 if entry == "jth256_lane_digests" else m * kernels.LANE_DIGEST_BYTES
        depth = kernels.ring_depth(n_lanes, sms, ctas, staged)
    if ctas.get(depth, 0) < 1:
        raise ValueError(f"{entry}: blocks of {m} lanes outgrow the row chain's deepest "
                         f"ring ({max(ctas)} chunks)")
    return depth, kernels.waves(n_lanes // per_cta, sms, ctas[depth])


def row_chain(words_flat: torch.Tensor, m: int, tweak: int = 0,
              lane_offset: int = 0) -> torch.Tensor:
    """Row chain: int32 (L, 128, 128) -> int32 (L, 128) lane states, lane l
    hashing as lane `lane_offset + l mod m` of its block.

    The plain version on a CPU tensor. No kernel entry writes the states
    out (the card folds them in the chain's epilogue): a CUDA tensor
    raises, and `chain_digests` is its kernel path.
    """
    global _LAST_KERNEL_MODE
    _check_words(words_flat, m)
    if words_flat.device.type != "cpu":
        raise ValueError(f"row_chain runs on the cpu only, not {words_flat.device}: on "
                         "the card use chain_digests (the row chain with its lane fold)")
    _LAST_KERNEL_MODE = "torch-cpu"
    return row_chain_ref(words_flat, m, tweak, lane_offset)


def _fold(s: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """Lane fold of int64 states (..., 128) whose lane indices are `lanes`
    (broadcast against the leading dims) -> int64 (..., 8)."""
    k8 = torch.arange(8, dtype=torch.int64, device=s.device)
    g = s.reshape(*s.shape[:-1], 16, 8)
    acc = _P4 ^ _mul(lanes, _P2)[..., None] ^ _mul(k8, _P1)
    for gi in range(16):
        acc = (_rotl(_mul(acc ^ g[..., gi, :], _P3), 11) + ((gi * _P5) & MASK)) & MASK
    return acc


def lane_accs(s: torch.Tensor, lane_offset: int = 0) -> torch.Tensor:
    """Plain lane fold: states (B, M, 128) -> per-lane digests (B, M, 8),
    int64; the M lanes are lanes [lane_offset, lane_offset + M) of each
    block."""
    _plain_fold(s)
    m = s.shape[1]
    lanes = torch.arange(lane_offset, lane_offset + m, dtype=torch.int64, device=s.device)
    return _fold(_widen(s), lanes[None, :])


def chain_digests_ref(words_flat: torch.Tensor, m: int, tweak: int = 0,
                      lane_offset: int = 0) -> torch.Tensor:
    """Plain row chain + lane fold: int32 (L, 128, 128) -> int32 (L, 8)
    per-lane digests, lane l folding as lane `lane_offset + l mod m`."""
    s = row_chain_ref(words_flat, m, tweak, lane_offset)
    _plain_fold(s)
    lanes = torch.arange(s.shape[0], dtype=torch.int64, device=s.device) % m + lane_offset
    return _narrow(_fold(_widen(s), lanes))


def chain_digests(words_flat: torch.Tensor, m: int, tweak: int = 0,
                  lane_offset: int = 0) -> torch.Tensor:
    """Row chain and lane fold: int32 (L, 128, 128) -> int32 (L, 8) per-lane
    digests (uint32 bits), lane l hashing as lane `lane_offset + l mod m`.

    A CUDA tensor goes through the row-chain kernel's digests epilogue (one
    launch, counted under jth256_row_chain and jth256_lane_digests); a CPU
    tensor through `chain_digests_ref`. Any other device raises.
    """
    global _LAST_KERNEL_MODE, _LAST_FOLD_MODE
    _check_words(words_flat, m)
    if words_flat.device.type == "cpu":
        _LAST_KERNEL_MODE = "torch-cpu"
        return chain_digests_ref(words_flat, m, tweak, lane_offset)
    entry = "jth256_lane_digests"
    _cuda_words(words_flat, entry)
    n_lanes = words_flat.shape[0]
    out = torch.empty((n_lanes, 8), dtype=torch.int32, device=words_flat.device)
    if n_lanes:
        fn = kernels.function(entry)
        with torch.cuda.device(words_flat.device):
            depth, _ = _ring(entry, words_flat.device, n_lanes, m)
            _check_rc(entry, fn(words_flat.data_ptr(), out.data_ptr(), n_lanes, m,
                                int(lane_offset) & MASK, int(tweak) & MASK, depth,
                                _stream(words_flat.device)))
        kernels.LAUNCHES["jth256_row_chain"] += 1
        kernels.LAUNCHES[entry] += 1
    _LAST_KERNEL_MODE = _LAST_FOLD_MODE = "cuda"
    return out


def combine_accs(acc: torch.Tensor, lane_counts: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Plain combine: per-lane digests (B, M, 8) (int64, or int32 with the
    uint32 bits) -> digests (B, 8), int64; lanes at or past lane_counts[b]
    leave the state unchanged."""
    _plain_fold(acc)
    acc = _widen(acc)
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


def combine(acc: torch.Tensor, lane_counts: torch.Tensor,
            lengths: torch.Tensor) -> torch.Tensor:
    """Per-block combine: int32 per-lane digests (B, M, 8) with int64
    lane_counts and lengths (B,) on the same device -> int64 (B, 8)
    holding the uint32 digest words.

    A CUDA tensor goes through the combine kernel (one launch, counted
    under jth256_combine); a CPU tensor through `combine_accs`. Any other
    device raises.
    """
    global _LAST_FOLD_MODE
    if acc.dtype != torch.int32 or acc.dim() != 3 or acc.shape[1] < 1 or acc.shape[2] != 8:
        raise ValueError(f"per-lane digests must be int32 (B, M >= 1, 8), got "
                         f"{acc.dtype} {tuple(acc.shape)}")
    if acc.device.type == "cpu":
        return combine_accs(acc, lane_counts, lengths)
    if acc.device.type != "cuda":
        raise ValueError(f"combine runs on cuda or cpu, not {acc.device}")
    b, m = acc.shape[0], acc.shape[1]
    dev = acc.device
    acc = acc.contiguous()
    counts = lane_counts.to(device=dev, dtype=torch.int64).contiguous()
    lens = lengths.to(device=dev, dtype=torch.int64).contiguous()
    if counts.shape != (b,) or lens.shape != (b,):
        raise ValueError(f"lane_counts and lengths must be ({b},), got "
                         f"{tuple(counts.shape)} and {tuple(lens.shape)}")
    out = torch.empty((b, 8), dtype=torch.int64, device=dev)
    if b:
        fn = kernels.function("jth256_combine")
        with torch.cuda.device(dev):
            _check_rc("jth256_combine", fn(acc.data_ptr(), counts.data_ptr(), lens.data_ptr(),
                                           out.data_ptr(), b, m, _stream(dev)))
        kernels.LAUNCHES["jth256_combine"] += 1
    _LAST_FOLD_MODE = "cuda"
    return out


def _as_words(words, dev: torch.device) -> torch.Tensor:
    """Packed words (a numpy array or a tensor of 32-bit words) as an int32
    tensor on `dev`. A tensor bound for a card is copied without blocking,
    so the upload of a pinned staging slot queues behind earlier batches'
    work instead of waiting for it."""
    if isinstance(words, torch.Tensor):
        t = words if words.dtype == torch.int32 else words.view(torch.int32)
        return t.to(dev, non_blocking=dev.type == "cuda").contiguous()
    arr = np.ascontiguousarray(words)
    if arr.dtype.itemsize != 4:
        raise TypeError(f"words must hold 32-bit words, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32)).to(dev)


def _as_int64(a, dev: torch.device) -> torch.Tensor:
    """Lane counts or lengths as an int64 tensor on `dev` (a tensor bound
    for a card is copied without blocking, as `_as_words` does)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.int64, non_blocking=dev.type == "cuda")
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)


def lane_digests(words: torch.Tensor, tweak: int = 0,
                 lane_offset: int = 0) -> torch.Tensor:
    """Per-lane digests of packed words on their device: int32 (B, M, 128,
    128), lanes [lane_offset, lane_offset + M) of each block -> int32
    (B, M, 8) with the uint32 bits. One launch on the card."""
    b, m = words.shape[0], words.shape[1]
    d = chain_digests(words.reshape(b * m, ROWS, COLS), m, tweak, lane_offset)
    return d.reshape(b, m, 8)


# Arrival counters of the kernels whose last CTA to arrive finishes a block
# (the block entries; the compress histogram, whose counts sit beside them;
# the estimating block entry's counts),
# one zeroed int32 buffer per (entry, card, stream) with the blocks it
# holds: every launch leaves its workspace at zero, and launches on one
# stream run in order, so the pipeline's host threads can share a stream's
# buffer; two streams never share one.
_ARRIVALS: dict[tuple[str, int, int], tuple[torch.Tensor, int]] = {}
_ARRIVALS_LOCK = threading.Lock()


def zeroed_workspace(entry: str, dev: torch.device, stream: int, n_blocks: int,
                     per_block: int = 1) -> torch.Tensor:
    """The stream's workspace of `entry`: a flat zeroed int32 buffer of
    `per_block` words for each of at least n_blocks blocks. A larger batch
    gets a new zeroed buffer, allocated and zeroed on the same stream, so
    it is ready only after the launches queued on the old one. Only growth
    takes the lock: a buffer once published is never changed by the host."""
    key = (entry, dev.index, stream)
    held = _ARRIVALS.get(key)
    if held is not None and held[1] >= n_blocks:
        return held[0]
    with _ARRIVALS_LOCK:
        held = _ARRIVALS.get(key)
        if held is None or held[1] < n_blocks:
            size = max(n_blocks, 2 * (0 if held is None else held[1]), 32)
            held = (torch.zeros(size * per_block, dtype=torch.int32, device=dev), size)
            _ARRIVALS[key] = held
        return held[0]


def _arrivals(dev: torch.device, stream: int, n_blocks: int) -> torch.Tensor:
    """The block entry's counters on the stream, at least n_blocks of them."""
    return zeroed_workspace("jth256_block_digests", dev, stream, n_blocks)


def _int64_on(a: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`a` as a contiguous int64 tensor on `dev`; itself when it is one."""
    if a.device == dev and a.dtype == torch.int64 and a.is_contiguous():
        return a
    return a.to(device=dev, dtype=torch.int64).contiguous()


def hash_device(words: torch.Tensor, lane_counts: torch.Tensor,
                lengths: torch.Tensor, tweak: int = 0) -> torch.Tensor:
    """Digests of a packed batch already on its device: int32 words
    (B, M, 128, 128) -> int64 (B, 8) holding the uint32 digest words.

    On the card, one launch of the row chain with the lane fold and the
    combine in its epilogue (counted under jth256_row_chain and
    jth256_block_digests, and, for blocks of at most
    `kernels.CTA_BLOCK_LANES` lanes, which a CTA a block runs, under
    jth256_block_cta); on the CPU the plain versions
    (`combine_accs(chain_digests_ref(...))`). Any other device raises."""
    if words.dim() != 4:
        raise ValueError(f"words must be (B, M, {ROWS}, {COLS}), got {tuple(words.shape)}")
    if words.device.type == "cpu":
        return combine(lane_digests(words, tweak), lane_counts, lengths)
    out = torch.empty((words.shape[0], 8), dtype=torch.int64, device=words.device)
    _launch_blocks("jth256_block_digests", words, lane_counts, lengths, tweak, out)
    return out


def hash_estimate_device(words: torch.Tensor, lane_counts: torch.Tensor,
                         lengths: torch.Tensor,
                         tweak: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Digests and compress advisories of a packed batch already on its
    device: int32 words (B, M, 128, 128) -> `hash_device`'s int64 (B, 8)
    digests and `compress_batch.estimate`'s float32 (B,) advisories of the
    same words.

    On the card, one launch of the row chain with the lane fold, the
    combine and the estimate in its epilogue (counted under
    jth256_row_chain and jth256_block_digests_estimate, and for short
    blocks under jth256_block_cta and jth256_block_cta_estimate); on the
    CPU the plain versions. Any other device raises."""
    if words.dim() != 4:
        raise ValueError(f"words must be (B, M, {ROWS}, {COLS}), got {tuple(words.shape)}")
    if words.device.type == "cpu":
        from .compress_batch import estimate

        return (combine(lane_digests(words, tweak), lane_counts, lengths),
                estimate(words, lane_counts))
    b = words.shape[0]
    out = torch.empty((b, 8), dtype=torch.int64, device=words.device)
    advisories = torch.empty((b,), dtype=torch.float32, device=words.device)
    _launch_blocks("jth256_block_digests_estimate", words, lane_counts, lengths, tweak, out,
                   advisories)
    return out, advisories


def _launch_blocks(entry: str, words: torch.Tensor, lane_counts: torch.Tensor,
                   lengths: torch.Tensor, tweak: int, out: torch.Tensor,
                   advisories: torch.Tensor | None = None) -> None:
    """One launch of a block entry on the words' card into `out` (and, for
    the estimating entry, `advisories`), on the current stream: its
    one-CTA design for blocks of at most `kernels.CTA_BLOCK_LANES` lanes,
    counted under `jth256_block_cta` too (and, estimating, under
    `jth256_block_cta_estimate`)."""
    global _LAST_KERNEL_MODE, _LAST_FOLD_MODE
    # one pass of checks: this call runs once per hash batch, 214 one-block
    # batches in a one-writer ingest, so its host time is on the path
    b, m = words.shape[0], words.shape[1]
    if words.dtype != torch.int32 or words.shape[2:] != (ROWS, COLS) or m < 1 \
            or not words.is_contiguous():
        raise ValueError(f"words must be contiguous int32 (B, M >= 1, {ROWS}, {COLS}), "
                         f"got {words.dtype} {tuple(words.shape)}")
    _cuda_words(words, entry)
    dev = words.device
    counts, lens = _int64_on(lane_counts, dev), _int64_on(lengths, dev)
    if counts.shape != (b,) or lens.shape != (b,):
        raise ValueError(f"lane_counts and lengths must be ({b},), got "
                         f"{tuple(counts.shape)} and {tuple(lens.shape)}")
    if b:
        design = kernels.block_entry(entry, m)  # the C entry that takes the batch
        fn = kernels.function(design)
        switch = dev.index != torch.cuda.current_device()
        with torch.cuda.device(dev) if switch else contextlib.nullcontext():
            stream = _stream(dev)
            if design != entry:  # one CTA a block: no scratch, counters or workspace
                args = [words.data_ptr(), counts.data_ptr(), lens.data_ptr(), out.data_ptr()]
                if advisories is not None:
                    args.append(advisories.data_ptr())
            else:
                lane_out = torch.empty((b * m, 8), dtype=torch.int32, device=dev)  # scratch
                args = [words.data_ptr(), lane_out.data_ptr(), counts.data_ptr(),
                        lens.data_ptr(), _arrivals(dev, stream, b).data_ptr(), out.data_ptr()]
                if advisories is not None:
                    args += [zeroed_workspace(entry, dev, stream, b, 256).data_ptr(),
                             advisories.data_ptr()]
            depth, _ = _ring(design, dev, b * m, m)
            _check_rc(design, fn(*args, b, m, int(tweak) & MASK, depth, stream))
        kernels.LAUNCHES["jth256_row_chain"] += 1
        kernels.LAUNCHES[entry] += 1
        if design != entry:
            kernels.LAUNCHES["jth256_block_cta"] += 1
            if advisories is not None:
                kernels.LAUNCHES["jth256_block_cta_estimate"] += 1
    _LAST_KERNEL_MODE = _LAST_FOLD_MODE = "cuda"


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
