"""The multi-device sharding plane: the counterpart of
juicefs_tpu/tpu/sharding.py.

The plane spreads a packed hash batch over a (data x lane) grid of
devices:

  data  blocks of the batch: no communication until the end, where only
        the 32-byte digests of each data row are copied to the plane's
        home device (the reference's all_gather over "data");
  lane  64 KiB lanes within a block: each device runs the row-chain
        kernel and the lane fold on its own lanes with a global lane
        offset, then the per-lane digests (B x M x 8 words) of a data row
        are copied, in lane order, to the row's lead device (the
        all_gather over "lane"), which runs the sequential combine. A
        mesh whose lane extent is 1 holds whole blocks on each device, so
        each data row hashes as one card does: one launch, the combine in
        the row chain's epilogue.

Only digest- and histogram-sized tensors cross devices, ~1/2048 of the
bytes hashed. Every consumer of the card enters through this seam: the
hash pipeline, the dedup scan, the compress estimator and inline
ingest's shared pack.

The reference's plane is one process over its local devices, and so is
this one: the collectives are device-to-device copies (`Tensor.to(dev,
non_blocking=True)`), which torch orders after the producing device's
current stream. No torch.distributed, no NCCL, no launcher. Each shard's
kernel and fold run on the current stream of the shard's device. A mesh
may name one device more than once (`[cuda:0] * 4`, `[cpu] * 8`): the
shards then share that device and its stream, and the copies between
them are no-ops, which exercises the program's lane offsets, gathers
and padding on one card, but not its cross-device ordering.

Degrade ladder (never an error):

  an even count >= 2 of devices      -> (data, lane) mesh: lane = 2 when
                                        the count divides by 4, else 1
  one device, an odd count or a      -> the one-device path on the first
  mesh-init failure                     device (all but one device counted
                                        in juicefs_torch_shard_degraded)
  a batch whose lanes do not split   -> that batch on the one-device path,
                                        counted

The one-device path is the plain `hash_torch.hash_device` on tensors
uploaded once: the same upload and the same one launch (the row chain
with the lane fold and the combine in its epilogue) as without a plane.
On a mesh with lane extent > 1 each device runs the row chain with its
lane fold over its lane shard, and each data row's lead device the
combine over the gathered per-lane digests.

Ragged batches pad B up to the data-axis extent by repeating the last
block (pad rows can only mark themselves as duplicates); outputs are
sliced back, so digests, dedup verdicts and estimator advisories are
identical to the one-device path at every batch shape.

Unlike the reference, `devices=None` means every local card and raises
without one: the plane never runs on the CPU unless its caller names the
CPU (the CPU tests pass `[torch.device("cpu")] * n`).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..metric import global_registry
from ..utils import get_logger
from .compress_batch import byte_histogram, entropy_ratio
from .dedup import dedup_scan
from .hash_torch import (
    MASK,
    _as_int64,
    _as_words,
    combine,
    cuda_device_count,
    digests_to_numpy,
    hash_device,
    hash_estimate_device,
    lane_digests,
)

logger = get_logger("gpu.shard")

_reg = global_registry()
_DEVICES = _reg.gauge(
    "juicefs_torch_shard_devices",
    "Devices in the sharding plane's mesh (1 = the one-device path)",
)
_H2D_BATCHES = _reg.counter(
    "juicefs_torch_shard_h2d_batches",
    "Packed batches placed on devices by the sharding plane (one "
    "host-to-device placement per batch feeds hash and estimator)",
)
_DEGRADED = _reg.counter(
    "juicefs_torch_shard_degraded",
    "Sharding-plane degrades to the one-device path (odd device count, "
    "mesh-init failure, or an indivisible batch at call time)",
)


def local_devices() -> list[torch.device]:
    """Every local card; without one this raises instead of using the CPU."""
    return [torch.device("cuda", i) for i in range(cuda_device_count())]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        d = torch.device("cuda", idx)
    return d


class Mesh:
    """A (data, lane) grid of torch devices: `devices[d][l]`."""

    def __init__(self, grid: list[list[torch.device]]):
        self.devices = grid
        self.shape = {"data": len(grid), "lane": len(grid[0])}

    @property
    def home(self) -> torch.device:
        """Where gathered digests, verdicts and advisories land."""
        return self.devices[0][0]


def make_mesh(n_data: int | None = None, n_lane: int = 1, devices=None) -> Mesh:
    """Build a (data, lane) mesh over the given (default: every local
    card) devices."""
    devices = local_devices() if devices is None else [_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_lane
    used = n_data * n_lane
    if n_data < 1 or n_lane < 1 or used > len(devices):
        raise ValueError(f"mesh {n_data}x{n_lane} needs {used} devices, have {len(devices)}")
    return Mesh([devices[d * n_lane:(d + 1) * n_lane] for d in range(n_data)])


class ShardedTensor:
    """A batch tensor split over a mesh: `shards[d][l]` lies on
    `mesh.devices[d][l]`.

    Rows (axis 0, the blocks) split over the data axis. With `lane_split`
    (packed words) axis 1, the lanes, splits over the lane axis; otherwise
    (lane counts, lengths) every device of a data row holds that row's
    whole slice. `shape` is the padded global shape. The tensor carries its
    mesh, so a program run on it follows where it was placed, whichever
    plane placed it."""

    def __init__(self, mesh: Mesh, shards: list[list[torch.Tensor]], shape,
                 lane_split: bool):
        self.mesh = mesh
        self.shards = shards
        self.shape = torch.Size(shape)
        self.lane_split = lane_split

    def gather(self, device) -> torch.Tensor:
        """The whole (padded) tensor on one device."""
        rows = []
        for row in self.shards:
            if self.lane_split:
                rows.append(torch.cat([p.to(device) for p in row], 1))
            else:
                rows.append(row[0].to(device))
        return torch.cat(rows, 0)

    def cpu(self) -> torch.Tensor:
        return self.gather(torch.device("cpu"))


def _place(src: torch.Tensor, rows: int, dev: torch.device) -> torch.Tensor:
    """Copy `src` (its leading rows, then its last row repeated up to
    `rows`) onto `dev`. A card gets a non-blocking copy from pinned host
    memory: `src` itself when it is pinned, contiguous and complete, else a
    pinned staging copy (torch's pinned allocator keeps the staging block
    until the copy has run)."""
    cuda = dev.type == "cuda"
    if src.shape[0] == rows and src.is_contiguous() and (not cuda or src.is_pinned()):
        return src.to(dev, non_blocking=True) if cuda else src
    staged = torch.empty((rows, *src.shape[1:]), dtype=src.dtype, pin_memory=cuda)
    k = src.shape[0]
    staged[:k].copy_(src)
    if k < rows:
        staged[k:].copy_(src[k - 1:k].expand(rows - k, *src.shape[1:]))
    return staged.to(dev, non_blocking=True) if cuda else staged


def shard_batch(mesh: Mesh, words, lane_counts, lengths):
    """Place a packed host batch on the mesh: words (B, M, 128, 128) split
    over data (B) and lane (M), lane counts and lengths split over data.

    Ragged batches (B not divisible by the data axis, the tail of any real
    scan) are padded by repeating the LAST block: padded rows are valid
    hash inputs, and because they duplicate an earlier block they can only
    mark THEMSELVES as duplicates. Callers slice outputs back to their
    input length. Returns three ShardedTensors of the padded batch."""
    n_data, n_lane = mesh.shape["data"], mesh.shape["lane"]
    if any(isinstance(a, torch.Tensor) and a.device.type != "cpu"
           for a in (words, lane_counts, lengths)):
        raise ValueError("shard_batch places host arrays, not device tensors")
    host = torch.device("cpu")
    words = _as_words(words, host)
    counts = _as_int64(lane_counts, host)
    lens = _as_int64(lengths, host)
    b, m = int(words.shape[0]), int(words.shape[1])
    if b == 0 or m % n_lane:
        raise ValueError(f"a ({b}, {m}) batch does not split over mesh {mesh.shape}")
    bl, ml = -(-b // n_data), m // n_lane
    wsh, csh, lsh = [], [], []
    for d, row in enumerate(mesh.devices):
        # rows [d*bl, (d+1)*bl) of the batch padded with its last block;
        # a data row wholly past the real blocks holds only that block
        r0 = min(d * bl, b - 1)
        r1 = max(min(d * bl + bl, b), r0 + 1)
        c = _place(counts[r0:r1], bl, host)
        ln = _place(lens[r0:r1], bl, host)
        wsh.append([_place(words[r0:r1, li * ml:(li + 1) * ml], bl, dev)
                    for li, dev in enumerate(row)])
        csh.append([c.to(dev, non_blocking=True) for dev in row])
        lsh.append([ln.to(dev, non_blocking=True) for dev in row])
    shape = (bl * n_data, m, *words.shape[2:])
    return (ShardedTensor(mesh, wsh, shape, True),
            ShardedTensor(mesh, csh, (bl * n_data,), False),
            ShardedTensor(mesh, lsh, (bl * n_data,), False))


def _lane_gather(mesh: Mesh, words: ShardedTensor, tweak: int) -> list[torch.Tensor]:
    """Row chain + lane fold of every shard on its device with its global
    lane offset (one `jth256_lane_digests` launch each), then per data row
    the per-lane digests on the row's lead device in lane order (the
    reference's all_gather over "lane", tiled on axis 1): one int32
    (B/data, M, 8) tensor per data row."""
    out = []
    for d, row in enumerate(words.shards):
        lead = mesh.devices[d][0]
        accs = [lane_digests(w, tweak, li * w.shape[1]).to(lead, non_blocking=True)
                for li, w in enumerate(row)]
        out.append(torch.cat(accs, 1))
    return out


def _hash_body(mesh: Mesh, words: ShardedTensor, lane_counts: ShardedTensor,
               lengths: ShardedTensor, tweak: int = 0) -> torch.Tensor:
    """Digests of a placed batch, gathered over data on the home device:
    int64 (B, 8). With one lane shard a data row holds whole blocks: one
    `hash_device` launch per data row. Otherwise the combine masks by the
    global lane counts, so it runs only after the lane gather: one
    `jth256_combine` launch per data row, on the row's lead device."""
    if mesh.shape["lane"] == 1:
        rows = [hash_device(row[0], lane_counts.shards[d][0], lengths.shards[d][0], tweak)
                for d, row in enumerate(words.shards)]
    else:
        rows = [combine(acc, lane_counts.shards[d][0], lengths.shards[d][0])
                for d, acc in enumerate(_lane_gather(mesh, words, tweak))]
    return torch.cat([h.to(mesh.home, non_blocking=True) for h in rows], 0)


def _scan_body(mesh: Mesh, words, lane_counts, lengths, tweak: int = 0):
    """The shared scan body (the one-shot step and the multi-iteration
    loop): hash, gather the digests over data, dedup on the home device."""
    all_digests = _hash_body(mesh, words, lane_counts, lengths, tweak)
    dup, first = dedup_scan(all_digests)
    return all_digests, dup, first


def sharded_scan_step(mesh: Mesh):
    """The full multi-device scan step over `mesh`: a fn (words, lane_counts,
    lengths), placed by `shard_batch`, -> (digests (B, 8) int64, dup_mask
    (B,) bool, first_idx (B,) int32) on the home device."""

    def step(words, lane_counts, lengths):
        return _scan_body(mesh, words, lane_counts, lengths)

    return step


def sharded_scan_many(mesh: Mesh):
    """Multi-iteration sharded scan (the benchmark form): iteration k hashes
    the resident batch with tweak k xor'ed into every word inside the
    kernel (no copy of the batch), and the digest-sized gathers repeat per
    iteration. The checksum acc ^= (sum(all_d) mod 2^32) ^ sum(dup)
    accumulates on the home device; the host syncs once, at the end.

    Returns fn(words, lane_counts, lengths, iters) -> uint32 checksum (int).
    """

    def many(words, lane_counts, lengths, iters: int) -> int:
        acc = torch.zeros((), dtype=torch.int64, device=mesh.home)
        for k in range(int(iters)):
            all_d, dup, _first = _scan_body(mesh, words, lane_counts, lengths, k)
            acc = acc ^ (all_d.sum() & MASK) ^ (dup.sum() & MASK)
        return int(acc)

    return many


def sharded_hash_step(mesh: Mesh):
    """Hash-only sharded step: fn(words, lane_counts, lengths) -> digests
    (B, 8) int64 on the home device; `sharded_scan_step` minus the dedup
    tail (the pipeline dedups on the host against the meta index)."""

    def step(words, lane_counts, lengths):
        return _hash_body(mesh, words, lane_counts, lengths)

    return step


def sharded_estimate_step(mesh: Mesh):
    """Sharded compressibility estimator, identical to
    `compress_batch.estimate`: each device histograms its own lanes'
    sampled bytes (the lane offset keeps the padded-lane mask global; on a
    card the kernel's `compress_histogram` entry), the lead device of each
    data row sums the histograms over lane and runs the entropy (on a card
    `compress_entropy`, the device function the row chain's estimating
    entry runs), and the advisories are gathered over data on the home
    device. The bins are integer-valued float32 counts (<= 16384 per bin,
    exact), so the sum is exact in any order and the entropy sees the
    one-device histogram bit for bit."""

    def est(words: ShardedTensor, lane_counts: ShardedTensor) -> torch.Tensor:
        preds = []
        for d, row in enumerate(words.shards):
            lead = mesh.devices[d][0]
            h = None
            for li, w in enumerate(row):
                hl = byte_histogram(w, lane_counts.shards[d][li], li * w.shape[1])
                hl = hl.to(lead, non_blocking=True)
                h = hl if h is None else h + hl
            preds.append(entropy_ratio(h).to(mesh.home, non_blocking=True))
        return torch.cat(preds, 0)

    return est


class ShardedPack(tuple):
    """A packed (words, lane_counts, lengths) triple placed by the plane.

    Behaves as the plain tuple the shared-pack contract passes around
    (``*packed`` unpacking, ``words, counts, lengths = packed``), and
    carries ``batch``, the block count before data-axis padding, so
    consumers slice gathered outputs back. On the one-device path the
    entries are the device tensors; on a mesh they are ShardedTensors.
    """

    def __new__(cls, arrays, batch: int):
        self = tuple.__new__(cls, arrays)
        self.batch = batch
        return self


class ShardPlane:
    """Process-wide multi-device plane: mesh policy, sharded placement, and
    the hash/dedup/estimator programs every device consumer routes through.

    Construction never raises past finding its devices: a mesh failure
    lands on the one-device path with `juicefs_torch_shard_degraded`
    counted. `devices=None` means every local card and raises without one.
    """

    def __init__(self, devices=None):
        devs = local_devices() if devices is None else [_device(d) for d in devices]
        if not devs:
            raise ValueError("a shard plane needs at least one device")
        self.devices = devs
        self.n_devices = len(devs)
        self.mesh: Mesh | None = None
        self.degrade_reason = ""
        n = len(devs)
        if n >= 2 and n % 2 == 0:
            try:
                n_lane = 2 if (n >= 4 and n % 4 == 0) else 1
                self.mesh = make_mesh(n_data=n // n_lane, n_lane=n_lane, devices=devs)
            except Exception as e:  # mesh init failure -> one device
                self.mesh = None
                self.degrade_reason = f"mesh init failed: {e}"
                _DEGRADED.inc()
                logger.warning("shard plane degraded to one device: %s", e)
        elif n > 1:  # odd device count: no even (data, lane) factoring
            self.degrade_reason = f"odd device count {n}"
            _DEGRADED.inc()
            logger.warning("shard plane degraded to one device: %d devices", n)
        else:
            self.degrade_reason = "single device"
        self.home = self.mesh.home if self.mesh is not None else devs[0]
        self._on_plane = set(devs)
        # the list `advised()` collects a thread's advisories in
        self._advice = threading.local()
        if self.mesh is not None:
            self._hash_sharded = sharded_hash_step(self.mesh)
            self._scan_sharded = sharded_scan_step(self.mesh)
            self._estimate_sharded = sharded_estimate_step(self.mesh)

    # -- mesh geometry ----------------------------------------------------
    @property
    def n_data(self) -> int:
        return self.mesh.shape["data"] if self.mesh is not None else 1

    @property
    def n_lane(self) -> int:
        return self.mesh.shape["lane"] if self.mesh is not None else 1

    def snapshot(self) -> dict:
        """Advisory stats block (gc --dedup, the multichip run, tests)."""
        return {
            "devices": self.n_data * self.n_lane if self.mesh else 1,
            "mesh": (
                {"data": self.n_data, "lane": self.n_lane}
                if self.mesh is not None else None
            ),
            "degraded": self.mesh is None,
            "reason": self.degrade_reason,
        }

    # -- placement --------------------------------------------------------
    def _shardable(self, words) -> bool:
        return (
            self.mesh is not None
            and words.shape[0] > 0
            and words.shape[1] % self.n_lane == 0
        )

    def _placed(self, words) -> bool:
        """True for a batch already on the plane's devices (a ShardedTensor,
        or a tensor on one of them); False for host arrays. A tensor on a
        device the plane does not hold is refused."""
        if isinstance(words, ShardedTensor):
            return True
        if not isinstance(words, torch.Tensor):
            return False
        if words.device in self._on_plane:
            return True
        if words.device.type == "cpu":
            return False
        raise ValueError(f"a batch on {words.device} is not on this plane's devices")

    def put_packed(self, words, lane_counts, lengths) -> ShardedPack:
        """The ONE host-to-device placement of the shared-pack contract.

        Pads B to a multiple of the data-axis extent (repeat-last-block,
        see `shard_batch`), places the triple over the mesh, and returns a
        `ShardedPack` remembering the original batch size. Indivisible
        shapes (lane axis not dividing M) and empty batches take the
        one-device placement on the home device instead (the upload the
        port makes without a plane): still one placement, still counted.
        """
        b = int(words.shape[0])
        if not self._shardable(words):
            if self.mesh is not None and b > 0:
                _DEGRADED.inc()  # a mesh is up, but this batch cannot split
            home = self.home
            arrays = (_as_words(words, home), _as_int64(lane_counts, home),
                      _as_int64(lengths, home))
        else:
            arrays = shard_batch(self.mesh, words, lane_counts, lengths)
        _H2D_BATCHES.inc()
        return ShardedPack(arrays, b)

    def record_events(self) -> list:
        """One CUDA event on the current stream of each card of the plane,
        behind everything queued there so far (host staging reuse waits on
        them); none on the CPU."""
        events = []
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                events.append(ev)
        return events

    # -- programs ---------------------------------------------------------
    def hash_async(self, words, lane_counts, lengths) -> torch.Tensor:
        """Queue the hash program and return the (not yet synchronised)
        int64 (B, 8) digests on the home device, padding included. Host
        arrays are placed here (one counted placement); a batch placed by
        `put_packed` is not placed again.

        Inside `advised()` on this thread every batch is also estimated for
        the compress plane, where it lies: a batch on one device in the
        hash's own launch (`hash_estimate_device`), a batch split over the
        mesh by the mesh's histogram and entropy programs
        (`sharded_estimate_step`). The advisories are the same bits either
        way."""
        if not self._placed(words):
            words, lane_counts, lengths = self.put_packed(words, lane_counts, lengths)
        advice = getattr(self._advice, "sink", None)
        if isinstance(words, ShardedTensor):
            digests = self._hash_sharded(words, lane_counts, lengths)
            if advice is not None:
                advice.append(self._estimate_sharded(words, lane_counts))
            return digests
        dev = words.device
        counts, lens = _as_int64(lane_counts, dev), _as_int64(lengths, dev)
        if advice is None:
            return hash_device(words, counts, lens)
        digests, advisories = hash_estimate_device(words, counts, lens)
        advice.append(advisories)
        return digests

    @contextlib.contextmanager
    def advised(self):
        """Within the block, each hash on this thread (`hash_async`) appends
        its batch's float32 (B,) compress advisories, padding included, on
        the home device, to the list this yields."""
        advice: list = []
        self._advice.sink = advice
        try:
            yield advice
        finally:
            self._advice.sink = None

    def hash_packed(self, words, lane_counts, lengths, n: int | None = None) -> np.ndarray:
        """(B, M, 128, 128) -> (n, 8) uint32 digests, identical to the
        one-device path. `n` slices gathered outputs back past any
        data-axis padding; defaults to the input batch size."""
        if n is None:
            n = int(words.shape[0])
        if n == 0:
            return np.zeros((0, 8), dtype=np.uint32)
        return digests_to_numpy(self.hash_async(words, lane_counts, lengths)[:n])

    def scan_packed(self, words, lane_counts, lengths, n: int | None = None):
        """Full scan step (digests + dedup verdicts), sliced back to the
        original batch. Pad rows only ever self-duplicate, so dup/first for
        real rows match the one-device `dedup_scan` exactly."""
        if n is None:
            n = int(words.shape[0])
        if n == 0:
            e = np.zeros((0,), dtype=np.int32)
            return np.zeros((0, 8), dtype=np.uint32), e.astype(bool), e
        if not self._placed(words):
            words, lane_counts, lengths = self.put_packed(words, lane_counts, lengths)
        if isinstance(words, ShardedTensor):
            d, dup, first = self._scan_sharded(words, lane_counts, lengths)
        else:
            d = self.hash_async(words, lane_counts, lengths)
            dup, first = dedup_scan(d)
        return (digests_to_numpy(d[:n]), dup[:n].cpu().numpy(),
                first[:n].cpu().numpy())


_plane_lock = threading.Lock()
_plane: ShardPlane | None = None


def get_plane() -> ShardPlane:
    """The process-wide plane, built over every local card on first use.
    Without a card it raises (and builds nothing)."""
    global _plane
    with _plane_lock:
        if _plane is None:
            _plane = ShardPlane()
            # the gauge describes the process plane, not the one-device or
            # test planes built beside it
            _DEVICES.set(_plane.snapshot()["devices"])
        return _plane


def plane_for(device=None) -> ShardPlane:
    """The plane a device consumer runs on: the process-wide plane for
    device=None, else a one-device plane over `device`."""
    return get_plane() if device is None else ShardPlane([device])


def _reset_plane_for_tests() -> None:
    global _plane
    with _plane_lock:
        _plane = None
