"""The control of `correct`: a run with the program's hash replaced by the
reference computing a weaker digest, which has to come out not correct.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 --seconds 5

The configurations state byte-identical JTH-256 digests. The control
breaks that guarantee in the step that would tempt a faster hash: each
block's digest is the reference's JTH-256 of its first 64 KiB lane only,
a sampled fingerprint (duplicate verdicts on these volumes stay right,
since blocks that differ differ in their first lane). It is computed on
the host by the frozen reference and put in the place of the program's
hash (`ShardPlane.hash_async`, which every hash batch on the card goes
through). The benchmark's own runs never run it. Each seed's compared
numbers and `correct` are printed as one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np

from .reference import jth256 as ref


def first_lane_digests(words, lengths) -> np.ndarray:
    """(B, 8) uint32: JTH-256 of each packed block's first lane."""
    w = words.cpu().numpy() if hasattr(words, "cpu") else np.asarray(words)
    n = lengths.cpu().numpy() if hasattr(lengths, "cpu") else np.asarray(lengths)
    w = np.ascontiguousarray(w[:, :1]).view(np.uint32)
    b = w.shape[0]
    return ref.hash_packed_np(w, np.ones(b, dtype=np.int32),
                              np.minimum(n.astype(np.int64), ref.LANE_BYTES).astype(np.uint32))


@contextlib.contextmanager
def controlled():
    """The program's hash replaced by the control while the block runs."""
    import torch

    from juicefs_tpu_torch.gpu.sharding import ShardPlane

    orig = ShardPlane.hash_async

    def hash_async(self, words, lane_counts, lengths):
        d = first_lane_digests(words, lengths).astype(np.int64)
        dev = words.device if isinstance(words, torch.Tensor) else self.home
        return torch.from_numpy(d).to(dev)

    ShardPlane.hash_async = hash_async
    try:
        yield
    finally:
        ShardPlane.hash_async = orig


def main(argv=None) -> int:
    from .run import RunError, run_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            with controlled():
                result, _checks = run_cell(args.workload, seed, args.seconds, False,
                                           card_clock=False)
        except RunError as e:
            print(f"portbench.control: {e}", file=sys.stderr)
            return 2
        print(json.dumps({"control": "first_lane", "workload": args.workload, "seed": seed,
                          "correct": result["correct"], "checks": result["checks"]}),
              flush=True)
        rc |= bool(result["correct"])  # a control that comes out correct fails
    return rc


if __name__ == "__main__":
    sys.exit(main())
