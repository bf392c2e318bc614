"""The frozen reference against the port's NumPy spec, and the plain-dict
duplicate verdicts."""

import numpy as np
import pytest

from juicefs_tpu_torch.gpu import jth256 as port
from portbench.reference import jth256 as ref
from portbench.reference.verdicts import duplicate_count, verdicts

LENGTHS = (0, 1, 4095, 65535, 65536, 65537, 3 * 65536 + 777, 4 << 20)


@pytest.mark.parametrize("n", LENGTHS)
def test_single_block_matches_port_spec(n):
    data = np.random.default_rng(n).bytes(n)
    assert ref.jth256(data) == port.jth256(data)


def test_batch_matches_port_spec_and_single():
    rng = np.random.default_rng(5)
    blocks = [rng.bytes(int(n)) for n in rng.integers(0, 300_000, size=9)]
    blocks.append(blocks[2])
    got = ref.digests(blocks, batch=4)
    assert got == port.hash_blocks_np(blocks)
    assert got == [ref.jth256(b) for b in blocks]


def test_verdicts_plain_dict():
    assert verdicts(["a", "b", "a", "c", "b", "a"]) == [0, 1, 0, 3, 1, 0]
    assert duplicate_count(["a", "b", "a", "c", "b", "a"]) == 3
    assert duplicate_count([]) == 0


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib

    for path in pathlib.Path(ref.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("juicefs_tpu_torch", "juicefs_tpu",
                                                  "jax", "jaxlib", "torch"), (path, name)
