"""The initial weights of both configurations at the cells' own size are,
bit for bit, what the benchmark made before a rule keyed on the module's
type chose each leaf's draw (checksums taken from that tree), so every
reading of the existing cells starts from the same weights."""

import hashlib

import pytest

from perfbench import harness, spec
from perfbench.weights import make_weights

PINNED = {
    ("mscmrseg-d124.aug2", 0): (226, "dec9d0f79423d0dd6cffc08f3275437a1117e9620043b754c7b7e9d1677f7517"),
    ("mscmrseg-d124.aug2", 3_000_000_021): (226, "4aa6ceb9a18d32ba9e50fc52b437b6b2f1d926a9830e0d5a41eb653d4f5d23c5"),
    ("mmwhs-d124.noaug", 0): (284, "e4c90f8a084bdc6e6a5aeae95ee0f6188b8a02103ecff3a39fef1cf335c9a880"),
    ("mmwhs-d124.noaug", 3_000_000_021): (284, "540e85cb361b122a14de38b0f1de18427be5473aa291a9bcbe27eca1bae1cb6b"),
}


@pytest.mark.parametrize("cell,seed", list(PINNED), ids=[f"{c}-{s}" for c, s in PINNED])
def test_the_weights_are_the_parents_bit_for_bit(cell, seed):
    ref_cfg = harness.reference_config(spec.resolve(cell), 0)
    digest, leaves = hashlib.sha256(), 0
    for net, state in make_weights(ref_cfg, seed, "cpu").items():
        for name, t in state.items():
            digest.update(f"{net}.{name}{tuple(t.shape)}{t.dtype}".encode())
            digest.update(t.contiguous().numpy().tobytes())
            leaves += 1
    assert (leaves, digest.hexdigest()) == PINNED[(cell, seed)]
