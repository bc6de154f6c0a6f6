"""SHA-256 Merkle tree over field-element leaves.

Counterpart of ``thaler_study_tpu/pcs/merkle.py``. The reference commits
with an arkworks ``MerkleTree`` whose hashes are pluggable (its tests pick
Pedersen over JubJub — relaxed-pcs/src/lib.rs:241-284; ``pedersen.py``);
this instantiation uses SHA-256 for the leaf hash and the two-to-one
compression (the primitive of the Fiat-Shamir transcript), keeping the tree
deterministic and dependency-free. Leaves are canonical serialized field
elements (``byte_size`` little-endian bytes, as ``fiat_shamir.serialize``).

A tree is built where its caller's ``device`` says, by
``ops/merkle_kernel.build_tree``: on the card one launch per level and one
host read, on the CPU ``hashlib`` per node; both give the same digests.
The tree is kept as the one string of its 2n - 1 digests, level by level,
leaves first; a path or a multiproof slices its 32-byte siblings out of it.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np
import torch

from ..fields import Felt
from ..fields.farray import resolve_device
from ..ops.merkle_kernel import build_tree, level_sizes


def _leaf_hash(data: bytes) -> bytes:
    return hashlib.sha256(b"leaf:" + data).digest()


def _node_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"node:" + left + right).digest()


class MerklePath:
    """Sibling path from a leaf to the root (ref arkworks Path)."""

    def __init__(self, index: int, leaf_hash: bytes, siblings: List[bytes]):
        self.index = index
        self.leaf_hash = leaf_hash
        self.siblings = siblings

    def verify(self, root: bytes, leaf: Felt) -> bool:
        if _leaf_hash(leaf.to_bytes_le()) != self.leaf_hash:
            return False
        h = self.leaf_hash
        idx = self.index
        for sib in self.siblings:
            h = _node_hash(h, sib) if idx % 2 == 0 else _node_hash(sib, h)
            idx //= 2
        return h == root


class MerkleMultiPath:
    """Batch opening of several leaves with deduplicated siblings.

    The single-leaf ``MerklePath`` costs height siblings per leaf; a batch
    of k openings shares interior nodes, so the multiproof carries only the
    frontier siblings no other opened leaf can reconstruct (the standard
    Merkle multiproof). ``siblings`` is the flat digest list in the
    deterministic bottom-up, index-ascending consumption order that
    ``verify`` replays.
    """

    def __init__(self, indices: List[int], height: int, siblings: List[bytes]):
        self.indices = list(indices)
        self.height = height
        self.siblings = list(siblings)

    def verify(self, root: bytes, leaves: Sequence[Felt]) -> bool:
        """Check that ``leaves`` (aligned with ``indices``) hash up to
        ``root`` using the recorded siblings."""
        if len(leaves) != len(self.indices):
            return False
        nodes = {i: _leaf_hash(v.to_bytes_le()) for i, v in zip(self.indices, leaves)}
        stream = iter(self.siblings)
        try:
            for _ in range(self.height):
                nxt = {}
                for i in sorted(nodes):
                    if i ^ 1 in nodes and i % 2 == 1:
                        continue  # handled with its even partner
                    sib = nodes[i ^ 1] if i ^ 1 in nodes else next(stream)
                    left, right = (nodes[i], sib) if i % 2 == 0 else (sib, nodes[i])
                    nxt[i // 2] = _node_hash(left, right)
                nodes = nxt
        except StopIteration:
            return False
        if next(stream, None) is not None:
            return False  # trailing unused digests
        return nodes == {0: root}


def leaf_bytes(values: Sequence[Felt]) -> np.ndarray:
    """The leaves' serialized values: [n, byte_size] uint8, each value's
    ``byte_size`` little-endian bytes (``Felt.to_bytes_le``)."""
    byte_size = values[0].field.byte_size
    ints = np.fromiter((v.v for v in values), dtype="<u8", count=len(values))
    return np.ascontiguousarray(ints.view(np.uint8).reshape(len(values), 8)[:, :byte_size])


class MerkleTree:
    """A complete binary Merkle tree over a power-of-two leaf list, built on
    ``device`` (``"cuda"`` by default; module docstring)."""

    def __init__(self, values: Sequence[Felt], device="cuda"):
        n = len(values)
        assert n & (n - 1) == 0 and n > 0, "leaf count must be a power of two"
        self.values = list(values)
        vals = torch.from_numpy(leaf_bytes(self.values)).to(resolve_device(device))
        words = build_tree(vals).cpu().numpy()
        # every digest, level by level (the kernel's big-endian words)
        self.digests = words.view(np.uint32).astype(">u4").tobytes()
        self._starts = np.cumsum([0] + level_sizes(n)).tolist()
        self.height = len(self._starts) - 2

    def level(self, j: int) -> bytes:
        """The digests of level ``j`` (0: the leaves), 32 bytes each."""
        return self.digests[32 * self._starts[j] : 32 * self._starts[j + 1]]

    def _node(self, j: int, i: int) -> bytes:
        at = 32 * (self._starts[j] + i)
        return self.digests[at : at + 32]

    def root(self) -> bytes:
        return self._node(self.height, 0)

    def generate_proof(self, index: int) -> MerklePath:
        siblings = []
        idx = index
        for j in range(self.height):
            siblings.append(self._node(j, idx ^ 1))
            idx //= 2
        return MerklePath(index, self._node(0, index), siblings)

    def generate_multi_proof(self, indices: Sequence[int]) -> MerkleMultiPath:
        """Batch opening of ``indices`` with shared siblings emitted once,
        in the order MerkleMultiPath.verify consumes them."""
        idxs = sorted(set(indices))
        assert idxs, "at least one index"
        siblings: List[bytes] = []
        cur = idxs
        for j in range(self.height):
            known = set(cur)
            for i in cur:
                if i ^ 1 in known:
                    if i % 2 == 1:
                        continue
                else:
                    siblings.append(self._node(j, i ^ 1))
            cur = sorted({i // 2 for i in cur})
        return MerkleMultiPath(idxs, self.height, siblings)
