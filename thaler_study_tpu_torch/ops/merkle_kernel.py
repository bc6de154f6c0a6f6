"""The SHA-256 Merkle tree build on the card.

Counterpart of ``thaler_study_tpu/ops/merkle_kernel.py``. The PCS commits
with a SHA-256 Merkle tree (``pcs/merkle.py``): leaf i is
sha256(b"leaf:" || value_i as byte_size little-endian bytes), node
sha256(b"node:" || left || right). The host build hashes 2n - 1 nodes one
``hashlib`` call at a time; here the whole tree is one launch of
``csrc/merkle.cu`` (:func:`plan`: each block hashes a run of consecutive
leaves and the levels above them, over all its threads, up to one node a
thread, then those nodes up to the block's root in shared memory; the last
block to finish hashes the blocks' roots up to the tree's root), and the
tree stays in one device buffer of 2n - 1 digests until the one host read
at the end.

:func:`build_tree` is the wrapper (CPU tensors go to
:func:`build_tree_plain`, ``hashlib`` per node, the JAX package's host
build; CUDA tensors to the kernel or raise); :func:`build_tree_device`
takes and returns numpy arrays as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import List, NamedTuple

import numpy as np
import torch

from .. import _build
from ..fields.farray import resolve_device

# launches of the CUDA kernel (not of the plain version): "leaf" counts the
# launches that hash a tree's leaves (a build's one launch, which builds its
# node levels too), "node" the launches that hash node levels alone (none:
# node_launches)
launches = {"leaf": 0, "node": 0}

THREADS = 512  # csrc/merkle.cu THREADS: the most threads a block has
ROOTS = 128  # csrc/merkle.cu ROOTS: the most blocks, whose roots the last block hashes up

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("merkle")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ts_merkle_build_launch.argtypes = [vp, i, ll, i, i, i, vp, vp, vp]
        lib.ts_merkle_build_launch.restype = i
        _lib = lib
    return _lib


def level_sizes(n: int) -> List[int]:
    """The digests per level of a tree over n leaves, leaves first."""
    sizes = [n]
    while sizes[-1] > 1:
        sizes.append(sizes[-1] // 2)
    return sizes


class Plan(NamedTuple):
    """The build's one launch over n leaves: ``blocks`` blocks of
    ``threads`` threads, each block over ``threads`` x ``per_thread``
    consecutive leaves, which it hashes with the levels above them up to
    one node a thread, then up to its root; the last block builds the
    levels above the blocks' roots."""

    blocks: int
    threads: int
    per_thread: int


def plan(n: int) -> Plan:
    """The launch over n leaves (a power of two): ROOTS blocks (one per SM)
    where the tree has two warps for each, fewer below 64 x ROOTS leaves (so
    that the last block has a thread for each node of the top's first
    level); n / ROOTS threads a block, from two warps up to THREADS, and
    the leaves left over per thread."""
    threads = min(THREADS, max(min(n, 64), n // ROOTS))
    blocks = min(ROOTS, n // threads)
    return Plan(blocks, threads, n // (blocks * threads))


def node_launches(n: int) -> int:
    """The launches a build over n leaves makes after the one that hashes
    the leaves: none, that launch builds every node level (:func:`plan`)."""
    return 0


def split_levels(tree: np.ndarray) -> List[np.ndarray]:
    """A [2n - 1, 8] array of digests, level by level, as a list of
    [n_i, 8] uint32 arrays, leaves first."""
    words = np.ascontiguousarray(tree).view(np.uint32)
    out, off = [], 0
    for m in level_sizes((words.shape[0] + 1) // 2):
        out.append(words[off : off + m])
        off += m
    return out


def _check(vals: torch.Tensor) -> int:
    if vals.dtype != torch.uint8 or vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError("leaf values must be a contiguous uint8 [n, byte_size] tensor")
    n, byte_size = vals.shape
    if n < 1 or n & (n - 1):
        raise ValueError(f"the leaf count must be a power of two, got {n}")
    if not 1 <= byte_size <= 8:
        raise ValueError(f"a leaf value takes 1 to 8 bytes, got {byte_size}")
    return n


def build_tree(vals: torch.Tensor) -> torch.Tensor:
    """Every level of the tree over ``vals`` ([n, byte_size] uint8, each row
    a leaf's little-endian bytes, n a power of two): a [2n - 1, 8] int32
    tensor of digest words (the big-endian u32 words' bits) on ``vals``'
    device, level by level, leaves first. CPU tensors run
    :func:`build_tree_plain`; CUDA tensors one launch of the kernel
    (:func:`plan`)."""
    n = _check(vals)
    dev = vals.device
    if dev.type == "cpu":
        levels = build_tree_plain(vals.numpy())
        return torch.from_numpy(np.concatenate(levels).view(np.int32))
    if dev.type != "cuda":
        raise ValueError(f"build_tree runs on cpu or cuda, not {dev}")
    lib = _library()
    tree = torch.empty((2 * n - 1, 8), dtype=torch.int32, device=dev)
    blocks, threads, per_thread = plan(n)
    with torch.cuda.device(dev):
        rc = lib.ts_merkle_build_launch(vals.data_ptr(), vals.shape[1], n, blocks, threads,
                                        per_thread.bit_length() - 1, tree.data_ptr(),
                                        _build.ticket_counter(dev).data_ptr(),
                                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"Merkle build kernel launch failed: CUDA error {rc}")
    launches["leaf"] += 1
    return tree


def build_tree_plain(vals_le: np.ndarray) -> List[np.ndarray]:
    """:func:`build_tree` with ``hashlib``, one call per node: the levels
    as [n_i, 8] uint32 digest-word arrays, leaves first."""
    level = [hashlib.sha256(b"leaf:" + row.tobytes()).digest() for row in np.asarray(vals_le, dtype=np.uint8)]
    levels = [level]
    while len(level) > 1:
        level = [hashlib.sha256(b"node:" + level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
        levels.append(level)
    return [np.frombuffer(b"".join(lv), dtype=">u4").astype(np.uint32).reshape(-1, 8) for lv in levels]


def build_tree_device(vals_le: np.ndarray, device="cuda") -> List[np.ndarray]:
    """The full tree over ``vals_le`` ([n, byte_size] uint8 little-endian
    leaf values, n a power of two) built on ``device``: the levels, leaves
    first, each a host [n_i, 8] uint32 digest-word array, read from the card
    in one copy at the end; byte-identical to the ``hashlib`` build."""
    dev = resolve_device(device)
    vals = torch.from_numpy(np.require(vals_le, np.uint8, ["C", "W"])).to(dev)
    return split_levels(build_tree(vals).cpu().numpy())
