"""The SHA-256 Merkle tree build on the card.

Counterpart of ``thaler_study_tpu/ops/merkle_kernel.py``. The PCS commits
with a SHA-256 Merkle tree (``pcs/merkle.py``): leaf i is
sha256(b"leaf:" || value_i as byte_size little-endian bytes), node
sha256(b"node:" || left || right). The host build hashes 2n - 1 nodes one
``hashlib`` call at a time; here every level of more than :data:`TOP`
nodes is one launch of ``csrc/merkle.cu`` (a thread per leaf, one
compression; a thread per node, two), the levels from :data:`TOP` nodes up
to the root share one block's launch, and the whole tree stays in one
device buffer of 2n - 1 digests until the one host read at the end.

:func:`build_tree` is the wrapper (CPU tensors go to
:func:`build_tree_plain`, ``hashlib`` per node, the JAX package's host
build; CUDA tensors to the kernels or raise); :func:`build_tree_device`
takes and returns numpy arrays as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import List

import numpy as np
import torch

from .. import _build
from ..fields.farray import resolve_device

# launches of the CUDA kernels (not of the plain version): the leaf level,
# and the node levels (the one-block launch of the top levels included)
launches = {"leaf": 0, "node": 0}

TOP = 256  # csrc/merkle.cu THREADS: the levels of at most TOP nodes share one block

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("merkle")
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.ts_merkle_leaf_launch.argtypes = [vp, ctypes.c_int, ll, vp, vp]
        lib.ts_merkle_node_launch.argtypes = [vp, ll, vp, vp]
        lib.ts_merkle_top_launch.argtypes = [vp, ll, vp]
        for fn in (lib.ts_merkle_leaf_launch, lib.ts_merkle_node_launch, lib.ts_merkle_top_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def level_sizes(n: int) -> List[int]:
    """The digests per level of a tree over n leaves, leaves first."""
    sizes = [n]
    while sizes[-1] > 1:
        sizes.append(sizes[-1] // 2)
    return sizes


def node_launches(n: int) -> int:
    """The node-level launches of a tree over n leaves: one per level of
    more than :data:`TOP` nodes, and one for the levels above them."""
    sizes = level_sizes(n)[1:]
    return sum(m > TOP for m in sizes) + (1 if sizes else 0)


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
    :func:`build_tree_plain`; CUDA tensors one launch per level."""
    n = _check(vals)
    dev = vals.device
    if dev.type == "cpu":
        levels = build_tree_plain(vals.numpy())
        return torch.from_numpy(np.concatenate(levels).view(np.int32))
    if dev.type != "cuda":
        raise ValueError(f"build_tree runs on cpu or cuda, not {dev}")
    lib = _library()
    tree = torch.empty((2 * n - 1, 8), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.ts_merkle_leaf_launch(vals.data_ptr(), vals.shape[1], n, tree.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"Merkle leaf kernel launch failed: CUDA error {rc}")
    launches["leaf"] += 1
    off = 0
    for m in level_sizes(n)[1:]:
        with torch.cuda.device(dev):
            if m <= TOP:  # this level and every one above it in one block
                rc = lib.ts_merkle_top_launch(tree[off].data_ptr(), m, stream)
            else:
                rc = lib.ts_merkle_node_launch(tree[off].data_ptr(), m, tree[off + 2 * m].data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"Merkle node kernel launch failed: CUDA error {rc}")
        launches["node"] += 1
        if m <= TOP:
            break
        off += 2 * m
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
