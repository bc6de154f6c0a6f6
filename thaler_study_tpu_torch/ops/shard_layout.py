"""The sharded layout of a factor table on the card, and its plain version.

Counterpart of the transpose before the ``device_put`` in the JAX package's
``shard_factor`` (``thaler_study_tpu/parallel/sharded.py:79``): a table of
2^n words read as [L, S] (S = 2^n_shard shard rows on its last n_shard
variables, L = 2^(n - n_shard)), and a group's shard rows [row0, row0 +
rows) of it as [rows, L]. ``parallel/sharded.shard_factor`` lays out every
sharded factor table with :func:`shard_rows`, one launch per table and
group. The CUDA source is ``csrc/shard_layout.cu``; its note says what
bounds it and how the tiles meet it. CPU tensors take
:func:`shard_rows_plain`; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build

TILE_BYTES = 16384  # csrc/shard_layout.cu TILE_BYTES
MAX_TC = 32  # the most columns of one tile
_MAX_GRID_Y = 65535

# launches of the CUDA kernel (not of the plain version), per word type
launches = {"goldilocks": 0, "mont32": 0}
_BACKEND = {torch.int64: "goldilocks", torch.int32: "mont32"}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("shard_layout").ts_shard_rows_launch
        i, ll, vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [i, vp, vp, ll, ll, ll, i, i, i, i, vp]
        fn.restype = i
        _fn = fn
    return _fn


def tile(rows: int, cols: int, word_bytes: int) -> Tuple[int, int]:
    """The kernel's tile for a group of ``rows`` shard rows of ``cols``
    entries each: (TC, TL), TC the rows rounded up to a power of two, at
    most MAX_TC, and TL = TILE_BYTES / (TC words), at most ``cols``."""
    tc = min(MAX_TC, 1 << (rows - 1).bit_length())
    return tc, min(TILE_BYTES // word_bytes // tc, cols)


def _check(words: torch.Tensor, n_shard: int, row0: int, rows: int) -> Tuple[int, int]:
    if words.dim() != 1 or words.dtype not in _BACKEND or not words.is_contiguous():
        raise ValueError(f"words must be a contiguous 1-D int64 or int32 tensor, got {words.dtype} "
                         f"{tuple(words.shape)}")
    n = words.shape[0].bit_length() - 1
    if words.shape[0] != 1 << n or not 0 <= n_shard <= n:
        raise ValueError(f"a table of {words.shape[0]} words cannot shard {n_shard} variables")
    shards = 1 << n_shard
    if rows < 1 or row0 < 0 or row0 + rows > shards:
        raise ValueError(f"shard rows [{row0}, {row0 + rows}) are not a group of {shards} shard rows")
    return shards, 1 << (n - n_shard)


def shard_rows(words: torch.Tensor, n_shard: int, row0: int, rows: int) -> torch.Tensor:
    """Shard rows [row0, row0 + rows) of a table of 2^n field words (1-D,
    internal order) sharded on its last ``n_shard`` variables: [rows, L] with
    out[s, l] = words[l * 2^n_shard + row0 + s], L = 2^(n - n_shard). One
    launch on the card; CPU tensors take :func:`shard_rows_plain`."""
    shards, cols = _check(words, n_shard, row0, rows)
    dev = words.device
    if dev.type == "cpu":
        return shard_rows_plain(words, n_shard, row0, rows)
    if dev.type != "cuda":
        raise ValueError(f"shard_rows runs on cpu or cuda, not {dev}")
    wb = words.element_size()
    tc, tl = tile(rows, cols, wb)
    if -(-rows // tc) > _MAX_GRID_Y:
        raise ValueError(f"shard_rows takes at most {_MAX_GRID_Y * MAX_TC} shard rows per group")
    out = torch.empty((rows, cols), dtype=words.dtype, device=dev)
    vec = 16 // wb
    whole = (rows % tc == 0 and tc % vec == 0 and tl % vec == 0 and row0 % vec == 0
             and words.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        rc = _kernel()(wb, words.data_ptr(), out.data_ptr(), cols, shards, row0, rows, tc.bit_length() - 1,
                       tl.bit_length() - 1, vec if whole else 1, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"shard layout kernel launch failed: CUDA error {rc}")
    launches[_BACKEND[words.dtype]] += 1
    return out


def shard_rows_plain(words: torch.Tensor, n_shard: int, row0: int, rows: int) -> torch.Tensor:
    """:func:`shard_rows` in plain torch ops (any device): the [L, S] view's
    columns, transposed and copied."""
    shards, cols = _check(words, n_shard, row0, rows)
    return words.reshape(cols, shards)[:, row0 : row0 + rows].T.contiguous()
