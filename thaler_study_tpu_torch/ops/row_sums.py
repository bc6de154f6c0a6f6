"""Sums of a sharded round's rows on the card, and their plain version.

The reduction half of ``parallel/sharded.collective("sum")`` (the JAX
package's GSPMD psum of the round sums, ``thaler_study_tpu/parallel/
sharded.py``): a device other than the first sums its R rows of D + 1
round sums into one row before sending it, and across processes one row
crosses as 32-bit lanes in int64 (exact for any world size below 2^31)
and is recombined after the ``all_reduce``. The CUDA source is
``csrc/row_sums.cu`` (one block per launch); its note says what bounds
it. CPU tensors take :func:`row_sums_plain`; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..fields import FArray, FieldConfig
from ..fields.farray import word_dtype

MAX_D1 = 9  # csrc/row_sums.cu MAX_D1

# launches of the CUDA kernel (not of the plain version), per field family
launches = {"goldilocks": 0, "mont32": 0}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("row_sums").ts_row_sums_launch
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, ctypes.c_uint, ctypes.c_uint, vp, i, i, i, i, vp, vp]
        fn.restype = i
        _fn = fn
    return _fn


def empty_launch(dev: torch.device) -> None:
    """One launch of ``csrc/row_sums.cu``'s empty kernel (one block) on
    ``dev``'s current stream: the latency floor set beside this kernel's
    time. Not counted: it computes nothing."""
    lib = _build.load("row_sums")
    lib.ts_empty_launch.argtypes = [ctypes.c_void_p]
    lib.ts_empty_launch.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = lib.ts_empty_launch(torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


def lanes(field: FieldConfig) -> int:
    """Rows of a word row's lanes: Goldilocks 2 (its low and high 32 bits),
    mont32 1 (the word as an integer)."""
    return 2 if field.backend == "goldilocks" else 1


def row_sums(rows: torch.Tensor, field: FieldConfig, in_lanes: bool = False, out_lanes: bool = False,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum of ``rows`` as one row: ``rows`` [R, D1] field words, or with
    ``in_lanes`` one row's lanes ([lanes, D1] int64 sums from an
    ``all_reduce``; R = 0 sums to 0). Returns [D1] words, or with ``out_lanes`` the sum's
    lanes [lanes, D1] (int64), into ``out`` where given. One launch on the
    card; CPU tensors take :func:`row_sums_plain`."""
    dtype = word_dtype(field)
    want_in = torch.int64 if in_lanes else dtype
    if in_lanes and out_lanes:
        raise ValueError("row_sums takes lanes in or gives lanes out, not both")
    if (rows.dim() != 2 or rows.dtype != want_in or not rows.is_contiguous() or not 1 <= rows.shape[1] <= MAX_D1
            or (in_lanes and rows.shape[0] != lanes(field))):
        raise ValueError(f"rows must be a contiguous [{'lanes' if in_lanes else 'R'}, D1 <= {MAX_D1}] {want_in} "
                         f"tensor, got {rows.dtype} {tuple(rows.shape)}")
    d1 = rows.shape[1]
    shape = (lanes(field), d1) if out_lanes else (d1,)
    out_dtype = torch.int64 if out_lanes else dtype
    if out is not None and (out.dtype != out_dtype or tuple(out.shape) != shape or out.device != rows.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {out_dtype} {shape} tensor on {rows.device}")
    dev = rows.device
    if dev.type == "cpu":
        s = row_sums_plain(rows, field, in_lanes, out_lanes)
        if out is None:
            return s
        out.copy_(s)
        return out
    if dev.type != "cuda":
        raise ValueError(f"row_sums runs on cpu or cuda, not {dev}")
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=dev)
    mont32 = field.backend == "mont32"
    with torch.cuda.device(dev):
        rc = _kernel()(int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0, rows.data_ptr(),
                       rows.shape[0], d1, int(in_lanes), int(out_lanes), out.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row sums kernel launch failed: CUDA error {rc}")
    launches[field.backend] += 1
    return out


def row_sums_plain(rows: torch.Tensor, field: FieldConfig, in_lanes: bool = False,
                   out_lanes: bool = False) -> torch.Tensor:
    """:func:`row_sums` in plain torch ops (any device)."""
    if in_lanes:
        if field.backend == "goldilocks":
            lo, hi = FArray(rows[0].contiguous(), field), FArray(rows[1].contiguous(), field)
            return (lo + hi * FArray.scalar(field.felt(1 << 32), device=rows.device)).data
        return (rows[0] % field.p).to(word_dtype(field))
    s = FArray(rows, field).sum(axis=0).data
    if not out_lanes:
        return s
    if field.backend == "goldilocks":
        return torch.stack([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF])
    return s.to(torch.int64).reshape(1, -1)
