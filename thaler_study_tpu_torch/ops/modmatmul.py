"""Exact modular matrix products for Hopper, and their plain torch versions.

Counterpart of ``thaler_study_tpu/ops/modmatmul.py``: ``modmatmul``
:70, whose two programs ``modmatmul_impl`` :35 and ``_mxu_modmatmul_impl``
:160 both compute C = A B^T mod p for A [M, K] and B [N, K]. The JAX
package takes it for the triangle IP's X-phase contraction
(``ops/round_kernel.py`` ``_term_total`` :186-208),
s = sum_{x,y} f1[x][y] (f3 @ f2^T)[x][y]: :func:`contract_partials` is that
contraction with the dot in the kernel's epilogue, so C is never written.
The CUDA source is ``csrc/modmatmul.cu``; its note says what bounds it and
how. CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise. The batched variants (JAX :235, :267) serve only the sharded
triangle IP (ROADMAP A7).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..fields import FArray, FieldConfig
from ..fields.farray import word_dtype

TILE = 64  # csrc/modmatmul.cu BM = BN: one partial per TILE x TILE outputs
_PLAIN_ELEMS = 1 << 22  # products per broadcast slab of the plain version

# launches of the CUDA kernel (not of the plain versions), per instantiation
launches = {"goldilocks": 0, "mont32": 0}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("modmatmul").ts_modmatmul_launch
        ptr = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ptr, ptr, ptr, ptr,
                       ctypes.c_ulonglong, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(a: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor], field: FieldConfig, halves: bool):
    dtype = word_dtype(field)
    for name, x in (("a", a), ("b", b), ("d", d)):
        if x is None:
            continue
        if x.dtype != dtype or x.dim() != 2 or x.device != a.device or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor on {a.device}")
    rows = a.shape[0] // 2 if halves else a.shape[0]
    if halves and a.shape[0] % 2:
        raise ValueError(f"a must hold two halves of rows, got {a.shape[0]} rows")
    if b.shape[1] != a.shape[1]:
        raise ValueError(f"a [M, K] and b [N, K] disagree on K: {tuple(a.shape)}, {tuple(b.shape)}")
    if d is not None and tuple(d.shape) != ((2 * rows if halves else rows), b.shape[0]):
        raise ValueError(f"d must be [{2 * rows if halves else rows}, {b.shape[0]}], got {tuple(d.shape)}")
    if min(rows, b.shape[0], a.shape[1]) < 1 or max(rows, b.shape[0], a.shape[1]) >= 1 << 31:
        raise ValueError("M, N and K must lie in [1, 2^31)")
    return rows, b.shape[0], a.shape[1]


def _launch(field, mode, a, b, c, d, t, partials, m, n, k):
    mont32 = field.backend == "mont32"
    rc = _kernel()(
        int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0, mode,
        a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(), None if d is None else d.data_ptr(),
        t, None if partials is None else partials.data_ptr(), m, n, k,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"modmatmul kernel launch failed: CUDA error {rc}")
    launches[field.backend] += 1


def modmatmul(a: FArray, b: FArray) -> FArray:
    """C = A @ B^T mod p for A: [M, K], B: [N, K] field tables (mont32:
    the Montgomery words of the sums, as in the JAX package)."""
    field = a.field
    if b.field != field:
        raise ValueError("a and b must be over one field")
    m, n, k = _check(a.data, b.data, None, field, False)
    dev = a.device
    if dev.type == "cpu":
        return modmatmul_plain(a, b)
    if dev.type != "cuda":
        raise ValueError(f"modmatmul runs on cpu or cuda, not {dev}")
    c = torch.empty((m, n), dtype=word_dtype(field), device=dev)
    _launch(field, 0, a.data, b.data, c, None, 0, None, m, n, k)
    return FArray(c, field)


def modmatmul_plain(a: FArray, b: FArray) -> FArray:
    """:func:`modmatmul` in plain torch ops (any device): modular products
    of K-slabs broadcast to [M, N, cs], summed mod p."""
    m, k = a.shape
    n = b.shape[0]
    cs = max(1, min(k, _PLAIN_ELEMS // (m * n)))
    acc = None
    for k0 in range(0, k, cs):
        prod = (a[:, None, k0 : k0 + cs] * b[None, :, k0 : k0 + cs]).sum(axis=2)
        acc = prod if acc is None else acc + prod
    return acc


def _t_word(field: FieldConfig, t: int) -> int:
    """t as a word of ``field`` (mont32: its Montgomery word)."""
    return t % field.p if field.backend == "goldilocks" else t * field.mont_r % field.p


def contract_partials(
    a: torch.Tensor, b: torch.Tensor, d: torch.Tensor, field: FieldConfig, t: Optional[int] = None
) -> torch.Tensor:
    """Partial sums of D_t * (A_t @ B^T), one per TILE x TILE tile of the
    [M, N] output (row-major over the tiles), which the caller sums mod p.
    With ``t`` None, A [M, K] and D [M, N] are used as they are; with ``t``
    an int, A [2M, K] and D [2M, N] hold two halves of rows and A_t = A_lo +
    t (A_hi - A_lo), D_t likewise (a round's views at t). B is [N, K]."""
    halves = t is not None
    m, n, k = _check(a, b, d, field, halves)
    dev = a.device
    if dev.type == "cpu":
        return contract_partials_plain(a, b, d, field, t)
    if dev.type != "cuda":
        raise ValueError(f"contract_partials runs on cpu or cuda, not {dev}")
    partials = torch.empty((-(-m // TILE)) * (-(-n // TILE)), dtype=word_dtype(field), device=dev)
    _launch(field, 2 if halves else 1, a, b, None, d, _t_word(field, t) if halves else 0, partials, m, n, k)
    return partials


def contract_partials_plain(
    a: torch.Tensor, b: torch.Tensor, d: torch.Tensor, field: FieldConfig, t: Optional[int] = None
) -> torch.Tensor:
    """:func:`contract_partials` in plain torch ops (any device): the same
    per-tile partials."""
    fa, fb, fd = FArray(a, field), FArray(b, field), FArray(d, field)
    if t is not None:
        m = a.shape[0] // 2
        tw = FArray.from_ints([t], field, device=a.device).reshape(())
        fa = FArray.fold(fa[:m], fa[m:], tw)
        fd = FArray.fold(fd[:m], fd[m:], tw)
    e = fd * modmatmul_plain(fa, fb)
    m, n = e.shape
    gm, gn = -(-m // TILE), -(-n // TILE)
    padded = torch.nn.functional.pad(e.data, (0, gn * TILE - n, 0, gm * TILE - m))
    tiles = FArray(padded.reshape(gm, TILE, gn, TILE), field).sum(axis=3).sum(axis=1)
    return tiles.data.reshape(-1)
