"""Exact modular matrix products for Hopper, and their plain torch versions.

Counterpart of ``thaler_study_tpu/ops/modmatmul.py``: ``modmatmul``
:70, whose two programs ``modmatmul_impl`` :35 and ``_mxu_modmatmul_impl``
:160 both compute C = A B^T mod p for A [M, K] and B [N, K]. The JAX
package takes it for the triangle IP's X-phase contraction
(``ops/round_kernel.py`` ``_term_total`` :186-208),
s = sum_{x,y} f1[x][y] (f3 @ f2^T)[x][y]: :func:`contract_partials` is that
contraction with the dot in the kernel's epilogue, so C is never written.

On the card every shape runs on ``csrc/modmatmul_tc.cu`` (the tensor
cores: byte digit planes from a pre-pass, digit-pair products on
``wgmma``; the counterpart of ``_mxu_modmatmul_impl``). The JAX package
keeps ``modmatmul_impl`` below a grid M N K of 2^24 (its ``round_kernel.py``
:204) and 2^18 (``modmatmul.py`` :75-76), but on the H100 the tensor-core
kernel is faster at every contraction shape of the triangle IP, 2^23
grids included (``chip_smoke.py`` phase 4 times both at the path's
shapes), so there is one route. ``csrc/modmatmul.cu`` (the CUDA cores; the
counterpart of ``modmatmul_impl``) stays as the yardstick that
``chip_smoke.py`` checks and times beside it: only the ``*_cc`` functions
reach it.

Each source's note says what bounds it and how. CPU tensors take the plain
versions; CUDA tensors launch the kernel or raise. The two kernels write
their partials at their own tiles (:func:`tile`), which callers only sum.
The batched variants (JAX :235, :267) serve only the sharded triangle IP
(ROADMAP A7).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..fields import FArray, FieldConfig
from ..fields.farray import u64_tensor, word_dtype

TILE = 64  # csrc/modmatmul.cu BM = BN: one partial per TILE x TILE outputs
_PLAIN_ELEMS = 1 << 22  # products per broadcast slab of the plain version

# the tensor-core kernel (csrc/modmatmul_tc.cu): bytes per word, the rows of
# A and of B per tile (one partial each), and K_c, the K after which its s32
# digit sums are flushed (D 255^2 K_c < 2^31, D pairs at most per diagonal)
DIGITS = {"goldilocks": 8, "mont32": 4}
TC_TILE = {"goldilocks": (32, 64), "mont32": (64, 64)}
FLUSH_K = {"goldilocks": 4096, "mont32": 8192}

# launches of the CUDA kernels (not of the plain versions), per field family:
# the CUDA-core kernel, the tensor-core kernel and its digit pre-pass
launches = {"goldilocks": 0, "mont32": 0}
tc_launches = {"goldilocks": 0, "mont32": 0}
digit_launches = {"goldilocks": 0, "mont32": 0}

_fns = {}


def _kernel():
    fn = _fns.get("cc")
    if fn is None:
        fn = _build.load("modmatmul").ts_modmatmul_launch
        ptr = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ptr, ptr, ptr, ptr,
                       ctypes.c_ulonglong, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _fns["cc"] = fn
    return fn


def _tc_kernels():
    if "tc" not in _fns:
        lib = _build.load("modmatmul_tc")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        digits, mm = lib.ts_mm_tc_digits, lib.ts_mm_tc_launch
        digits.argtypes = [i32, ctypes.c_uint, ctypes.c_uint, ptr, ctypes.c_ulonglong, i32, ptr, i32, i32, i32, ptr]
        mm.argtypes = [i32, ctypes.c_uint, ctypes.c_uint, i32, ptr, ptr, i32, ptr, ptr, ctypes.c_ulonglong, ptr,
                       i32, i32, i32, ptr]
        digits.restype = mm.restype = i32
        _fns["tc"] = (digits, mm)
    return _fns["tc"]


def _field_args(field: FieldConfig):
    mont32 = field.backend == "mont32"
    return int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0


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


def _on_card(x: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    return True


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _t_word(field: FieldConfig, t: int) -> int:
    """t as a word of ``field`` (mont32: its Montgomery word)."""
    return t % field.p if field.backend == "goldilocks" else t * field.mont_r % field.p


def tile(field: FieldConfig, tc: bool):
    """(rows of A, rows of B) of one partial: the tensor-core kernel's
    tile or the CUDA-core kernel's."""
    return TC_TILE[field.backend] if tc else (TILE, TILE)


def tile_count(field: FieldConfig, tc: bool, m: int, n: int) -> int:
    """Partials of an [m, n] output on either kernel."""
    tm, tn = tile(field, tc)
    return (-(-m // tm)) * (-(-n // tn))


# ---- routing -----------------------------------------------------------------


def modmatmul(a: FArray, b: FArray) -> FArray:
    """C = A @ B^T mod p for A: [M, K], B: [N, K] field tables (mont32:
    the Montgomery words of the sums, as in the JAX package), on the
    tensor cores."""
    if b.field != a.field:
        raise ValueError("a and b must be over one field")
    _check(a.data, b.data, None, a.field, False)
    if not _on_card(a.data, "modmatmul"):
        return modmatmul_plain(a, b)
    return modmatmul_tc(a, b)


def contract_partials(
    a: torch.Tensor, b: torch.Tensor, d: torch.Tensor, field: FieldConfig, t: Optional[int] = None
) -> torch.Tensor:
    """Partial sums of D_t * (A_t @ B^T), one per tile of the [M, N]
    output (row-major over the tensor-core tiles, :func:`tile`), which the
    caller sums mod p. With ``t`` None, A [M, K] and D [M, N] are used as
    they are; with ``t`` an int, A [2M, K] and D [2M, N] hold two halves of
    rows and A_t = A_lo + t (A_hi - A_lo), D_t likewise (a round's views at
    t). B is [N, K]."""
    return contract_partials_many(a, b, d, field, [t])[0]


def contract_partials_many(
    a: torch.Tensor, b: torch.Tensor, d: torch.Tensor, field: FieldConfig, ts: Sequence[Optional[int]]
) -> list:
    """:func:`contract_partials` at every t of ``ts`` (all None or all
    ints): a round's launches, with B's digit planes made once."""
    halves = ts[0] is not None
    if any((t is not None) != halves for t in ts):
        raise ValueError("ts must be all None or all ints")
    _check(a, b, d, field, halves)
    if not _on_card(a, "contract_partials"):
        return [contract_partials_plain(a, b, d, field, t, tile(field, True)) for t in ts]
    b_planes = digit_planes(b, field)
    return [contract_partials_tc(a, b, d, field, t, b_planes) for t in ts]


# ---- the CUDA-core kernel (csrc/modmatmul.cu) ------------------------------------


def _launch_cc(field, mode, a, b, c, d, t, partials, m, n, k):
    rc = _kernel()(
        *_field_args(field), mode,
        a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(), None if d is None else d.data_ptr(),
        t, None if partials is None else partials.data_ptr(), m, n, k, _stream(a),
    )
    if rc != 0:
        raise RuntimeError(f"modmatmul kernel launch failed: CUDA error {rc}")
    launches[field.backend] += 1


def modmatmul_cc(a: FArray, b: FArray) -> FArray:
    """:func:`modmatmul` on the CUDA-core kernel at any shape (CPU tensors:
    :func:`modmatmul_plain`)."""
    field = a.field
    m, n, k = _check(a.data, b.data, None, field, False)
    if not _on_card(a.data, "modmatmul_cc"):
        return modmatmul_plain(a, b)
    c = torch.empty((m, n), dtype=word_dtype(field), device=a.device)
    _launch_cc(field, 0, a.data, b.data, c, None, 0, None, m, n, k)
    return FArray(c, field)


def contract_partials_cc(
    a: torch.Tensor, b: torch.Tensor, d: torch.Tensor, field: FieldConfig, t: Optional[int] = None
) -> torch.Tensor:
    """:func:`contract_partials` on the CUDA-core kernel at any shape, one
    partial per TILE x TILE tile (CPU tensors: the plain version)."""
    halves = t is not None
    m, n, k = _check(a, b, d, field, halves)
    if not _on_card(a, "contract_partials_cc"):
        return contract_partials_plain(a, b, d, field, t, tile(field, False))
    partials = torch.empty(tile_count(field, False, m, n), dtype=word_dtype(field), device=a.device)
    _launch_cc(field, 2 if halves else 1, a, b, None, d, _t_word(field, t) if halves else 0, partials, m, n, k)
    return partials


# ---- the tensor-core kernel (csrc/modmatmul_tc.cu) --------------------------------


def padded_k(k: int) -> int:
    """The digit planes' row length: K rounded up to 16 bytes (TMA's
    stride unit)."""
    return -(-k // 16) * 16


def digit_planes(x: torch.Tensor, field: FieldConfig, t: Optional[int] = None) -> torch.Tensor:
    """The u8 digit planes [D, R, Kp] of the words x [R, K] (D bytes per
    word, little end first, the pad zero), or with ``t`` of the view
    x_lo + t (x_hi - x_lo) of x [2R, K]: the tensor-core kernel's operands,
    from its pre-pass (CPU tensors: :func:`digit_planes_plain`)."""
    dtype = word_dtype(field)
    if x.dtype != dtype or x.dim() != 2 or not x.is_contiguous() or (t is not None and x.shape[0] % 2):
        raise ValueError(f"x must be a contiguous 2-D {dtype} tensor (two halves of rows with t)")
    if not _on_card(x, "digit_planes"):
        return digit_planes_plain(x, field, t)
    rows = x.shape[0] // 2 if t is not None else x.shape[0]
    k = x.shape[1]
    if min(rows, k) < 1 or max(rows, k) >= 1 << 31:
        raise ValueError("R and K must lie in [1, 2^31)")
    kp = padded_k(k)
    out = torch.empty((DIGITS[field.backend], rows, kp), dtype=torch.uint8, device=x.device)
    digits, _ = _tc_kernels()
    rc = digits(*_field_args(field), x.data_ptr(), 0 if t is None else _t_word(field, t), int(t is not None),
                out.data_ptr(), rows, k, kp, _stream(x))
    if rc != 0:
        raise RuntimeError(f"digit-plane kernel launch failed: CUDA error {rc}")
    digit_launches[field.backend] += 1
    return out


def _launch_tc(field, mode, a_planes, b_planes, c, d, t, partials, m, n, k):
    if a_planes.shape[1:] != (m, padded_k(k)) or b_planes.shape[1:] != (n, padded_k(k)):
        raise ValueError("digit planes of the wrong shape")
    _, mm = _tc_kernels()
    rc = mm(*_field_args(field), mode, a_planes.data_ptr(), b_planes.data_ptr(), padded_k(k),
            None if c is None else c.data_ptr(), None if d is None else d.data_ptr(), t,
            None if partials is None else partials.data_ptr(), m, n, k, _stream(a_planes))
    if rc != 0:
        raise RuntimeError(f"tensor-core modmatmul kernel launch failed: error {rc}")
    tc_launches[field.backend] += 1


def modmatmul_tc(a: FArray, b: FArray) -> FArray:
    """:func:`modmatmul` on the tensor-core kernel at any shape (CPU
    tensors: :func:`modmatmul_digits_plain`)."""
    field = a.field
    m, n, k = _check(a.data, b.data, None, field, False)
    if not _on_card(a.data, "modmatmul_tc"):
        return modmatmul_digits_plain(a, b)
    c = torch.empty((m, n), dtype=word_dtype(field), device=a.device)
    _launch_tc(field, 0, digit_planes(a.data, field), digit_planes(b.data, field), c, None, 0, None, m, n, k)
    return FArray(c, field)


def contract_partials_tc(
    a: torch.Tensor, b: torch.Tensor, d: torch.Tensor, field: FieldConfig, t: Optional[int] = None,
    b_planes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`contract_partials` on the tensor-core kernel at any shape,
    one partial per :data:`TC_TILE` tile; ``b_planes`` are B's digit planes
    where the caller has them (CPU tensors: the plain digit form)."""
    halves = t is not None
    m, n, k = _check(a, b, d, field, halves)
    if not _on_card(a, "contract_partials_tc"):
        return contract_partials_plain(a, b, d, field, t, tile(field, True), digits=True)
    if b_planes is None:
        b_planes = digit_planes(b, field)
    partials = torch.empty(tile_count(field, True, m, n), dtype=word_dtype(field), device=a.device)
    _launch_tc(field, 2 if halves else 1, digit_planes(a, field, t), b_planes, None, d,
               _t_word(field, t) if halves else 0, partials, m, n, k)
    return partials


# ---- plain versions ---------------------------------------------------------------


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


def digit_planes_plain(x: torch.Tensor, field: FieldConfig, t: Optional[int] = None) -> torch.Tensor:
    """:func:`digit_planes` in plain torch ops (any device): the words'
    little-endian bytes as planes."""
    if t is not None:
        rows = x.shape[0] // 2
        tw = FArray.from_ints([t], field, device=x.device).reshape(())
        x = FArray.fold(FArray(x[:rows], field), FArray(x[rows:], field), tw).data
    r, k = x.shape
    planes = x.contiguous().view(torch.uint8).reshape(r, k, DIGITS[field.backend]).permute(2, 0, 1)
    return torch.nn.functional.pad(planes, (0, padded_k(k) - k)).contiguous()


def modmatmul_digits_plain(a: FArray, b: FArray) -> FArray:
    """:func:`modmatmul` in the tensor-core kernel's digit form, in plain
    torch ops (any device): digit planes, every digit-pair grid as one
    exact float64 product per K_c chunk (integers below 2^53), the
    diagonal sums (each below 2^31, as the kernel's s32 sums), and their
    recombination sum_s diag_s 256^s mod p per chunk, summed mod p (mont32:
    REDC(diag_s (256^s mod p)) per diagonal, the Montgomery word of the
    sum of products)."""
    field = a.field
    nd, kc = DIGITS[field.backend], FLUSH_K[field.backend]
    pa = digit_planes_plain(a.data, field).to(torch.float64)  # [D, M, Kp]
    pb = digit_planes_plain(b.data, field).to(torch.float64)  # [D, N, Kp]
    m, n = pa.shape[1], pb.shape[1]
    pows = np.array([pow(256, s, field.p) for s in range(2 * nd - 1)], dtype=np.uint64)
    weights = FArray(u64_tensor(pows, a.device, word_dtype(field)), field)
    acc = FArray.zeros((m, n), field, device=a.device)
    for k0 in range(0, pa.shape[2], kc):
        grids = torch.matmul(pa[:, None, :, k0 : k0 + kc], pb[None, :, :, k0 : k0 + kc].transpose(-1, -2))
        for s in range(2 * nd - 1):
            diag = sum(grids[i, s - i] for i in range(max(0, s - nd + 1), min(nd, s + 1))).to(torch.int64)
            if int(diag.max()) >= 1 << 31:
                raise AssertionError("a digit diagonal exceeds the kernel's s32 sums")
            word = FArray((diag % field.p).to(word_dtype(field)), field)
            acc = acc + word * weights[s]
    return acc


def contract_partials_plain(
    a: torch.Tensor, b: torch.Tensor, d: torch.Tensor, field: FieldConfig, t: Optional[int] = None,
    tiles=(TILE, TILE), digits: bool = False,
) -> torch.Tensor:
    """:func:`contract_partials` in plain torch ops (any device): the same
    per-tile partials, one per ``tiles`` = (rows of A, rows of B) tile;
    ``digits`` forms C in the digit form (:func:`modmatmul_digits_plain`)."""
    return tile_sums(contract_products_plain(a, b, d, field, t, digits), tiles)


def contract_products_plain(
    a: torch.Tensor, b: torch.Tensor, d: torch.Tensor, field: FieldConfig, t: Optional[int] = None,
    digits: bool = False,
) -> FArray:
    """D_t * (A_t @ B^T) [M, N], elementwise, in plain torch ops."""
    fa, fb, fd = FArray(a, field), FArray(b, field), FArray(d, field)
    if t is not None:
        m = a.shape[0] // 2
        tw = FArray.from_ints([t], field, device=a.device).reshape(())
        fa = FArray.fold(fa[:m], fa[m:], tw)
        fd = FArray.fold(fd[:m], fd[m:], tw)
    return fd * (modmatmul_digits_plain if digits else modmatmul_plain)(fa, fb)


def tile_sums(e: FArray, tiles) -> torch.Tensor:
    """Sums mod p of e [M, N] over tiles of ``tiles`` = (tm, tn) entries,
    row-major over the tiles (the ragged edge padded with zeros)."""
    tm, tn = tiles
    m, n = e.shape
    gm, gn = -(-m // tm), -(-n // tn)
    padded = torch.nn.functional.pad(e.data, (0, gn * tn - n, 0, gm * tm - m))
    sums = FArray(padded.reshape(gm, tm, gn, tn), e.field).sum(axis=3).sum(axis=1)
    return sums.data.reshape(-1)
