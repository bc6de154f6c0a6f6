"""Device-side GKR bookkeeping: eq tables, gathers, the LibraW phase tables.

Counterpart of ``thaler_study_tpu/gkr/device_tables.py``, shipped defaults
only (the ``scan`` scatter mode; the ``segment`` and ``plan`` modes and the
``assoc`` core are A/B switches of the JAX package and are not ported).

The phase tables of the linear-time layer sumcheck (``gkr/linear.py``)
are exact modular scatter-adds, grid[idx[g]] += vals[g] mod p, which no
PyTorch call states (``index_add_`` wraps mod 2^64). They are kernel K2,
``csrc/phase_tables.cu``, entered through :func:`phase_tables`:

- phase 1 (key b_g, gather W[c_g]):
  a1[b] = sum_{g: b_g = b} (mul_g ? eq_r[g] W[c_g] : eq_r[g]),
  a2[b] = sum_{g: b_g = b} (mul_g ? 0 : eq_r[g] W[c_g]);
- phase 2 (key c_g, gather eq_u[b_g]), with t_g = eq_r[g] eq_u[b_g]:
  b1[c] = sum_{g: c_g = c} (mul_g ? 0 : t_g),
  b2[c] = sum_{g: c_g = c} (mul_g ? t_g : 0).

Both outputs come out of one launch, in internal MSB-first order (the
JAX package's ``lsb_to_msb``). The kernel reads the layer's static plan
(``circuit.PhasePlan``: the gates listed in output order, their gather
index and type packed in that order), so it writes each output position
once, in order; its plain version, :func:`phase_tables_plain`, scatters
by the key itself with ``index_add_`` over 32-bit halves and then bit
reverses, so the two agree only if the plan is right.

Two more builders have kernels of their own, ``csrc/gkr_tables.cu``:

- :func:`eq_table_dev`, eq(x, r) over 2^n indices (plain version
  :func:`eq_table_plain`, n interleave steps);
- :func:`line_restrict_coeffs`, the k + 1 coefficients of
  q(t) = W~(u + t delta), the fused GKR prover's line restriction (plain
  version :func:`line_restrict_coeffs_plain`, the JAX package's symbolic
  fold in FArray ops).

Everything else here is plain torch, exact: the gathers, the dot product,
the bit reversal (the JAX package's jnp programs).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from ..fields import FArray, FieldConfig
from ..fields import goldilocks as gl
from ..fields.farray import word_dtype
from ..mle.dense import bitrev

THREADS = 256  # csrc/phase_tables.cu THREADS

# launches of the CUDA kernels (not of the plain versions), per instantiation:
# K2, the eq table, and the line restriction's fold steps
launches = {"goldilocks": 0, "mont32": 0}
eq_launches = {"goldilocks": 0, "mont32": 0}
line_launches = {"goldilocks": 0, "mont32": 0}

_fn = None
_tables = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("phase_tables").ts_phase_tables_launch
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int]
            + [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _tables_lib():
    global _tables
    if _tables is None:
        lib = _build.load("gkr_tables")
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.ts_eq_table_launch.argtypes = [i, u, u, vp, i, vp, vp]
        lib.ts_eq_table_launch.restype = i
        lib.ts_line_fold_launch.argtypes = [i, u, u, vp, i, vp, vp, vp, ctypes.c_longlong, vp]
        lib.ts_line_fold_launch.restype = i
        _tables = lib
    return _tables


def _field_args(field: FieldConfig):
    mont32 = field.backend == "mont32"
    return int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0


def _check_vector(name: str, x: FArray, n: int) -> None:
    if x.data.dim() != 1 or x.shape[0] < n or not x.data.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D FArray of at least {n} elements, got {x.shape}")


def eq_table_dev(r: FArray, n: int) -> FArray:
    """eq(x, r) over little-endian indices (index bit j = r[j]) for the 2^n
    x, on r's device (the host ``runtime.eq_table``'s order). CPU tensors
    run :func:`eq_table_plain`; CUDA tensors launch the eq-table kernel or
    raise."""
    _check_vector("r", r, n)
    dev = r.device
    if dev.type == "cpu":
        return eq_table_plain(r, n)
    if dev.type != "cuda":
        raise ValueError(f"eq_table_dev runs on cpu or cuda, not {dev}")
    out = torch.empty(1 << n, dtype=word_dtype(r.field), device=dev)
    rc = _tables_lib().ts_eq_table_launch(
        *_field_args(r.field), r.data.data_ptr(), n, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream
    )
    if rc != 0:
        raise RuntimeError(f"eq-table kernel launch failed: CUDA error {rc}")
    eq_launches[r.field.backend] += 1
    return FArray(out, r.field)


def eq_table_plain(r: FArray, n: int) -> FArray:
    """:func:`eq_table_dev` in plain torch ops (any device): n interleave
    steps, t -> (t (1 - r_j), t r_j) from the last variable down."""
    t = FArray.from_ints([1], r.field, device=r.device)
    for j in reversed(range(n)):
        hi = t * r[j]
        lo = t - hi
        t = FArray(torch.stack([lo.data, hi.data], dim=1).reshape(-1), r.field)
    return t


def line_restrict_coeffs(w_lsb: FArray, u: FArray, delta: FArray, k: int) -> FArray:
    """The coefficients (ascending powers of t) of q(t) = W~(u + t delta),
    the degree-k restriction of the multilinear W (``w_lsb``, 2^k values in
    label order) to a line: W folded one variable at a time with
    r_j(t) = u_j + t delta_j carried symbolically (``csrc/gkr_tables.cu``).
    Returns a [k + 1] FArray. CPU tensors run
    :func:`line_restrict_coeffs_plain`; CUDA tensors launch one fold step of
    the kernel per variable or raise."""
    if w_lsb.shape != (1 << k,) or not w_lsb.data.is_contiguous():
        raise ValueError(f"w_lsb must be a contiguous FArray of {1 << k} values, got {w_lsb.shape}")
    _check_vector("u", u, k)
    _check_vector("delta", delta, k)
    dev = w_lsb.device
    if u.field != w_lsb.field or delta.field != w_lsb.field or u.device != dev or delta.device != dev:
        raise ValueError("w_lsb, u and delta must be FArrays of one field on one device")
    if dev.type == "cpu":
        return line_restrict_coeffs_plain(w_lsb, u, delta, k)
    if dev.type != "cuda":
        raise ValueError(f"line_restrict_coeffs runs on cpu or cuda, not {dev}")
    lib, args = _tables_lib(), _field_args(w_lsb.field)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cur = w_lsb.data
    for j in range(k):
        half = 1 << (k - j - 1)
        out = torch.empty(half * (j + 2), dtype=cur.dtype, device=dev)
        rc = lib.ts_line_fold_launch(
            *args, cur.data_ptr(), j, u.data.data_ptr(), delta.data.data_ptr(), out.data_ptr(), half, stream
        )
        if rc != 0:
            raise RuntimeError(f"line-restriction kernel launch failed: CUDA error {rc}")
        line_launches[w_lsb.field.backend] += 1
        cur = out
    return FArray(cur, w_lsb.field)


def line_restrict_coeffs_plain(w_lsb: FArray, u: FArray, delta: FArray, k: int) -> FArray:
    """:func:`line_restrict_coeffs` in FArray ops (any device), the JAX
    package's fold: each step turns the [2h, j + 1] table of degree-j
    polynomials into [h, j + 2], even + r_j(t) (odd - even)."""
    field = w_lsb.field
    arr = w_lsb.reshape(-1, 1)
    for j in range(k):
        pairs = arr.data.reshape(-1, 2, j + 1)
        even, odd = FArray(pairs[:, 0, :], field), FArray(pairs[:, 1, :], field)
        diff = odd - even
        zero = torch.zeros_like(even.data[:, :1])
        # r_j(t) diff(t) = u_j diff + t delta_j diff
        a = torch.cat([(diff * u[j]).data, zero], dim=1)
        b = torch.cat([zero, (diff * delta[j]).data], dim=1)
        arr = FArray(torch.cat([even.data, zero], dim=1), field) + FArray(a, field) + FArray(b, field)
    return arr.reshape(-1)


def gather(table: FArray, idx: torch.Tensor) -> FArray:
    """table[idx] (a row gather of one word per element)."""
    return FArray(torch.index_select(table.data, 0, idx), table.field)


def dot_mod(a: FArray, b: FArray) -> FArray:
    """sum_i a[i] b[i] mod p, as a (1,) FArray."""
    return (a * b).sum(axis=0).reshape(1)


def lsb_to_msb(table: FArray, n: int) -> FArray:
    """Label (little-endian) order -> internal MSB-first order."""
    return bitrev(table, n)


def _scatter_add_mod(key: torch.Tensor, vals: FArray, size: int) -> FArray:
    """grid[key[g]] += vals[g] mod p over a zero grid: integer index_add_
    of the words' 32-bit halves (Goldilocks) or of the words (mont32, each
    < 2^31), exact for fewer than 2^31 contributions per cell, then one
    reduction per cell."""
    key = key.to(torch.int64)
    x = vals.data
    if vals.field.backend == "goldilocks":
        lo = torch.zeros(size, dtype=torch.int64, device=x.device).index_add_(0, key, x & gl.MASK32)
        hi = torch.zeros(size, dtype=torch.int64, device=x.device).index_add_(0, key, (x >> 32) & gl.MASK32)
        return FArray(gl.add(lo, gl.mul(hi, torch.full_like(hi, 1 << 32))), vals.field)
    s = torch.zeros(size, dtype=torch.int64, device=x.device).index_add_(0, key, x.to(torch.int64))
    return FArray((s % vals.field.p).to(torch.int32), vals.field)


def _check(phase, wiring, eq_r: FArray, table: FArray, k: int):
    g = wiring.b.shape[0]
    dev = eq_r.device
    dtype = word_dtype(eq_r.field)
    if phase not in (1, 2):
        raise ValueError(f"phase must be 1 or 2, not {phase}")
    if table.field != eq_r.field or table.data.dtype != dtype or eq_r.data.dtype != dtype:
        raise ValueError("eq_r and the gathered table must be FArrays of one field")
    if table.data.dim() != 1 or table.shape[0] < 1 << k:
        raise ValueError(f"the gathered table must hold the 2^{k} values the labels index")
    plan = wiring.plan1 if phase == 1 else wiring.plan2
    want = [(wiring.b, torch.int32, (g,)), (wiring.c, torch.int32, (g,)), (wiring.is_mul, torch.bool, (g,)),
            (plan.order, torch.int32, (g,)), (plan.starts, torch.int32, ((1 << k) + 1,)),
            (plan.packed, torch.int32, (g,)), (eq_r.data, dtype, (g,)), (table.data, dtype, (table.shape[0],))]
    for t, dt, shape in want:
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
            raise ValueError(f"phase_tables: expected a contiguous {dt} {shape} tensor on {dev}")
    return plan


def phase_tables(phase: int, wiring, eq_r: FArray, table: FArray, k: int) -> Tuple[FArray, FArray]:
    """The two phase tables of a LibraW phase (module doc), each of 2^k
    cells in internal MSB-first order.

    ``wiring``: the layer's ``circuit.LayerWiring`` (phase 1 keys on b and
    gathers at c with ``plan1``, phase 2 keys on c and gathers at b with
    ``plan2``); ``eq_r``: eq(r_i, g) over the layer's gates; ``table``: W
    in label order (phase 1) or eq_u (phase 2). CPU tensors take
    :func:`phase_tables_plain`; CUDA tensors launch kernel K2 or raise."""
    eq_r = eq_r[: wiring.b.shape[0]] if eq_r.shape[0] != wiring.b.shape[0] else eq_r
    plan = _check(phase, wiring, eq_r, table, k)
    dev = eq_r.device
    if dev.type == "cpu":
        key, gidx = (wiring.b, wiring.c) if phase == 1 else (wiring.c, wiring.b)
        return phase_tables_plain(phase, key, gidx, wiring.is_mul, eq_r, table, k)
    if dev.type != "cuda":
        raise ValueError(f"phase_tables runs on cpu or cuda, not {dev}")
    field = eq_r.field
    size = 1 << k
    out1 = torch.empty(size, dtype=word_dtype(field), device=dev)
    out2 = torch.empty_like(out1)
    rc = _kernel()(
        *_field_args(field), phase, plan.order.data_ptr(), plan.starts.data_ptr(), plan.packed.data_ptr(),
        eq_r.data.data_ptr(), table.data.data_ptr(), out1.data_ptr(), out2.data_ptr(), size,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"phase-table kernel launch failed: CUDA error {rc}")
    launches[field.backend] += 1
    return FArray(out1, field), FArray(out2, field)


def phase_tables_plain(phase, key, gather_idx, is_mul, eq_r: FArray, table: FArray, k: int):
    """K2's function in plain torch ops (any device): the per-gate values
    by FArray arithmetic, an exact integer scatter-add by the key, the bit
    reversal to MSB-first order."""
    prod = eq_r * gather(table, gather_idx)
    zero = torch.zeros_like(prod.data)
    if phase == 1:
        x1 = torch.where(is_mul, prod.data, eq_r.data)
        x2 = torch.where(is_mul, zero, prod.data)
    else:
        x1 = torch.where(is_mul, zero, prod.data)
        x2 = torch.where(is_mul, prod.data, zero)
    size = 1 << k
    field: FieldConfig = eq_r.field
    return tuple(lsb_to_msb(_scatter_add_mod(key, FArray(x, field), size), k) for x in (x1, x2))


def phase1_tables(r_i: FArray, w_lsb: FArray, wiring, k_cur: int, k: int):
    """LibraW phase-1 build: (r_i [k_cur], W in label order [2^k], the
    layer's ``circuit.LayerWiring``) -> (a1, a2 in MSB-first order,
    eq_r [2^k_cur])."""
    eq_r = eq_table_dev(r_i, k_cur)
    a1, a2 = phase_tables(1, wiring, eq_r, w_lsb, k)
    return a1, a2, eq_r


def phase2_tables(u: FArray, w_lsb: FArray, eq_r: FArray, wiring, k: int):
    """LibraW phase-2 build: (u [k], W in label order, eq_r, wiring) ->
    (b1, b2 in MSB-first order, w_u = W~(u) as a (1,) FArray)."""
    eq_u = eq_table_dev(u, k)
    b1, b2 = phase_tables(2, wiring, eq_r, eq_u, k)
    return b1, b2, dot_mod(w_lsb, eq_u)
