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
JAX package's ``lsb_to_msb`` fused into the store). The kernel reads the
layer's sort plan (``circuit.scan_plan``); its plain version,
:func:`phase_tables_plain`, scatters by the key itself with ``index_add_``
over 32-bit halves, so the two agree only if the plan is right.

Everything else here is plain torch, exact: the eq table, the gathers,
the dot product, the bit reversal (the JAX package's jnp programs).
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

# launches of the CUDA kernel (not of the plain version), per instantiation
launches = {"goldilocks": 0, "mont32": 0}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("phase_tables").ts_phase_tables_launch
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int]
            + [ctypes.c_void_p] * 8
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def eq_table_dev(r: FArray, n: int) -> FArray:
    """eq(x, r) over little-endian indices (index bit j = r[j]), built with
    n interleave steps on r's device (the host ``runtime.eq_table``'s
    order)."""
    t = FArray.from_ints([1], r.field, device=r.device)
    for j in reversed(range(n)):
        hi = t * r[j]
        lo = t - hi
        t = FArray(torch.stack([lo.data, hi.data], dim=1).reshape(-1), r.field)
    return t


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


def _check(phase, plan, key, gather_idx, is_mul, eq_r, table, k):
    order, starts = plan
    g = key.shape[0]
    dev = eq_r.device
    dtype = word_dtype(eq_r.field)
    if phase not in (1, 2):
        raise ValueError(f"phase must be 1 or 2, not {phase}")
    if table.field != eq_r.field or table.data.dtype != dtype or eq_r.data.dtype != dtype:
        raise ValueError("eq_r and the gathered table must be FArrays of one field")
    want = [(order, torch.int32, (g,)), (starts, torch.int32, ((1 << k) + 1,)), (key, torch.int32, (g,)),
            (gather_idx, torch.int32, (g,)), (is_mul, torch.bool, (g,)), (eq_r.data, dtype, (g,))]
    for t, dt, shape in want + [(table.data, dtype, (table.shape[0],))]:
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
            raise ValueError(f"phase_tables: expected a contiguous {dt} {shape} tensor on {dev}")


def phase_tables(
    phase: int,
    plan: Tuple[torch.Tensor, torch.Tensor],
    key: torch.Tensor,
    gather_idx: torch.Tensor,
    is_mul: torch.Tensor,
    eq_r: FArray,
    table: FArray,
    k: int,
) -> Tuple[FArray, FArray]:
    """The two phase tables of a LibraW phase (module doc), each of 2^k
    cells in internal MSB-first order.

    ``plan``: the (order, starts) sort plan keyed on ``key`` (b in phase 1,
    c in phase 2); ``gather_idx``: the other label (c, then b); ``eq_r``:
    eq(r_i, g) over the layer's gates; ``table``: W in label order (phase
    1) or eq_u (phase 2). CPU tensors take :func:`phase_tables_plain`; CUDA
    tensors launch kernel K2 or raise."""
    eq_r = eq_r[: key.shape[0]] if eq_r.shape[0] != key.shape[0] else eq_r
    _check(phase, plan, key, gather_idx, is_mul, eq_r, table, k)
    dev = eq_r.device
    if dev.type == "cpu":
        return phase_tables_plain(phase, key, gather_idx, is_mul, eq_r, table, k)
    if dev.type != "cuda":
        raise ValueError(f"phase_tables runs on cpu or cuda, not {dev}")
    field = eq_r.field
    size = 1 << k
    out1 = torch.empty(size, dtype=word_dtype(field), device=dev)
    out2 = torch.empty_like(out1)
    mont32 = field.backend == "mont32"
    rc = _kernel()(
        int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0, phase,
        plan[0].data_ptr(), plan[1].data_ptr(), gather_idx.data_ptr(), is_mul.data_ptr(),
        eq_r.data.data_ptr(), table.data.data_ptr(), out1.data_ptr(), out2.data_ptr(),
        size, k, torch.cuda.current_stream(dev).cuda_stream,
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
    a1, a2 = phase_tables(1, wiring.plan_b, wiring.b, wiring.c, wiring.is_mul, eq_r, w_lsb, k)
    return a1, a2, eq_r


def phase2_tables(u: FArray, w_lsb: FArray, eq_r: FArray, wiring, k: int):
    """LibraW phase-2 build: (u [k], W in label order, eq_r, wiring) ->
    (b1, b2 in MSB-first order, w_u = W~(u) as a (1,) FArray)."""
    eq_u = eq_table_dev(u, k)
    b1, b2 = phase_tables(2, wiring.plan_c, wiring.c, wiring.b, wiring.is_mul, eq_r, eq_u, k)
    return b1, b2, dot_mod(w_lsb, eq_u)
