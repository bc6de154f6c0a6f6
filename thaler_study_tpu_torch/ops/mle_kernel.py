"""The dense MLE's device programs on the card, and their plain versions.

Counterpart of three jnp programs of ``thaler_study_tpu/mle/dense.py``:
``_device_bitrev`` (:44, the bit reversal), ``_fold_impl`` (:176, the fold
of a table's first k variables, ``DenseMLE.fix_variables``) and
``_eval_many_impl`` (:185, the evaluation at P points,
``DenseMLE.evaluate_many``). The CUDA source is ``csrc/mle.cu``: one
bit-reversal kernel, the fold kernel (:func:`fold`) and the evaluation in
two forms, a big table over row chunks and point groups and a tiny table
at one thread per point (:func:`eval_many`). Its note says what bounds
each and how it is laid out; :func:`plan` and :func:`eval_plan` decide the
grids in Python. CPU tensors take the plain versions (:func:`bitrev_plain`,
:func:`fold_plain`, :func:`eval_many_plain`: the JAX package's index
permutation and fold chains in plain torch); CUDA tensors launch the
kernels or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import torch

from .. import _build
from ..fields import FArray

MID_WORDS = 2048  # csrc/mle.cu MID_WORDS: the middle eq tables' words per block
TARGET_BLOCKS = 512  # the fold plan's least block count (about four per SM)
_MAX_S = 15  # grid y = 2^s row chunks
# the evaluation (csrc/mle.cu): tables of at most 2^TINY_LOG words take the
# tiny form; the big form takes up to EVAL_POINTS points per block, 16-byte
# loads of 2^LOAD_LOG words, 2^LANE_LOG lanes, at most 2^EVAL_MID_LOG (h, v)
# factors per point, and about EVAL_TARGET_BLOCKS blocks
TINY_LOG = 5
EVAL_POINTS = 8
LOAD_LOG = {"goldilocks": 1, "mont32": 2}
LANE_LOG = 8
EVAL_MID_LOG = 7
EVAL_TARGET_BLOCKS = 256
_MAX_EVAL_S = 30

# launches of the CUDA kernels (not of the plain versions), per field family
bitrev_launches = {"goldilocks": 0, "mont32": 0}
fold_launches = {"goldilocks": 0, "mont32": 0}
eval_launches = {"goldilocks": 0, "mont32": 0}

_lib = None
_tickets: Dict[int, torch.Tensor] = {}  # device index -> the fold's ticket counters


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("mle")
        vp, i, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
        lib.ts_bitrev_launch.argtypes = [i, vp, vp, i, vp]
        lib.ts_bitrev_launch.restype = i
        lib.ts_fold_launch.argtypes = [i, u, u, vp, vp, i, i, i, i, i, i, vp, vp, vp, vp]
        lib.ts_fold_launch.restype = i
        lib.ts_eval_launch.argtypes = [i, u, u, vp, vp, ll, i, ll, i, i, i, vp, vp, vp, vp]
        lib.ts_eval_launch.restype = i
        _lib = lib
    return _lib


def _check_table(name: str, table: FArray, n: int) -> None:
    if table.shape != (1 << n,) or not table.data.is_contiguous():
        raise ValueError(f"{name} takes a contiguous table of 2^{n} words, got {table.shape}")


def _check_cuda(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")


# ---- the bit reversal ----


def bitrev_index(n: int, device) -> torch.Tensor:
    """The bit-reversal permutation on [0, 2^n) as int64 on ``device``: rev_n
    is (2 rev_{n-1}, 2 rev_{n-1} + 1), n doubling steps."""
    rev = torch.zeros(1, dtype=torch.int64, device=device)
    for _ in range(n):
        rev = torch.cat([2 * rev, 2 * rev + 1])
    return rev


def bitrev(table: FArray, n: int) -> FArray:
    """out[i] = table[brev_n(i)] for a table of 2^n words (an involution:
    label order <-> internal MSB-first order). One launch on the card, the
    index computed in the kernel; CPU tensors take :func:`bitrev_plain`."""
    _check_table("bitrev", table, n)
    dev = table.device
    if dev.type == "cpu":
        return bitrev_plain(table, n)
    _check_cuda("bitrev", dev)
    if n > 31:
        raise ValueError(f"bitrev takes tables of at most 2^31 words, got 2^{n}")
    out = torch.empty_like(table.data)
    with torch.cuda.device(dev):
        rc = _kernels().ts_bitrev_launch(table.data.element_size(), table.data.data_ptr(), out.data_ptr(), n,
                                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bit-reversal kernel launch failed: CUDA error {rc}")
    bitrev_launches[table.field.backend] += 1
    return FArray(out, table.field)


def bitrev_plain(table: FArray, n: int) -> FArray:
    """:func:`bitrev` in plain torch ops (any device): one gather by
    :func:`bitrev_index`."""
    _check_table("bitrev", table, n)
    return FArray(table.data[bitrev_index(n, table.device)], table.field)


# ---- the fold (the fold chain) ----


@dataclasses.dataclass(frozen=True)
class Plan:
    """The fold kernel's grid for a table of 2^n words folded over its
    first k variables at one point: tiles of 2^ct_log columns (grid x),
    2^s row chunks (grid y); a row x of a chunk is (s chunk bits, mb
    middle bits, c lane bits)."""

    ct_log: int
    s: int
    c: int
    mb: int
    tiles: int


def plan(n: int, k: int) -> Plan:
    """The fold kernel's :class:`Plan`: 2^s row chunks for at least
    ``TARGET_BLOCKS`` blocks, or more where a chunk's middle bits would
    outgrow ``MID_WORDS`` words; c = the lanes' bits, at most the chunk's
    rows."""
    if not 1 <= k <= n:
        raise ValueError(f"no fold plan for k = {k} of n = {n}")
    ct_log = min(n - k, 8)
    lane_log = 8 - ct_log
    tiles = 1 << (n - k - ct_log)
    mb_max = MID_WORDS.bit_length() - 1
    s = 0
    while (tiles << s) < TARGET_BLOCKS and s < k:
        s += 1
    s = min(max(s, k - lane_log - mb_max), k)
    if s > _MAX_S:
        raise ValueError(f"a fold of {k} variables at {2 ** (n - k)} columns needs 2^{s} row chunks (at most "
                         f"2^{_MAX_S})")
    c = min(lane_log, k - s)
    return Plan(ct_log, s, c, k - s - c, tiles)


def _tickets_for(dev: torch.device, count: int) -> torch.Tensor:
    """``count`` ticket counters on ``dev`` (int32, 0 between launches),
    kept per device and grown as needed."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    t = _tickets.get(key)
    if t is None or t.numel() < count:
        t = _tickets[key] = torch.zeros(max(count, 1024), dtype=torch.int32, device=torch.device("cuda", key))
    return t


def _field_args(field) -> tuple:
    mont32 = field.backend == "mont32"
    return int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0


def _check_points(name: str, table: FArray, rs: FArray, k: int) -> None:
    if rs.field != table.field or rs.device != table.device:
        raise ValueError(f"{name}: the table and the points must be FArrays of one field on one device")
    if rs.data.dim() != 2 or rs.shape[1] != k or rs.shape[0] < 1:
        raise ValueError(f"{name} takes points as a [P, {k}] FArray, got {rs.shape}")


def fold(table: FArray, r: FArray, k: int) -> FArray:
    """The table (2^n words, internal MSB-first order) with its first k
    variables fixed at r[0..k-1] (``r``: k words): 2^(n-k) words, the value
    of k fold steps lo + r_j (hi - lo). One launch on the card; CPU tensors
    take :func:`fold_plain`."""
    n = table.shape[0].bit_length() - 1 if table.data.dim() == 1 else -1
    _check_table("fold", table, n)
    if r.shape != (k,) or not 1 <= k <= n:
        raise ValueError(f"fold of {k} variables of a {n}-variable table takes k words, got {r.shape}")
    _check_points("fold", table, r.reshape(1, k), k)
    if table.device.type == "cpu":
        return fold_plain(table, r, k)
    dev = table.device
    _check_cuda("fold", dev)
    pl = plan(n, k)
    m = 1 << (n - k)
    out = torch.empty(m, dtype=table.data.dtype, device=dev)
    partial = torch.empty((m << pl.s) if pl.s else 1, dtype=table.data.dtype, device=dev)
    tickets = _tickets_for(dev, pl.tiles) if pl.s else partial
    rw = r.data.contiguous()
    with torch.cuda.device(dev):
        rc = _kernels().ts_fold_launch(
            *_field_args(table.field), table.data.data_ptr(), rw.data_ptr(), k, n, pl.ct_log, pl.s, pl.c, pl.mb,
            out.data_ptr(), partial.data_ptr(), tickets.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fold kernel launch failed: CUDA error {rc}")
    fold_launches[table.field.backend] += 1
    return FArray(out, table.field)


def fold_plain(table: FArray, r: FArray, k: int) -> FArray:
    """:func:`fold` in plain torch ops (any device): k fold steps over the
    table's halves."""
    for j in range(k):
        half = table.shape[0] // 2
        table = FArray.fold(table[:half], table[half:], r[j])
    return table


# ---- the evaluation at many points ----


@dataclasses.dataclass(frozen=True)
class EvalPlan:
    """The evaluation's grid for a table of 2^n words at ``points`` points.
    ``tiny``: one thread per point (n <= ``TINY_LOG``), the other fields
    unused. Else the big form: 2^s row chunks (grid x) of 2^(n-s) rows and
    ``groups`` point groups (grid y) of ``pb`` points each (the points
    padded to groups x pb with copies of the last); a row of a chunk is (h,
    lane, v): ``lv`` bits v of a 16-byte load, ``c`` lane bits, ``hb`` bits
    h of a thread's loop."""

    tiny: bool
    groups: int
    pb: int
    s: int
    c: int
    hb: int
    lv: int


def eval_plan(n: int, points: int, backend: str) -> EvalPlan:
    """The evaluation's :class:`EvalPlan`: the tiny form up to 2^TINY_LOG
    words; else ceil(P / EVAL_POINTS) groups and 2^s chunks for at least
    ``EVAL_TARGET_BLOCKS`` blocks while every lane has a load, or more where
    a thread's (h, v) factors would outgrow 2^EVAL_MID_LOG per point."""
    if n < 1 or points < 1:
        raise ValueError(f"no evaluation plan for n = {n} at {points} points")
    if n <= TINY_LOG:
        return EvalPlan(True, 1, 1, 0, 0, 0, 0)
    lv = LOAD_LOG[backend]
    groups = -(-points // EVAL_POINTS)
    s_full = max(n - lv - LANE_LOG, 0)  # the most chunks with every lane loading
    s = 0
    while (groups << s) < EVAL_TARGET_BLOCKS and s < s_full:
        s += 1
    s = max(s, n - LANE_LOG - EVAL_MID_LOG)
    if s > _MAX_EVAL_S:
        raise ValueError(f"an evaluation over 2^{n} words needs 2^{s} row chunks (at most 2^{_MAX_EVAL_S})")
    c = min(LANE_LOG, n - s - lv)
    return EvalPlan(False, groups, -(-points // groups), s, c, n - s - lv - c, lv)


def eval_many(table: FArray, rs: FArray) -> FArray:
    """The table's MLE (2^n words, internal order, n >= 1) at P points
    (``rs``: [P, n] words): [P] values. One launch on the card
    (:func:`eval_plan`'s form); CPU tensors take :func:`eval_many_plain`."""
    n = table.shape[0].bit_length() - 1 if table.data.dim() == 1 else -1
    _check_table("eval_many", table, n)
    if n < 1:
        raise ValueError("eval_many takes a table of at least one variable")
    _check_points("eval_many", table, rs, n)
    if table.device.type == "cpu":
        return eval_many_plain(table, rs)
    dev, field = table.device, table.field
    _check_cuda("eval_many", dev)
    points = rs.shape[0]
    pl = eval_plan(n, points, field.backend)
    t = table.data if table.data.data_ptr() % 16 == 0 else table.data.clone()  # the big form's 16-byte loads
    padded = points if pl.tiny else pl.groups * pl.pb
    rw = rs.data.contiguous()
    if padded > points:
        rw = torch.cat([rw, rw[-1:].expand(padded - points, n)])
    out = torch.empty(padded, dtype=t.dtype, device=dev)
    partial = torch.empty((padded << pl.s) if pl.s else 1, dtype=t.dtype, device=dev)
    tickets = _tickets_for(dev, pl.groups) if pl.s else partial
    with torch.cuda.device(dev):
        rc = _kernels().ts_eval_launch(
            *_field_args(field), t.data_ptr(), rw.data_ptr(), padded, n, pl.groups, pl.pb, pl.s, pl.c,
            out.data_ptr(), partial.data_ptr(), tickets.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"evaluation kernel launch failed: CUDA error {rc}")
    eval_launches[field.backend] += 1
    return FArray(out[:points], field)


def eval_many_plain(table: FArray, rs: FArray) -> FArray:
    """:func:`eval_many` in plain torch ops (any device): one fold chain over
    a [P, 2^n] broadcast of the table."""
    t = table.reshape(1, -1)
    for j in range(rs.shape[1]):
        half = t.shape[1] // 2
        t = FArray.fold(t[:, :half], t[:, half:], rs[:, j : j + 1])
    return t.reshape(rs.shape[0])
