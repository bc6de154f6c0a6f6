"""The multi-block round kernel for Hopper and its plain torch version.

Counterpart of the XLA programs of ``thaler_study_tpu/ops/round_kernel.py``
that run every spec the Pallas kernel does not take: ``_fold_tables``
:110, ``_round_sums`` :218 with the broadcast branch of ``_term_total``
:165, and ``sum_products`` :407. The CUDA source is
``csrc/multiblock_round.cu``; its note says what the kernel computes, what
bounds it and how.

A round is described by a :class:`Plan` (:func:`round_plan`): the grid of
the spec's blocks after the fold, block 0 halved; each table's index
strides over that grid and whether the round folds it; the terms as
multiplicities of the tables. Two wrappers, each with a plain version that
CPU tensors take; CUDA tensors launch the kernel or raise:

- :func:`round_partials`: one round (the fold of every block-0 table at r,
  where one is due, and the per-block partials of s(0..D));
- :func:`fold_tables`: the flat fold of each table over its own entries,
  for rounds whose sums go elsewhere (the triangle contraction) and for
  ``fix_variables``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _build
from ..fields import FArray, FieldConfig
from ..fields.farray import word_dtype

THREADS = 256  # csrc/multiblock_round.cu THREADS
MAX_BLOCKS = 3
MAX_TABLES = 8  # csrc/multiblock_round.cu MAX_TABLES, MAX_TERMS, MAX_D
MAX_TERMS = 8
MAX_DEGREE = 8
_TARGET_BLOCKS = 2048  # blocks of one round: ~16 per SM
_FOLD_BLOCKS = 1024

# launches of the CUDA kernels (not of the plain versions), per instantiation
launches = {"goldilocks": 0, "mont32": 0}
fold_launches = {"goldilocks": 0, "mont32": 0}

_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("multiblock_round"), name)
        head = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint]
        ptr = ctypes.c_void_p
        if name == "ts_mb_round_launch":
            fn.argtypes = head + [ctypes.c_int] * 3 + [ptr] * 4 + [ctypes.c_int, ptr, ctypes.c_int] + [
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ptr, ptr, ctypes.c_int, ctypes.c_longlong, ptr
            ]
        else:
            fn.argtypes = head + [ctypes.c_int, ptr, ptr, ptr, ptr, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's view of one round (``csrc/multiblock_round.cu``).

    - ``log_sizes``: log2 of the three grid blocks' sizes after the fold
      (block 0 before halving; 0 for a block the spec does not have);
    - ``strides[k]``: table k's index stride per grid block, 0 where it does
      not cover the block; ``sizes[k]``: its entries after the fold;
    - ``folded[k]``: the round folds table k (it had block 0 before);
    - ``counts[j][k]``: how often table k is a factor of term j;
    - ``degree``: the round sums are s(0..degree).
    """

    log_sizes: Tuple[int, int, int]
    strides: Tuple[Tuple[int, int, int], ...]
    sizes: Tuple[int, ...]
    folded: Tuple[bool, ...]
    counts: Tuple[Tuple[int, ...], ...]
    degree: int

    @property
    def half0(self) -> int:
        return 1 << (self.log_sizes[0] - 1)

    @property
    def grid(self) -> int:
        return self.half0 << (self.log_sizes[1] + self.log_sizes[2])


def round_plan(spec, fold: bool, terms: Sequence[Sequence[int]], degree: int) -> Plan:
    """The plan of a round over ``spec`` (a ``round_kernel.PolySpec``; the
    spec before the fold when ``fold``) summing ``terms`` at t = 0..degree."""
    post = spec.after_fold() if fold else spec
    if not post.block_sizes or post.block_sizes[0] < 1:
        raise ValueError("a round needs a variable of block 0 left after the fold")
    if len(post.block_sizes) > MAX_BLOCKS:
        raise NotImplementedError(
            f"the multi-block round kernel takes up to {MAX_BLOCKS} blocks, not {len(post.block_sizes)} "
            "(wider specs, like sharded inputs, are ROADMAP A7)"
        )
    k = len(spec.table_blocks)
    if k > MAX_TABLES or len(terms) > MAX_TERMS or not 0 <= degree <= MAX_DEGREE or not terms:
        raise NotImplementedError(
            f"the multi-block round kernel takes up to {MAX_TABLES} tables, 1 to {MAX_TERMS} terms and "
            f"degree <= {MAX_DEGREE}; got {k} tables, {len(terms)} terms, degree {degree}"
        )
    counts = tuple(tuple(list(term).count(i) for i in range(k)) for term in terms)
    if max(max(c) for c in counts) > 15:
        raise NotImplementedError("the multi-block round kernel takes a table at most 15 times in one term")
    logs = tuple(post.block_sizes) + (0,) * (MAX_BLOCKS - len(post.block_sizes))
    strides, sizes = [], []
    for tb in post.table_blocks:
        st, size = [0, 0, 0], 1
        for b in reversed(tb):
            st[b] = size
            size <<= post.block_sizes[b]
        strides.append(tuple(st))
        sizes.append(size)
    return Plan(
        log_sizes=logs,
        strides=tuple(strides),
        sizes=tuple(sizes),
        folded=tuple(fold and 0 in tb for tb in spec.table_blocks),
        counts=counts,
        degree=degree,
    )


def blocks_for(grid: int) -> int:
    """Blocks of one round: enough to fill the card, no more than one block
    per THREADS grid points."""
    return max(1, min(-(-grid // THREADS), _TARGET_BLOCKS))


def _check_tables(tables, shapes, dtype, what: str) -> torch.device:
    if not tables:
        raise ValueError(f"{what} needs at least one table")
    dev = tables[0].device
    for t, shape in zip(tables, shapes):
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{what}: tables must be {dtype} tensors of shapes {shapes} on one device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tables must be contiguous")
    return dev


def _check_r(r, dtype, dev) -> None:
    if r is None or r.dtype != dtype or tuple(r.shape) != (1,) or r.device != dev or not r.is_contiguous():
        raise ValueError(f"r must be a contiguous {dtype} [1] tensor on {dev}")


def _head(field: FieldConfig):
    mont32 = field.backend == "mont32"
    return int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0


def _ptrs(xs) -> ctypes.Array:
    return (ctypes.c_void_p * len(xs))(*[None if x is None else x.data_ptr() for x in xs])


def round_partials(
    plan: Plan,
    tables: Sequence[torch.Tensor],
    r: Optional[torch.Tensor],
    skip_t1: bool,
    field: FieldConfig,
) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
    """One round of ``plan``: ``tables`` are 1-D tensors of ``field``'s
    words (MSB-first), before the fold where ``r`` (a [1] challenge) is
    given. Returns (the folded tables, None where the round does not fold
    one; partials [blocks, degree + 1]); s(1) is 0 with ``skip_t1`` (the
    caller fills claim - s(0)). The input tables are never written."""
    fold = r is not None
    dtype = word_dtype(field)
    if len(tables) != len(plan.sizes):
        raise ValueError(f"the plan has {len(plan.sizes)} tables, got {len(tables)}")
    shapes = [(2 * s if fold and f else s,) for s, f in zip(plan.sizes, plan.folded)]
    dev = _check_tables(tables, shapes, dtype, "round_partials")
    if fold:
        _check_r(r, dtype, dev)
    blocks = blocks_for(plan.grid)
    if dev.type == "cpu":
        return round_partials_plain(plan, tables, r, skip_t1, blocks, field)
    if dev.type != "cuda":
        raise ValueError(f"round_partials runs on cpu or cuda, not {dev}")
    out = [torch.empty((s,), dtype=dtype, device=dev) if fold and f else None
           for s, f in zip(plan.sizes, plan.folded)]
    partials = torch.empty((blocks, plan.degree + 1), dtype=dtype, device=dev)
    k = len(tables)
    strides = (ctypes.c_longlong * (3 * k))(*[s for st in plan.strides for s in st])
    halves = (ctypes.c_longlong * k)(*[s if fold and f else 0 for s, f in zip(plan.sizes, plan.folded)])
    counts = (ctypes.c_ubyte * (len(plan.counts) * k))(*[c for row in plan.counts for c in row])
    chunk = -(-plan.grid // blocks)
    rc = _kernel("ts_mb_round_launch")(
        *_head(field), int(fold), int(skip_t1), k, _ptrs(tables), _ptrs(out), strides, halves,
        len(plan.counts), counts, plan.degree, plan.log_sizes[1], plan.log_sizes[2], plan.half0,
        r.data_ptr() if fold else None, partials.data_ptr(), blocks, chunk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"multi-block round kernel launch failed: CUDA error {rc}")
    launches[field.backend] += 1
    return out, partials


def _grid_view(plan: Plan, k: int, table: FArray) -> Tuple[FArray, FArray]:
    """(lo, hi - lo) of table k on the halved grid, broadcastable to
    [half0, S1, S2]; hi - lo is 0 for a table that misses block 0."""
    dims = [1 << l if s else 1 for l, s in zip(plan.log_sizes, plan.strides[k])]
    t = table.reshape(*dims)
    if not plan.strides[k][0]:
        return t, FArray(torch.zeros_like(t.data), t.field)
    h = dims[0] // 2
    return t[:h], t[h:] - t[:h]


def round_partials_plain(
    plan: Plan,
    tables: Sequence[torch.Tensor],
    r: Optional[torch.Tensor],
    skip_t1: bool,
    blocks: int,
    field: FieldConfig,
) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
    """The kernel's function in plain torch ops (``FArray`` arithmetic, any
    device): the same folded tables and the same per-block partials (block
    x sums the grid points [x * chunk, (x + 1) * chunk), MSB-first)."""
    post, folded = [], []
    for t, size, f in zip(tables, plan.sizes, plan.folded):
        fa = FArray(t, field)
        if r is not None and f:
            fa = FArray.fold(fa[:size], fa[size:], FArray(r.reshape(()), field))
            folded.append(fa.data)
        else:
            folded.append(None)
        post.append(fa)
    views = [_grid_view(plan, k, t) for k, t in enumerate(post)]
    shape = (plan.half0, 1 << plan.log_sizes[1], 1 << plan.log_sizes[2])
    chunk = -(-plan.grid // blocks)
    pad = blocks * chunk - plan.grid
    cols = []
    v = [lo for lo, _ in views]
    for t in range(plan.degree + 1):
        if t:
            v = [x + d for x, (_, d) in zip(v, views)]
        if t == 1 and skip_t1:
            cols.append(torch.zeros(blocks, dtype=word_dtype(field), device=tables[0].device))
            continue
        total = None
        for counts in plan.counts:
            prod = None
            for k, c in enumerate(counts):
                for _ in range(c):
                    prod = v[k] if prod is None else prod * v[k]
            prod = FArray(prod.data.expand(shape), field)
            total = prod if total is None else total + prod
        flat = torch.nn.functional.pad(total.data.reshape(-1), (0, pad))
        cols.append(FArray(flat.reshape(blocks, chunk), field).sum(axis=1).data)
    return folded, torch.stack(cols, dim=1)


def fold_tables(
    tables: Sequence[torch.Tensor], halves: Sequence[int], r: torch.Tensor, field: FieldConfig
) -> List[torch.Tensor]:
    """Fold table k at ``r`` over its own entries, T'[j] = T[j] + r (T[j +
    h] - T[j]) for j < h = halves[k] (its first variable, the MSB), where
    halves[k] > 0; the others are returned as they are. The input tables
    are never written."""
    dtype = word_dtype(field)
    if len(tables) != len(halves) or len(tables) > MAX_TABLES:
        raise ValueError(f"fold_tables takes up to {MAX_TABLES} tables and one half per table")
    shapes = [(2 * h,) if h else tuple(t.shape) for t, h in zip(tables, halves)]
    dev = _check_tables(tables, shapes, dtype, "fold_tables")
    _check_r(r, dtype, dev)
    if dev.type == "cpu":
        return fold_tables_plain(tables, halves, r, field)
    if dev.type != "cuda":
        raise ValueError(f"fold_tables runs on cpu or cuda, not {dev}")
    out = [torch.empty((h,), dtype=dtype, device=dev) if h else None for h in halves]
    if any(halves):
        blocks = max(1, min(-(-max(halves) // THREADS), _FOLD_BLOCKS))
        rc = _kernel("ts_mb_fold_launch")(
            *_head(field), len(tables), _ptrs(tables), _ptrs(out),
            (ctypes.c_longlong * len(halves))(*halves), r.data_ptr(), blocks,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"multi-block fold kernel launch failed: CUDA error {rc}")
        fold_launches[field.backend] += 1
    return [o if h else t for t, o, h in zip(tables, out, halves)]


def fold_tables_plain(
    tables: Sequence[torch.Tensor], halves: Sequence[int], r: torch.Tensor, field: FieldConfig
) -> List[torch.Tensor]:
    """:func:`fold_tables` in plain torch ops (any device)."""
    rr = FArray(r.reshape(()), field)
    return [FArray.fold(FArray(t[:h], field), FArray(t[h:], field), rr).data if h else t
            for t, h in zip(tables, halves)]
