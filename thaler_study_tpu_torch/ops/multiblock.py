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
multiplicities of the tables. :func:`split` reads the grid as rows times
the inner (last) block and the tables as row and inner tables, and
:func:`layout` cuts it into the kernel's tiles. Two wrappers, each with a
plain version that CPU tensors take; CUDA tensors launch the kernel or
raise:

- :func:`round_sums`: one round (the fold of every block-0 table at r,
  where one is due, and s(0..D) as a [D + 1] tensor; with the claim
  shortcut s(1) = claim - s(0), in the same launch);
- :func:`fold_tables`: the flat fold of each table over its own entries,
  for rounds whose sums go elsewhere (the triangle contraction) and for
  ``fix_variables``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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
# the tile layout: the most inner points of one tile and row; the most
# points per thread and tile (each row a thread takes ends in one reduction
# and product per term and t), and per thread of a grid that one tile takes
# whole; the tiles a grid is cut into where it is large enough (two per
# SM); the dynamic shared memory a block may use for its row values, row
# products and staged spans (48 KB less the kernel's static arrays), and
# with the pipeline of the per-point loads (two blocks per SM)
SPAN_MAX = 4096
POINTS_PER_THREAD = 64
ONE_TILE_POINTS = 16
MIN_TILES = 264
SMEM_BYTES = 46 * 1024
PIPE_BYTES = 96 * 1024
MAX_GRID = 2048  # the most blocks of one round (the partials' rows)
# the (terms, degree, inner tables) the kernel is templated on (each term
# at most two inner factors): the triangle's c_1 and rounds, the LibraW c_1,
# dense W's c_1 and rounds; every other spec runs the generic instantiation
FAST = frozenset({(1, 1, 2), (1, 2, 2), (2, 1, 3), (3, 1, 3), (3, 2, 3)})
_FOLD_BLOCKS = 1024
_LIMIT = 1 << 31  # 32-bit index arithmetic in the kernel

# launches of the CUDA kernels (not of the plain versions), per instantiation
launches = {"goldilocks": 0, "mont32": 0}
fold_launches = {"goldilocks": 0, "mont32": 0}

_fns = {}


class _Args(ctypes.Structure):
    """csrc/multiblock_round.cu ``Args``, field for field."""

    _fields_ = [
        ("in_", ctypes.c_ulonglong * MAX_TABLES),
        ("out", ctypes.c_ulonglong * MAX_TABLES),
        ("r", ctypes.c_ulonglong),
        ("claim", ctypes.c_ulonglong),
        ("sums", ctypes.c_ulonglong),
        ("partials", ctypes.c_ulonglong),
        ("counter", ctypes.c_ulonglong),
        ("ra", ctypes.c_int * MAX_TABLES),
        ("rb", ctypes.c_int * MAX_TABLES),
        ("hi", ctypes.c_int * MAX_TABLES),
        ("fold", ctypes.c_int * MAX_TABLES),
        ("miss", ctypes.c_int * MAX_TABLES),
        ("stage", ctypes.c_int * MAX_TABLES),
        ("icount", ctypes.c_uint * MAX_TERMS),
        ("rcount", ctypes.c_uint * MAX_TERMS),
        ("nf", ctypes.c_int * MAX_TERMS),
        ("f0", ctypes.c_int * MAX_TERMS),
        ("f1", ctypes.c_int * MAX_TERMS),
        ("tmode", ctypes.c_int * MAX_TERMS),
        ("tvals", ctypes.c_int),
    ] + [(name, ctypes.c_int) for name in (
        "ntables", "ni", "nterms", "degree", "skip1", "vec", "rl1", "span", "spans", "rt", "tpr", "rpi",
        "ntiles", "max_blocks", "rp", "nstaged", "stage_a")] + [
        ("pslot", ctypes.c_int * MAX_TABLES), ("pipe_k", ctypes.c_int), ("pipe_stages", ctypes.c_int),
        ("pipe_off", ctypes.c_int), ("scaled", ctypes.c_int), ("scale", ctypes.c_ulonglong)]


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load("multiblock_round")
        fn = getattr(lib, name)
        head = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint]
        ptr = ctypes.c_void_p
        if name == "ts_mb_round_launch":
            if lib.ts_mb_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(f"multiblock_round.cu Args has {lib.ts_mb_args_size()} bytes, the wrapper's "
                                   f"mirror {ctypes.sizeof(_Args)}")
            fn.argtypes = head + [ctypes.POINTER(_Args), ctypes.c_int, ptr]
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
            f"the multi-block round kernel takes up to {MAX_BLOCKS} blocks, not {len(post.block_sizes)}"
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


@dataclasses.dataclass(frozen=True)
class Split:
    """How the kernel reads a plan's grid and tables.

    - ``rows`` x ``inner``: the grid as rows (every grid block but the last
      non-empty one, ``last``) times the inner block; row r has the row
      coordinates a = r >> rl1 and b = r & (2^rl1 - 1) (a = i0 and b = i1
      for three blocks, a = i0 for two, none for one, whose inner block is
      block 0 itself);
    - ``order``: the plan's table ids in kernel order, the ``ni`` inner
      tables (they cover the inner block, at stride 1) then the row tables;
    - per table in kernel order: ``ra`` / ``rb`` its index strides of a and
      b, ``hi`` the offset of its upper block-0 half (0: misses block 0),
      ``fold`` its fold half (0: not folded), ``miss`` bit 0 / 1 where it
      misses a / b (its folded entries are written where those are 0),
      ``staged``: an inner table the round folds that misses a row
      coordinate, folded once per block into shared memory;
    - per term: ``icount`` / ``rcount``, its factor counts over the inner /
      row tables; ``nf``, ``f0``, ``f1``: its inner factors (positions in
      kernel order; nf = -1 beyond two); ``tmode``: how its inner product
      varies with t (0 not at all; 1 / 2 linearly, with factor f0 / f1: the
      kernel sums the value at t = 0 and the slope; 3 both factors: the
      values at t = 0..D).
    """

    last: int
    rows: int
    inner: int
    rl1: int
    order: Tuple[int, ...]
    ni: int
    ra: Tuple[int, ...]
    rb: Tuple[int, ...]
    hi: Tuple[int, ...]
    fold: Tuple[int, ...]
    miss: Tuple[int, ...]
    staged: Tuple[bool, ...]
    icount: Tuple[Tuple[int, ...], ...]
    rcount: Tuple[Tuple[int, ...], ...]
    nf: Tuple[int, ...]
    f0: Tuple[int, ...]
    f1: Tuple[int, ...]
    tmode: Tuple[int, ...]
    degree: int

    @property
    def fast(self) -> bool:
        """The kernel runs a templated instantiation (else the generic)."""
        return min(self.nf) >= 0 and (len(self.nf), self.degree, self.ni) in FAST


@functools.lru_cache(maxsize=None)
def split(plan: Plan) -> Split:
    """The kernel's split of ``plan`` (see :class:`Split`)."""
    logs = plan.log_sizes
    last = max([b for b in (1, 2) if logs[b] > 0], default=0)
    half0 = plan.half0
    if last == 0:
        rows, inner, rl1 = 1, half0, 0
    elif last == 1:
        rows, inner, rl1 = half0, 1 << logs[1], 0
    else:
        rows, inner, rl1 = half0 << logs[1], 1 << logs[2], logs[1]
    cover_inner = [st[last] != 0 for st in plan.strides]
    order = tuple([k for k, c in enumerate(cover_inner) if c] + [k for k, c in enumerate(cover_inner) if not c])
    ni = sum(cover_inner)
    ra, rb, hi, fold, miss, staged = [], [], [], [], [], []
    for k in order:
        s0, s1, _ = plan.strides[k]
        a_s = s0 if last >= 1 else 0
        b_s = s1 if last == 2 else 0
        m = (int(last >= 1 and not s0)) | (int(last == 2 and not s1) << 1)
        h = plan.sizes[k] if plan.folded[k] else 0
        ra.append(a_s)
        rb.append(b_s)
        hi.append(half0 * s0 if s0 else 0)
        fold.append(h)
        miss.append(m)
        staged.append(bool(cover_inner[k] and h and (m & 2 if last == 2 else m & 1)))
    icount, rcount, nf, f0, f1, tmode = [], [], [], [], [], []
    for counts in plan.counts:
        ic = tuple(counts[k] for k in order[:ni])
        icount.append(ic)
        rcount.append(tuple(counts[k] for k in order[ni:]))
        factors = [i for i, c in enumerate(ic) for _ in range(c)]
        nf.append(len(factors) if len(factors) <= 2 else -1)
        f0.append(factors[0] if 1 <= len(factors) <= 2 else 0)
        f1.append(factors[1] if len(factors) == 2 else 0)
        varies = [bool(hi[i]) for i in factors]
        tmode.append(3 if len(factors) > 2 or sum(varies) == 2 else 1 if varies[:1] == [True] else
                     2 if varies[1:] == [True] else 0)
    return Split(last, rows, inner, rl1, order, ni, tuple(ra), tuple(rb), tuple(hi), tuple(fold), tuple(miss),
                 tuple(staged), tuple(icount), tuple(rcount), tuple(nf), tuple(f0), tuple(f1), tuple(tmode),
                 plan.degree)


@dataclasses.dataclass(frozen=True)
class Layout:
    """The kernel's tiles: a tile is ``rt`` rows x ``span`` inner points
    (``spans`` = inner / span per row tile; tile x is row tile x // spans,
    span x % spans); a block's threads stand ``tpr`` along a row, ``rpi``
    rows at once, each taking two neighbouring points per step; the blocks
    (as many as fit on the card, at most MAX_GRID) walk contiguous ranges
    of the ``tiles``. Shared memory, in
    words: row values from 0 (2 per row and row table), row products
    at ``rp`` (one per row, term and t), each staged table's span at
    ``stage`` (lo, then hi - lo where it covers block 0; -1: per point),
    and the pipeline at ``pipe_off``: ``pipe_stages`` stages (2, or 0:
    none) of ``pipe_k`` slots of a word pair per thread, an inner table
    read per point taking slots from ``pslot`` on (lo, then hi, then the
    halves they fold with, as it has them)."""

    span: int
    spans: int
    rt: int
    tpr: int
    rpi: int
    tiles: int
    rp: int
    stage: Tuple[int, ...]
    pslot: Tuple[int, ...]
    pipe_k: int
    pipe_stages: int
    pipe_off: int
    words: int


@functools.lru_cache(maxsize=None)
def layout(plan: Plan, word_bytes: int, span_max: int = SPAN_MAX) -> Layout:
    """The tiles of ``plan`` for words of ``word_bytes`` (8 Goldilocks, 4
    mont32). A tile takes 2 to POINTS_PER_THREAD points per thread, as
    many as leave MIN_TILES tiles (a small grid: one tile); a span is as
    long as that allows (up to ``span_max`` inner points), the tile as many
    rows deep as the rest; the threads stand on up to rpi = rt rows at once
    and along a row up to one pair of points each; all within SMEM_BYTES,
    and the pipeline within PIPE_BYTES. A tile's rows share the row
    coordinate a (so that a staged table's entries are the same for all of
    them)."""
    sp = split(plan)
    rows, inner = sp.rows, sp.inner
    nrow = len(sp.order) - sp.ni
    per_row = 2 * nrow + len(plan.counts) * (plan.degree + 1)
    staged_w = sum((2 if h else 1) for h, s in zip(sp.hi, sp.staged) if s)
    budget = SMEM_BYTES // word_bytes - 16  # room to align the areas to two words
    rcap = min(rows, 1 << sp.rl1) if sp.last == 2 else rows

    def fits(ls, rt):
        return staged_w * ls + rt * per_row <= budget

    ppt = 2
    while ppt < POINTS_PER_THREAD and rows * inner >= 2 * ppt * THREADS * MIN_TILES:
        ppt *= 2
    if rows * inner <= ONE_TILE_POINTS * THREADS:  # a small grid: one block, no ticket
        ppt = max(ppt, rows * inner // THREADS)
    ls = min(inner, span_max, ppt * THREADS)
    while ls > 1 and not fits(ls, 1):
        ls //= 2
    rt = max(1, min(ppt * THREADS // ls, rcap))
    while rt > 1 and not fits(ls, rt):
        rt //= 2
    rpi = min(rt, THREADS)
    tpr = min(THREADS // rpi, max(1, ls // 2))

    def even(x):
        return x + (x & 1)

    rp = even(2 * rt * nrow)
    at = even(rp + rt * len(plan.counts) * (plan.degree + 1))
    stage = []
    for h, s in zip(sp.hi, sp.staged):
        if s:
            stage.append(at)
            at = even(at + (2 if h else 1) * ls)
        else:
            stage.append(-1)
    # the pipeline (two stages, where they fit): the inner tables streamed
    # once (they miss no row coordinate; the others are re-read from L2)
    pslot, k = [], 0
    for i, (h, f, s, m) in enumerate(zip(sp.hi, sp.fold, sp.staged, sp.miss)):
        pslot.append(k if i < sp.ni and not s and not m else -1)
        k += (2 if h else 1) * (2 if f else 1) if pslot[-1] >= 0 else 0
    pair = THREADS * 2  # words of one slot
    stages = 2 if k and sp.fast and at + 2 * k * pair <= PIPE_BYTES // word_bytes else 0
    spans = inner // ls
    return Layout(span=ls, spans=spans, rt=rt, tpr=tpr, rpi=rpi, tiles=spans * (rows // rt), rp=rp,
                  stage=tuple(stage), pslot=tuple(pslot), pipe_k=k, pipe_stages=stages, pipe_off=at,
                  words=at + stages * k * pair)


def kernel_class(plan: Plan) -> str:
    """The instantiation a round of ``plan`` launches: (terms, degree,
    inner tables), or ``generic``."""
    sp = split(plan)
    return f"({len(plan.counts)}, {plan.degree}, {sp.ni})" if sp.fast else "generic"


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


def _check_r(r, dtype, dev, what: str = "r") -> None:
    if r is None or r.dtype != dtype or tuple(r.shape) != (1,) or r.device != dev or not r.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} [1] tensor on {dev}")


def _head(field: FieldConfig):
    mont32 = field.backend == "mont32"
    return int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0


def _word(field: FieldConfig, v: int) -> int:
    """The integer v as a word of ``field`` (mont32: its Montgomery word)."""
    v %= field.p
    return v * field.mont_r % field.p if field.backend == "mont32" else v


def _ptrs(xs) -> ctypes.Array:
    return (ctypes.c_void_p * len(xs))(*[None if x is None else x.data_ptr() for x in xs])


@functools.lru_cache(maxsize=None)
def _template(plan: Plan, word_bytes: int) -> bytes:
    """The launch's ``Args`` without its pointers and per-call flags."""
    sp, lay = split(plan), layout(plan, word_bytes)
    a = _Args()
    for i in range(len(sp.order)):
        a.ra[i], a.rb[i], a.hi[i], a.fold[i], a.miss[i] = sp.ra[i], sp.rb[i], sp.hi[i], sp.fold[i], sp.miss[i]
        a.stage[i] = lay.stage[i]
    for j in range(len(plan.counts)):
        a.icount[j] = sum(c << (4 * i) for i, c in enumerate(sp.icount[j]))
        a.rcount[j] = sum(c << (4 * q) for q, c in enumerate(sp.rcount[j]))
        a.nf[j], a.f0[j], a.f1[j], a.tmode[j] = sp.nf[j], sp.f0[j], sp.f1[j], sp.tmode[j]
    a.tvals = int(3 in sp.tmode)
    a.ntables, a.ni, a.nterms, a.degree = len(sp.order), sp.ni, len(plan.counts), plan.degree
    a.rl1, a.span, a.spans, a.rt, a.tpr, a.rpi = sp.rl1, lay.span, lay.spans, lay.rt, lay.tpr, lay.rpi
    a.ntiles, a.max_blocks, a.rp = lay.tiles, min(lay.tiles, MAX_GRID), lay.rp
    for i, q in enumerate(lay.pslot):
        a.pslot[i] = q
    a.pipe_k, a.pipe_stages, a.pipe_off = lay.pipe_k, lay.pipe_stages, lay.pipe_off
    a.nstaged = sum(sp.staged)
    a.stage_a = int(any(s and not m & 1 for s, m in zip(sp.staged, sp.miss)))
    return bytes(a)


def round_sums(
    plan: Plan,
    tables: Sequence[torch.Tensor],
    r: Optional[torch.Tensor],
    field: FieldConfig,
    skip_t1: bool = False,
    claim: Optional[torch.Tensor] = None,
    out: Optional[Sequence[Optional[torch.Tensor]]] = None,
    sums: Optional[torch.Tensor] = None,
    scale: Optional[int] = None,
) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
    """One round of ``plan``: ``tables`` are 1-D tensors of ``field``'s
    words (MSB-first), before the fold where ``r`` (a [1] challenge) is
    given and the plan folds them (``plan.folded``; a table over block 0
    that it does not fold is given as the round reads it). Returns (the
    folded tables, None where the round does not fold one; s(0..degree), a
    [degree + 1] tensor). With ``skip_t1`` the t = 1 products are left out
    and s(1) is ``claim`` - s(0) (``claim`` a [1] word), or 0 without a
    claim (the caller fills it: the sharded rounds sum the shards' s(0)
    first). ``out``: the folded tables' buffers, None elsewhere (allocated
    when None). ``sums``: a contiguous [degree + 1] buffer for s (a row
    of the sharded round's rows; allocated when None). ``scale``: s is
    written times this integer (the sharded rounds' replicated-only
    terms, times their 2^n_shard shard rows). The input tables are never
    written."""
    fold = r is not None
    dtype = word_dtype(field)
    if len(tables) != len(plan.sizes):
        raise ValueError(f"the plan has {len(plan.sizes)} tables, got {len(tables)}")
    if skip_t1 and plan.degree < 1 or claim is not None and not skip_t1:
        raise ValueError("the claim shortcut needs skip_t1 and a round of degree >= 1")
    shapes = [(2 * s if fold and f else s,) for s, f in zip(plan.sizes, plan.folded)]
    dev = _check_tables(tables, shapes, dtype, "round_sums")
    if fold:
        _check_r(r, dtype, dev)
    if claim is not None:
        _check_r(claim, dtype, dev, "claim")
    out = _check_out(out, [(s,) if fold and f else None for s, f in zip(plan.sizes, plan.folded)], dtype, dev)
    if sums is not None and (sums.dtype != dtype or sums.device != dev or tuple(sums.shape) != (plan.degree + 1,)
                             or not sums.is_contiguous()):
        raise ValueError(f"sums must be a contiguous {dtype} [{plan.degree + 1}] tensor on {dev}")
    sp = split(plan)
    if max(s[0] for s in shapes) >= _LIMIT or sp.rows >= _LIMIT or sp.inner >= _LIMIT:
        raise ValueError("the multi-block round kernel takes tables, rows and rows' lengths below 2^31 entries")
    if dev.type == "cpu":
        folded, s = round_sums_plain(plan, tables, r, field, skip_t1, claim, scale)
        if sums is not None:
            sums.copy_(s)
            s = sums
        return _copy_out(folded, out), s
    if dev.type != "cuda":
        raise ValueError(f"round_sums runs on cpu or cuda, not {dev}")
    wb = tables[0].element_size()
    lay = layout(plan, wb)
    if out is None:
        out = [torch.empty((s,), dtype=dtype, device=dev) if fold and f else None
               for s, f in zip(plan.sizes, plan.folded)]
    if sums is None:
        sums = torch.empty((plan.degree + 1,), dtype=dtype, device=dev)
    partials = torch.empty((min(lay.tiles, MAX_GRID) * (plan.degree + 1),), dtype=dtype, device=dev)
    a = _Args.from_buffer_copy(_template(plan, wb))
    for i, k in enumerate(sp.order):
        a.in_[i] = tables[k].data_ptr()
        a.out[i] = out[k].data_ptr() if out[k] is not None else 0
    a.r = r.data_ptr() if fold else 0
    a.claim = claim.data_ptr() if claim is not None else 0
    a.sums, a.partials, a.counter = sums.data_ptr(), partials.data_ptr(), _build.ticket_counter(dev).data_ptr()
    a.skip1 = int(skip_t1)
    if scale is not None:
        a.scaled, a.scale = 1, _word(field, scale)
    a.vec = int(lay.span % 2 == 0 and all(x % (2 * wb) == 0 for x in list(a.in_)[:sp.ni] + list(a.out)[:sp.ni]))
    with torch.cuda.device(dev):
        rc = _kernel("ts_mb_round_launch")(*_head(field), ctypes.byref(a), lay.words * wb,
                                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"multi-block round kernel launch failed: CUDA error {rc}")
    launches[field.backend] += 1
    return out, sums


def _check_out(out, shapes, dtype, dev):
    """``out`` (None, or a buffer where ``shapes`` has a shape and None
    elsewhere) checked against the outputs' shapes."""
    if out is None:
        return None
    if len(out) != len(shapes) or any((o is None) != (s is None) for o, s in zip(out, shapes)):
        raise ValueError("out must hold a buffer for each folded table and None elsewhere")
    for o, shape in zip(out, shapes):
        if o is not None and (o.dtype != dtype or o.device != dev or tuple(o.shape) != shape or not o.is_contiguous()):
            raise ValueError(f"out buffers must be contiguous {dtype} tensors of shapes {shapes} on {dev}")
    return list(out)


def _copy_out(folded, out):
    """The plain versions' folded tables, written into ``out`` where given."""
    if out is None:
        return folded
    for o, f in zip(out, folded):
        if o is not None:
            o.copy_(f)
    return [o if o is not None else f for o, f in zip(out, folded)]


def _grid_view(plan: Plan, k: int, table: FArray) -> Tuple[FArray, FArray]:
    """(lo, hi - lo) of table k on the halved grid, broadcastable to
    [half0, S1, S2]; hi - lo is 0 for a table that misses block 0."""
    dims = [1 << l if s else 1 for l, s in zip(plan.log_sizes, plan.strides[k])]
    t = table.reshape(*dims)
    if not plan.strides[k][0]:
        return t, FArray(torch.zeros_like(t.data), t.field)
    h = dims[0] // 2
    return t[:h], t[h:] - t[:h]


def round_sums_plain(
    plan: Plan,
    tables: Sequence[torch.Tensor],
    r: Optional[torch.Tensor],
    field: FieldConfig,
    skip_t1: bool = False,
    claim: Optional[torch.Tensor] = None,
    scale: Optional[int] = None,
) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
    """The kernel's function in plain torch ops (``FArray`` arithmetic, any
    device): the same folded tables and the same s(0..degree)."""
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
    sums = []
    v = [lo for lo, _ in views]
    for t in range(plan.degree + 1):
        if t:
            v = [x + d for x, (_, d) in zip(v, views)]
        if t == 1 and skip_t1:
            sums.append(None)
            continue
        total = None
        for counts in plan.counts:
            prod = None
            for k, c in enumerate(counts):
                for _ in range(c):
                    prod = v[k] if prod is None else prod * v[k]
            prod = FArray(prod.data.expand(shape), field)
            total = prod if total is None else total + prod
        total = FArray(total.data.reshape(-1), field).sum(axis=0)
        if scale is not None:
            total = total * FArray.scalar(field.felt(scale), device=total.data.device)
        sums.append(total.data)
    if skip_t1:
        s0 = FArray(sums[0], field)
        sums[1] = (FArray(claim.reshape(()), field) - s0).data if claim is not None else torch.zeros_like(s0.data)
    return folded, torch.stack(sums)


def fold_tables(
    tables: Sequence[torch.Tensor], halves: Sequence[int], r: torch.Tensor, field: FieldConfig,
    out: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> List[torch.Tensor]:
    """Fold table k at ``r`` over its own entries, T'[j] = T[j] + r (T[j +
    h] - T[j]) for j < h = halves[k] (its first variable, the MSB), where
    halves[k] > 0; the others are returned as they are. ``out``: buffers
    [h] for the folded tables, None elsewhere (allocated when None). The
    input tables are never written."""
    dtype = word_dtype(field)
    if len(tables) != len(halves) or len(tables) > MAX_TABLES:
        raise ValueError(f"fold_tables takes up to {MAX_TABLES} tables and one half per table")
    shapes = [(2 * h,) if h else tuple(t.shape) for t, h in zip(tables, halves)]
    dev = _check_tables(tables, shapes, dtype, "fold_tables")
    _check_r(r, dtype, dev)
    out = _check_out(out, [(h,) if h else None for h in halves], dtype, dev)
    if dev.type == "cpu":
        return _copy_out(fold_tables_plain(tables, halves, r, field), out)
    if dev.type != "cuda":
        raise ValueError(f"fold_tables runs on cpu or cuda, not {dev}")
    if out is None:
        out = [torch.empty((h,), dtype=dtype, device=dev) if h else None for h in halves]
    if any(halves):
        blocks = max(1, min(-(-max(halves) // THREADS), _FOLD_BLOCKS))
        with torch.cuda.device(dev):
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
