"""The fused round kernel for Hopper and its plain torch version.

Counterpart of ``thaler_study_tpu/ops/pallas_round.py`` (the Pallas kernel
``_make_kernel``, entered through ``pallas_round_step``): one pass over a
batch of single-block tables that folds the previous challenge and
computes the round sums. The CUDA source is ``csrc/round_kernel.cu``; its
note says what bounds it and how.

The kernel takes three shapes of polynomial (``terms`` over the folded
tables, then the per-proof scalars):

- the product of all k = 2 or 3 tables (``terms=None``): the batched FS
  prover and the matmul IP;
- :data:`LIBRA_PHASE1`, W A1 + A2, and :data:`LIBRA_PHASE2`,
  B1 w_u + B1 Wc + B2 w_u Wc with the scalar w_u: the two phases of the GKR
  layer sumcheck (``gkr/linear.py``).

:func:`round_partials` is the wrapper. CPU tensors go to
:func:`round_partials_plain`, which takes any terms; CUDA tensors go to the
kernel or raise. Both return the same per-block partial sums, so the two
can be compared bit for bit; callers sum the partials mod p
(``round_kernel.round_step`` or the FS tail kernel). The other
single-block shapes (k = 1, k >= 4, other scalar terms) go to the
multi-block kernel (``ops/multiblock.py``): :func:`takes` tells them
apart.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _build
from ..fields import GOLDILOCKS, FArray, FieldConfig
from ..fields.farray import word_dtype

THREADS = 256  # csrc/round_kernel.cu THREADS
_TARGET_BLOCKS = 2048  # blocks in flight over the whole batch: ~16 per SM

# the LibraW shapes: table ids 0-2 are folded tables, 3 the phase-2 scalar
LIBRA_PHASE1 = ((0, 1), (2,))
LIBRA_PHASE2 = ((0, 3), (0, 2), (1, 3, 2))
_LIBRA = {LIBRA_PHASE1: (1, 0), LIBRA_PHASE2: (2, 1)}  # terms -> (phase, scalars)

# launches of the CUDA kernels (not of the plain version), per instantiation
launches = {"goldilocks": 0, "mont32": 0}
libra_launches = {"goldilocks": 0, "mont32": 0}

_fns = {}


def _kernel(name: str = "ts_round_launch"):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("round_kernel"), name)
        scalar = [ctypes.c_void_p] if name == "ts_libra_round_launch" else []
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_uint, ctypes.c_uint]
            + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 7
            + scalar
            + [ctypes.c_void_p]
            + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def takes(terms: Optional[Sequence[Sequence[int]]], k: int, n_scalars: int) -> Optional[Tuple[int, int]]:
    """(phase, round degree) where the CUDA kernel takes this polynomial
    (``terms`` None: the product of all k tables), else None: the product of
    2 or 3 tables (phase 0, degree k) or a LibraW shape (phase 1 or 2,
    degree 2). ``ops/multiblock.py`` runs every other single-block shape."""
    terms = None if terms is None else tuple(map(tuple, terms))
    if terms is None or terms == (tuple(range(k)),) and not n_scalars:
        return (0, k) if k in (2, 3) else None
    if terms in _LIBRA and k == 3 and n_scalars == _LIBRA[terms][1]:
        return _LIBRA[terms][0], 2
    return None


def blocks_for(batch: int, half: int) -> int:
    """Blocks per proof: enough to fill the card across the batch, and no
    more than one block per THREADS pair indices."""
    return max(1, min(-(-half // THREADS), _TARGET_BLOCKS // batch))


def degree_of(terms: Sequence[Sequence[int]], k: int) -> int:
    """The round degree: the most folded tables (ids < k) in one term."""
    return max(sum(1 for i in term if i < k) for term in terms)


def _check(tables, r, out, fold: bool, dtype) -> Tuple[int, int, torch.device]:
    if not tables:
        raise ValueError("round_partials needs at least one table")
    t0 = tables[0]
    dev = t0.device
    if t0.dim() != 2:
        raise ValueError(f"tables must be [B, n], got shape {tuple(t0.shape)}")
    batch, n = t0.shape
    if n < (4 if fold else 2) or n & (n - 1):
        raise ValueError(f"table length {n} must be a power of two >= {4 if fold else 2}")
    for t in tables:
        if t.dtype != dtype or t.shape != t0.shape or t.device != dev:
            raise ValueError(f"tables must be {dtype} tensors of one shape on one device")
        if not t.is_contiguous():
            raise ValueError("tables must be contiguous")
    if fold:
        if r is None or r.dtype != dtype or r.shape != (batch,) or r.device != dev:
            raise ValueError(f"r must be a {dtype} [{batch}] tensor on {dev}")
        if not r.is_contiguous():
            raise ValueError("r must be contiguous")
    if out is not None:
        if len(out) != len(tables):
            raise ValueError("one output per table")
        for o in out:
            if o.dtype != dtype or o.shape != (batch, n // 2) or o.device != dev:
                raise ValueError(f"outputs must be {dtype} [{batch}, {n // 2}] on {dev}")
            if not o.is_contiguous():
                raise ValueError("outputs must be contiguous")
    return batch, n, dev


def _check_terms(terms, scalars, k: int, batch: int, dtype, dev):
    ids = k + len(scalars)
    if not terms or any(not term or any(not 0 <= i < ids for i in term) for term in terms):
        raise ValueError(f"terms must be non-empty tuples of table ids < {ids}")
    for s in scalars:
        if s.dtype != dtype or s.shape != (batch,) or s.device != dev or not s.is_contiguous():
            raise ValueError(f"scalars must be contiguous {dtype} [{batch}] tensors on {dev}")


def round_partials(
    tables: Sequence[torch.Tensor],
    r: Optional[torch.Tensor] = None,
    skip_t1: bool = False,
    out: Optional[Sequence[torch.Tensor]] = None,
    field: FieldConfig = GOLDILOCKS,
    terms: Optional[Sequence[Sequence[int]]] = None,
    scalars: Sequence[torch.Tensor] = (),
) -> Tuple[Optional[List[torch.Tensor]], torch.Tensor]:
    """One round over B proofs of a single-block polynomial.

    ``tables``: k [B, n] tensors of ``field``'s words (``FArray`` data,
    MSB-first). ``r``: [B] challenges, or None for a round without a fold.
    ``skip_t1``: leave s(1) out (0); the caller fills claim - s(0).
    ``out``: k [B, n/2] buffers for the folded tables (allocated when
    None). ``terms``: the polynomial as a sum of products of table ids,
    folded tables 0..k-1 first, then ``scalars`` ([B] words each, never
    folded); None is the product of all k tables. Returns (folded tables or
    None, partials [B, blocks, d+1]) with d the round degree, all in the
    field's word dtype. The input tables are never written.
    """
    fold = r is not None
    dtype = word_dtype(field)
    batch, n, dev = _check(tables, r, out, fold, dtype)
    k = len(tables)
    if terms is not None:
        terms = tuple(tuple(term) for term in terms)
        _check_terms(terms, scalars, k, batch, dtype, dev)
    half = n // 4 if fold else n // 2
    blocks = blocks_for(batch, half)
    if dev.type == "cpu":
        folded, partials = round_partials_plain(tables, r, skip_t1, blocks, field, terms, scalars)
        if out is not None and folded is not None:
            for o, f in zip(out, folded):
                o.copy_(f)
            folded = list(out)
        return folded, partials
    if dev.type != "cuda":
        raise ValueError(f"round_partials runs on cpu or cuda, not {dev}")
    shape = takes(terms, k, len(scalars))
    if shape is None:
        raise NotImplementedError(
            f"the CUDA round kernel takes the product of 2 or 3 tables and the two LibraW shapes, "
            f"not terms {terms} over {k} tables and {len(scalars)} scalars: the multi-block kernel "
            f"(ops/multiblock.py, through round_kernel.round_step) runs the others, one proof at a time"
        )
    phase, d = shape
    if batch > 65535:
        raise ValueError("the CUDA round kernel takes at most 65535 proofs")
    if fold and out is None:
        out = [torch.empty((batch, n // 2), dtype=dtype, device=dev) for _ in tables]
    partials = torch.empty((batch, blocks, d + 1), dtype=dtype, device=dev)
    ins = [t.data_ptr() for t in tables] + [None] * (3 - k)
    outs = ([o.data_ptr() for o in out] if fold else []) + [None] * (3 - (k if fold else 0))
    chunk = -(-half // blocks)
    mont32 = field.backend == "mont32"
    head = (int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0)
    tail = (partials.data_ptr(), batch, n, blocks, chunk, torch.cuda.current_stream(dev).cuda_stream)
    rp = r.data_ptr() if fold else None
    if phase == 0:
        rc = _kernel()(*head, k, int(fold), int(skip_t1), *ins, *outs, rp, *tail)
    else:
        sp = scalars[0].data_ptr() if scalars else None
        rc = _kernel("ts_libra_round_launch")(*head, phase, int(fold), int(skip_t1), *ins, *outs, rp, sp, *tail)
    if rc != 0:
        raise RuntimeError(f"round kernel launch failed: CUDA error {rc}")
    (launches if phase == 0 else libra_launches)[field.backend] += 1
    return (list(out) if fold else None), partials


def round_partials_plain(
    tables: Sequence[torch.Tensor],
    r: Optional[torch.Tensor],
    skip_t1: bool,
    blocks: int,
    field: FieldConfig = GOLDILOCKS,
    terms: Optional[Sequence[Sequence[int]]] = None,
    scalars: Sequence[torch.Tensor] = (),
) -> Tuple[Optional[List[torch.Tensor]], torch.Tensor]:
    """The kernel's function in plain torch ops (``FArray`` arithmetic, any
    device), for any terms: the same folded tables and the same per-block
    partials (block x sums the pair indices [x * chunk, (x + 1) * chunk))."""
    batch, n = tables[0].shape
    k = len(tables)
    terms = (tuple(range(k)),) if terms is None else terms
    degree = degree_of(terms, k)
    tabs = [FArray(t, field) for t in tables]
    consts = [FArray(s.reshape(batch, 1), field) for s in scalars]
    if r is not None:
        h = n // 4
        rr = FArray(r.reshape(batch, 1), field)
        lo = [FArray.fold(t[:, :h], t[:, 2 * h : 3 * h], rr) for t in tabs]
        hi = [FArray.fold(t[:, h : 2 * h], t[:, 3 * h :], rr) for t in tabs]
        folded = [torch.cat([a.data, b.data], dim=1) for a, b in zip(lo, hi)]
    else:
        h = n // 2
        lo = [t[:, :h] for t in tabs]
        hi = [t[:, h:] for t in tabs]
        folded = None
    chunk = -(-h // blocks)
    pad = blocks * chunk - h
    deltas = [b - a for a, b in zip(lo, hi)]
    cols = []
    views = None
    for t in range(degree + 1):
        if t == 0:
            views = lo
        elif t == 1:
            views = hi
        else:
            views = [v + d for v, d in zip(views, deltas)]
        if t == 1 and skip_t1:
            cols.append(torch.zeros((batch, blocks), dtype=word_dtype(field), device=tables[0].device))
            continue
        total = None
        for term in terms:
            factors = [views[i] if i < k else consts[i - k] for i in term]
            prod = factors[0]
            for v in factors[1:]:
                prod = prod * v
            prod = FArray(prod.data.expand(batch, h), field)
            total = prod if total is None else total + prod
        padded = torch.nn.functional.pad(total.data, (0, pad))
        cols.append(FArray(padded.reshape(batch, blocks, chunk), field).sum(axis=2).data)
    return folded, torch.stack(cols, dim=2)
