"""The fused round kernel for Hopper and its plain torch version.

Counterpart of ``thaler_study_tpu/ops/pallas_round.py`` (the Pallas kernel
``_make_kernel``, entered through ``pallas_round_step``): one pass over a
batch of single-block tables that folds the previous challenge and
computes the round sums. The CUDA source is ``csrc/round_kernel.cu``; its
note says what bounds it and how.

The kernel takes three shapes of polynomial (``terms`` over the folded
tables, then the per-proof scalars):

- the product of all k tables, 1 <= k <= :data:`MAX_K` (``terms=None``):
  the batched FS prover (every k) and the matmul IP (k = 2, 3);
- :data:`LIBRA_PHASE1`, W A1 + A2, and :data:`LIBRA_PHASE2`,
  B1 w_u + B1 Wc + B2 w_u Wc with the scalar w_u: the two phases of the GKR
  layer sumcheck (``gkr/linear.py``).

:func:`round_partials` is the wrapper. CPU tensors go to
:func:`round_partials_plain`, which takes any terms; CUDA tensors go to the
kernel or raise. Both return the same per-block partial sums, so the two
can be compared bit for bit; callers sum the partials mod p (the FS tail
kernel, ``round_kernel.round_step`` for the products, the GKR tails).
:func:`libra_round_sums` runs a LibraW round to its end in one launch
(K1's last block sums every block's partials and writes s(0..2), s(1) from
the claim where one is given); :func:`libra_round_sums_plain` is its plain
version. ``round_kernel.round_step`` sends a single proof of a product
of 2 or 3 tables here and every other single-block shape of one proof
(k = 1, k >= 4, other scalar terms) to the multi-block kernel
(``ops/multiblock.py``), which finishes s(0..D) in its launch; a batch of
B proofs, each with its own challenge, comes here at any k up to
:data:`MAX_K`. :func:`takes` says which shapes the kernel takes.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _build
from ..fields import GOLDILOCKS, FArray, FieldConfig
from ..fields.farray import word_dtype

THREADS = 256  # csrc/round_kernel.cu THREADS
MAX_K = 8  # csrc/round_kernel.cu MAX_K: the most factors of a product
VEC_BYTES = 16  # K1's loads and stores: csrc/round_kernel.cu Pack
_TARGET_BLOCKS = 2048  # blocks in flight over the whole batch: ~16 per SM

# the LibraW shapes: table ids 0-2 are folded tables, 3 the phase-2 scalar
LIBRA_PHASE1 = ((0, 1), (2,))
LIBRA_PHASE2 = ((0, 3), (0, 2), (1, 3, 2))
_LIBRA = {LIBRA_PHASE1: (1, 0), LIBRA_PHASE2: (2, 1)}  # terms -> (phase, scalars)

# launches of the CUDA kernels (not of the plain version), per instantiation
launches = {"goldilocks": 0, "mont32": 0}
libra_launches = {"goldilocks": 0, "mont32": 0}

_fns = {}
_wave = {}  # (device index, backend, phase, fold, skip_t1, tail) -> blocks of one wave
_counters = {}  # device index -> K1's ticket counter


def _kernel(name: str = "ts_round_launch"):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("round_kernel"), name)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        head = [i, ctypes.c_uint, ctypes.c_uint, i, i, i]
        if name == "ts_libra_round_launch":  # 3 in, 3 out, r, scalar, partials, sums, claim, counter; then vec
            fn.argtypes = head + [vp] * 12 + [ll, ll, i, ll, i, vp]
        elif name == "ts_libra_wave_blocks":
            fn.argtypes = [i] * 5
        else:  # in[k], out[k], r, partials
            fn.argtypes = head + [vp] * 4 + [ll, ll, i, ll, vp]
        fn.restype = i
        _fns[name] = fn
    return fn


def wave_blocks(dev: torch.device, backend: str, phase: int, fold: bool, skip_t1: bool, tail: bool = False) -> int:
    """Blocks of one wave of K1's instantiation on ``dev``: its SMs times
    the blocks of that kernel resident on one SM (``tail``: the Goldilocks
    form with the GKR round tail)."""
    key = (dev.index, backend, phase, fold, skip_t1, tail)
    n = _wave.get(key)
    if n is None:
        with torch.cuda.device(dev):
            n = _kernel("ts_libra_wave_blocks")(int(backend == "mont32"), phase, int(fold), int(skip_t1), int(tail))
        if n < 1:
            raise RuntimeError("could not read the round kernel's occupancy on the card")
        _wave[key] = n
    return n


def libra_blocks(half: int, vec_words: int, wave: int) -> int:
    """K1's blocks per proof: one per THREADS groups of ``vec_words`` pair
    indices (the words of one 16-byte access, or 1), at most ``wave``; so a
    table of up to 2^10 entries is one block."""
    return max(1, min(wave, -(-half // (THREADS * vec_words))))


def vec_words(half: int, word_bytes: int, tensors) -> int:
    """The words K1 moves per access: 16 bytes' worth where ``half`` is a
    multiple of that and every tensor is 16-byte aligned, else 1."""
    v = VEC_BYTES // word_bytes
    return v if half % v == 0 and all(t.data_ptr() % VEC_BYTES == 0 for t in tensors) else 1


def _counter(dev: torch.device) -> torch.Tensor:
    """The device's ticket counter for K1 (int32, 0 between launches)."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    c = _counters.get(key)
    if c is None:
        c = _counters[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return c


def takes(terms: Optional[Sequence[Sequence[int]]], k: int, n_scalars: int) -> Optional[Tuple[int, int]]:
    """(phase, round degree) where the CUDA kernel takes this polynomial
    (``terms`` None: the product of all k tables), else None: the product of
    1 to :data:`MAX_K` tables (phase 0, degree k) or a LibraW shape (phase 1
    or 2, degree 2). ``ops/multiblock.py`` runs every other single-block
    shape."""
    terms = None if terms is None else tuple(map(tuple, terms))
    if terms is None or terms == (tuple(range(k)),) and not n_scalars:
        return (0, k) if 1 <= k <= MAX_K else None
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
            f"the CUDA round kernel takes the product of 1 to {MAX_K} tables and the two LibraW shapes, "
            f"not terms {terms} over {k} tables and {len(scalars)} scalars: a product of more tables has "
            f"more factors than the kernel's registers and the multi-block kernel's MAX_TABLES hold; the "
            f"multi-block kernel (ops/multiblock.py, through round_kernel.round_step) runs the other "
            f"shapes, one proof at a time"
        )
    phase, d = shape
    if batch > 65535:
        raise ValueError("the CUDA round kernel takes at most 65535 proofs")
    if fold and out is None:
        out = [torch.empty((batch, n // 2), dtype=dtype, device=dev) for _ in tables]
    if phase:
        partials = _libra_launch(tables, r, skip_t1, out, field, phase, scalars, None, batch, n)
        return (list(out) if fold else None), partials
    partials = torch.empty((batch, blocks, d + 1), dtype=dtype, device=dev)
    ptrs = ctypes.c_void_p * k
    ins = ptrs(*(t.data_ptr() for t in tables))
    outs = ptrs(*(o.data_ptr() for o in out)) if fold else ptrs()
    rc = _kernel()(*_head(field), k, int(fold), int(skip_t1), ins, outs, r.data_ptr() if fold else None,
                   partials.data_ptr(), batch, n, blocks, -(-half // blocks),
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"round kernel launch failed: CUDA error {rc}")
    launches[field.backend] += 1
    return (list(out) if fold else None), partials


def _head(field: FieldConfig) -> tuple:
    mont32 = field.backend == "mont32"
    return int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0


def _libra_launch(tables, r, skip_t1, out, field, phase, scalars, sums, batch, n) -> torch.Tensor:
    """K1 on the card (checked arguments; ``out`` allocated where it
    folds): writes the per-block partials, and with ``sums`` (a (tensor
    [B, 3], claim or None) pair) the round's s(0..2). Returns the partials
    [B, blocks, 3]."""
    fold = r is not None
    dev = tables[0].device
    half = n // 4 if fold else n // 2
    wb = tables[0].element_size()
    vec = vec_words(half, wb, list(tables) + (list(out) if fold else []))
    blocks = libra_blocks(half, vec, wave_blocks(dev, field.backend, phase, fold, skip_t1))
    partials = torch.empty((batch, blocks, 3), dtype=tables[0].dtype, device=dev)
    s_out, claim = sums if sums is not None else (None, None)
    rc = _kernel("ts_libra_round_launch")(
        *_head(field), phase, int(fold), int(skip_t1), *(t.data_ptr() for t in tables),
        *([o.data_ptr() for o in out] if fold else [None] * 3), r.data_ptr() if fold else None,
        scalars[0].data_ptr() if scalars else None, partials.data_ptr(),
        s_out.data_ptr() if s_out is not None else None, claim.data_ptr() if claim is not None else None,
        _counter(dev).data_ptr(), batch, n, blocks, -(-half // blocks), int(vec > 1),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"round kernel launch failed: CUDA error {rc}")
    libra_launches[field.backend] += 1
    return partials


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


def libra_round_sums(
    tables: Sequence[torch.Tensor],
    r: Optional[torch.Tensor],
    skip_t1: bool,
    out: Optional[Sequence[torch.Tensor]],
    field: FieldConfig,
    terms: Sequence[Sequence[int]],
    scalars: Sequence[torch.Tensor] = (),
    claim: Optional[torch.Tensor] = None,
) -> Tuple[Optional[List[torch.Tensor]], torch.Tensor]:
    """One round of a LibraW shape (:data:`LIBRA_PHASE1` over three tables,
    :data:`LIBRA_PHASE2` over three tables and one scalar) over B proofs, to
    its end: (folded tables or None, s [B, 3]). ``tables``, ``r``,
    ``skip_t1``, ``out`` and ``scalars`` as :func:`round_partials` takes
    them; ``claim`` ([B] words, with ``skip_t1``) makes s(1) = claim - s(0);
    with ``skip_t1`` and no claim s(1) is 0. CPU tensors go to
    :func:`libra_round_sums_plain`; CUDA tensors to one launch of K1, whose
    last block sums every block's partials, or raise."""
    fold = r is not None
    dtype = word_dtype(field)
    batch, n, dev = _check(tables, r, out, fold, dtype)
    terms = tuple(tuple(term) for term in terms)
    _check_terms(terms, scalars, len(tables), batch, dtype, dev)
    shape = takes(terms, len(tables), len(scalars))
    if shape is None or shape[0] == 0:
        raise ValueError(f"libra_round_sums takes the two LibraW shapes, not terms {terms}")
    if claim is not None:
        if not skip_t1:
            raise ValueError("the claim shortcut needs skip_t1")
        if claim.dtype != dtype or claim.shape != (batch,) or claim.device != dev or not claim.is_contiguous():
            raise ValueError(f"claim must be a contiguous {dtype} [{batch}] tensor on {dev}")
    if dev.type == "cpu":
        folded, s = libra_round_sums_plain(tables, r, skip_t1, field, terms, scalars, claim)
        if out is not None and folded is not None:
            for o, f in zip(out, folded):
                o.copy_(f)
            folded = list(out)
        return folded, s
    if dev.type != "cuda":
        raise ValueError(f"libra_round_sums runs on cpu or cuda, not {dev}")
    if batch > 65535:
        raise ValueError("the CUDA round kernel takes at most 65535 proofs")
    if fold and out is None:
        out = [torch.empty((batch, n // 2), dtype=dtype, device=dev) for _ in tables]
    s = torch.empty((batch, 3), dtype=dtype, device=dev)
    _libra_launch(tables, r, skip_t1, out, field, shape[0], scalars, (s, claim), batch, n)
    return (list(out) if fold else None), s


def libra_round_sums_plain(
    tables: Sequence[torch.Tensor],
    r: Optional[torch.Tensor],
    skip_t1: bool,
    field: FieldConfig,
    terms: Sequence[Sequence[int]],
    scalars: Sequence[torch.Tensor] = (),
    claim: Optional[torch.Tensor] = None,
) -> Tuple[Optional[List[torch.Tensor]], torch.Tensor]:
    """:func:`libra_round_sums` in plain torch ops (any device): the folded
    tables and s [B, 3], s(1) = claim - s(0) where ``claim`` is given."""
    folded, partials = round_partials_plain(tables, r, skip_t1, 1, field, terms, scalars)
    s = partials[:, 0]
    if claim is not None:
        s[:, 1] = (FArray(claim, field) - FArray(s[:, 0], field)).data
    return folded, s
