"""One sumcheck prover round over a product polynomial.

The port's counterpart of ``thaler_study_tpu/ops/round_kernel.py``. A
:class:`PolySpec` describes g(x) = sum over terms of products of dense MLE
factor tables over variable blocks: the matmul IP and the batched prover's
product (one block), GKR's LibraW phases (one block and a 0-block scalar
w_u), GKR's dense W (two blocks), the triangle IP (three blocks). Specs of
up to three blocks are ported; wider ones raise.

Tables are flat, MSB-first: the round variable (block 0's first) splits
each table over block 0 in halves. :func:`round_step` runs a round on one
of three kernels, each with a plain version for CPU tensors:

- ``csrc/round_kernel.cu`` (the Pallas kernel's port) for the
  single-block shapes it takes: the two LibraW shapes through
  ``cuda_round.libra_round_sums`` (the fold and s(0..2), the claim
  shortcut's s(1) included, in one launch) and the product of 2 or 3
  tables through ``cuda_round.round_partials`` (per-block partials, summed
  here);
- ``multiblock.round_sums`` (``csrc/multiblock_round.cu``) for every
  other spec: the fold and the round sums s(0..D), the claim shortcut's
  s(1) included, in one launch;
- ``modmatmul.contract_partials_many`` for the triangle term whose grid
  exceeds :data:`CONTRACT_THRESHOLD` (the X phase), after
  ``multiblock.fold_tables``: ``csrc/modmatmul_tc.cu`` (tensor cores).

Every function here takes Goldilocks and the mont32 fields; round sums of a
mont32 field are Montgomery words, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..fields import FArray, FieldConfig
from . import cuda_round, modmatmul, multiblock


@dataclasses.dataclass(frozen=True)
class PolySpec:
    """Static structure of a multi-term product polynomial.

    - ``block_sizes[i]``: number of boolean variables in block i. Global
      variable order = block 0 vars, block 1 vars, ... The sumcheck folds
      block 0 first.
    - ``table_blocks[k]``: the (strictly increasing) block ids that table k
      ranges over. Its index space is the concatenation of those blocks'
      variables, MSB-first.
    - ``terms[t]``: table ids whose product forms term t; g = sum of terms.
    """

    block_sizes: Tuple[int, ...]
    table_blocks: Tuple[Tuple[int, ...], ...]
    terms: Tuple[Tuple[int, ...], ...]

    def degree(self) -> int:
        """Max per-term count of factors involving block 0 = the degree of
        the current round's univariate polynomial."""
        return max(
            sum(1 for k in term if 0 in self.table_blocks[k])
            for term in self.terms
        )

    def num_vars(self) -> int:
        return sum(self.block_sizes)

    def round_degrees(self) -> Tuple[int, ...]:
        """Per-round univariate degrees for a full sumcheck over this spec:
        entry j is ``degree()`` of the spec after j folds."""
        degs = []
        spec = self
        for _ in range(self.num_vars()):
            degs.append(spec.degree())
            spec = spec.after_fold()
        return tuple(degs)

    def after_fold(self) -> "PolySpec":
        """The spec after folding one variable of block 0."""
        sizes = list(self.block_sizes)
        sizes[0] -= 1
        if sizes[0] > 0:
            return dataclasses.replace(self, block_sizes=tuple(sizes))
        # drop block 0, renumber blocks down by one
        return PolySpec(
            block_sizes=tuple(sizes[1:]),
            table_blocks=tuple(
                tuple(b - 1 for b in tb if b != 0) for tb in self.table_blocks
            ),
            terms=self.terms,
        )


def single_block_spec(k: int, n: int) -> PolySpec:
    """The spec of a k-factor product over one block of n variables."""
    return PolySpec(
        block_sizes=(n,),
        table_blocks=tuple((0,) for _ in range(k)),
        terms=(tuple(range(k)),),
    )


def _table_size(spec: PolySpec, k: int) -> int:
    return 1 << sum(spec.block_sizes[b] for b in spec.table_blocks[k])


def _broadcast_dims(spec: PolySpec, k: int) -> Tuple[int, ...]:
    """Shape that table k broadcasts to within the global block grid."""
    return tuple(
        2 ** spec.block_sizes[b] if b in spec.table_blocks[k] else 1
        for b in range(len(spec.block_sizes))
    )


def check_spec(spec: PolySpec, tables: Sequence[FArray]) -> None:
    """Raise unless ``spec`` is a spec the port runs and ``tables`` fit it:
    up to three variable blocks, each table over a strictly increasing
    subset of them (a 0-block scalar of shape (1,) too), non-empty terms
    over the tables."""
    if len(spec.block_sizes) > multiblock.MAX_BLOCKS:
        raise NotImplementedError(
            f"specs of more than {multiblock.MAX_BLOCKS} variable blocks are not ported "
            f"(got {len(spec.block_sizes)}; ROADMAP A7)"
        )
    nb = len(spec.block_sizes)
    ok = (
        len(spec.table_blocks) == len(tables)
        and all(list(tb) == sorted(set(tb)) and all(0 <= b < nb for b in tb) for tb in spec.table_blocks)
        and spec.terms
        and all(term and all(0 <= i < len(tables) for i in term) for term in spec.terms)
    )
    if not ok or any(t.shape != (_table_size(spec, k),) for k, t in enumerate(tables)):
        raise ValueError(
            f"tables of shapes {[t.shape for t in tables]} do not fit the spec {spec}"
        )


def _split(spec: PolySpec):
    """(folded table ids, scalar table ids, the terms renumbered over the
    folded tables first, then the scalars) - the round kernel's view of a
    single-block spec."""
    fold_ids = [k for k, tb in enumerate(spec.table_blocks) if tb]
    scalar_ids = [k for k, tb in enumerate(spec.table_blocks) if not tb]
    pos = {k: i for i, k in enumerate(fold_ids + scalar_ids)}
    terms = tuple(tuple(pos[k] for k in term) for term in spec.terms)
    return fold_ids, scalar_ids, terms


def _round_kernel_split(spec: PolySpec):
    """``_split(spec)`` for a single-block spec that one proof's round
    runs on ``cuda_round`` (the product of 2 or 3 tables, the LibraW
    shapes), else None: the multi-block kernel runs the rest, k = 1 and
    k >= 4 products included, since it finishes s(0..D) in its launch."""
    if len(spec.block_sizes) > 1 or any(tb not in ((0,), ()) for tb in spec.table_blocks):
        return None
    split = _split(spec)
    fold_ids, scalar_ids, terms = split
    shape = cuda_round.takes(terms, len(fold_ids), len(scalar_ids))
    return split if shape is not None and (shape[0] or len(fold_ids) in (2, 3)) else None


# a triangle term whose (halved) grid exceeds this goes through the modular
# matmul contraction (JAX round_kernel.py :162); any route gives the same
# field values
CONTRACT_THRESHOLD = 1 << 22


def _contraction(spec: PolySpec, term, halved: bool):
    """(k1, k2, k3), the term's factors over (X,Y), (Y,Z), (X,Z), when the
    term is the triangle pattern over three blocks and its grid (block 0
    halved where ``halved``) exceeds CONTRACT_THRESHOLD; else None. With
    at most three blocks, X is block 0."""
    tbs = [spec.table_blocks[k] for k in term]
    if len(term) != 3 or sorted(len(tb) for tb in tbs) != [2, 2, 2]:
        return None
    blocks = sorted(set().union(*map(set, tbs)))
    if len(blocks) != 3:
        return None
    x, y, z = blocks
    by_cover = {frozenset(tb): k for tb, k in zip(tbs, term)}
    ks = tuple(by_cover.get(frozenset(pair)) for pair in ((x, y), (y, z), (x, z)))
    if None in ks:
        return None
    sx, sy, sz = (spec.block_sizes[b] for b in (x, y, z))
    grid = (1 << (sx - 1 if halved else sx)) << (sy + sz)
    return ks if grid > CONTRACT_THRESHOLD else None


def _contract(spec: PolySpec, ks, data, field: FieldConfig, ts) -> FArray:
    """s(t) for t in ``ts`` (None: the whole-grid sum) of the triangle term
    (k1, k2, k3): sum over the grid of f1_t (f3_t @ f2^T), on the modular
    matmul kernel with the dot in its epilogue (f2's digit planes made once
    for all of ``ts``)."""
    sx, sy, sz = spec.block_sizes
    f1 = data[ks[0]].reshape(1 << sx, 1 << sy)
    f2 = data[ks[1]].reshape(1 << sy, 1 << sz)
    f3 = data[ks[2]].reshape(1 << sx, 1 << sz)
    sums = [FArray(p, field).sum(axis=0) for p in modmatmul.contract_partials_many(f3, f2, f1, field, ts)]
    return FArray(torch.stack([s.data for s in sums]), field)


def round_step(
    spec: PolySpec,
    tables: Sequence[FArray],
    r_prev: Optional[FArray],
    claim: Optional[FArray] = None,
) -> Tuple[FArray, Tuple[FArray, ...]]:
    """Run one fused prover round.

    Returns (sums[degree+1], new_tables). If ``r_prev`` is given the fold
    happens first and ``new_tables`` reflect it (the caller advances the
    spec with ``spec.after_fold()``); tables without block 0 are never
    folded. Every term is evaluated at t = 0..degree, single-factor terms
    included. ``claim`` (a 0-d FArray, = g_prev(r_prev)) lets the round
    skip the t = 1 product pass: s(1) = claim - s(0), exact mod p, sums
    unchanged.
    """
    check_spec(spec, tables)
    field = tables[0].field
    sums_spec = spec.after_fold() if r_prev is not None else spec
    degree = sums_spec.degree()
    if degree < 1:
        claim = None
    skip_t1 = claim is not None
    filled = False
    r = None if r_prev is None else r_prev.data.reshape(1)
    split = _round_kernel_split(spec)
    if split is not None:
        fold_ids, scalar_ids, terms = split
        fold_tabs = [tables[k].data.reshape(1, -1) for k in fold_ids]
        scalars = [tables[k].data.reshape(1) for k in scalar_ids]
        if cuda_round.takes(terms, len(fold_ids), len(scalar_ids))[0]:  # a LibraW shape
            filled = claim is not None
            folded, s = cuda_round.libra_round_sums(fold_tabs, r, skip_t1, None, field, terms, scalars,
                                                    claim.data.reshape(1) if filled else None)
            sums = FArray(s[0], field)
        else:
            folded, partials = cuda_round.round_partials(fold_tabs, r, skip_t1=skip_t1, field=field, terms=terms,
                                                         scalars=scalars)
            sums = FArray(partials[0], field).sum(axis=0)
        data = [t.data for t in tables]
        for k, f in zip(fold_ids, folded or ()):
            data[k] = f.reshape(-1)
    else:
        contracted = [(term, _contraction(sums_spec, term, True)) for term in sums_spec.terms]
        rest = [term for term, ks in contracted if ks is None]
        data = [t.data for t in tables]
        if r is not None and len(rest) < len(contracted):
            halves = [t.shape[0] // 2 if 0 in tb else 0 for t, tb in zip(tables, spec.table_blocks)]
            data = multiblock.fold_tables(data, halves, r, field)
            r = None
        sums = None
        if rest:
            # the kernel writes s(1) = claim - s(0) where it sums every term
            filled = claim is not None and len(rest) == len(contracted)
            plan = multiblock.round_plan(spec if r is not None else sums_spec, r is not None, rest, degree)
            folded, s = multiblock.round_sums(plan, data, r, field, skip_t1,
                                              claim.data.reshape(1) if filled else None)
            data = [d if f is None else f for d, f in zip(data, folded)]
            sums = FArray(s, field)
        ts = [t for t in range(degree + 1) if not (skip_t1 and t == 1)]
        for _, ks in contracted:
            if ks is None:
                continue
            part = _contract(sums_spec, ks, data, field, ts)
            if skip_t1:
                part = FArray(torch.cat([part.data[:1], torch.zeros_like(part.data[:1]), part.data[1:]]), field)
            sums = part if sums is None else sums + part
    if claim is not None and not filled:
        sums.data[1] = (claim - sums[0]).data
    return sums, tuple(FArray(d, field) for d in data)


def fold_step(
    spec: PolySpec, tables: Sequence[FArray], r: FArray
) -> Tuple[FArray, ...]:
    """Fold the current (block-0 MSB) variable at r in every table that
    contains block 0: the parity ``fix_variables`` path (the reference's
    ``_fold_tables``), one launch of the multi-block fold kernel."""
    check_spec(spec, tables)
    field = tables[0].field
    halves = [t.shape[0] // 2 if 0 in tb else 0 for t, tb in zip(tables, spec.table_blocks)]
    data = multiblock.fold_tables([t.data for t in tables], halves, r.data.reshape(1), field)
    return tuple(FArray(d, field) for d in data)


def sum_products(spec: PolySpec, tables: Sequence[FArray]) -> FArray:
    """Sum of g over the whole hypercube — the prover's C_1: s(0) + s(1)
    of one round without a fold on the multi-block kernel, and the triangle
    contraction on the modular matmul kernel where its grid is large."""
    check_spec(spec, tables)
    field = tables[0].field
    if not spec.block_sizes:
        return product_evals(spec, tables).sum(axis=0)
    data = [t.data for t in tables]
    contracted = [(term, _contraction(spec, term, False)) for term in spec.terms]
    rest = [term for term, ks in contracted if ks is None]
    total = None
    if rest:
        _, s = multiblock.round_sums(multiblock.round_plan(spec, False, rest, 1), data, None, field)
        total = FArray(s[0], field) + FArray(s[1], field)
    for _, ks in contracted:
        if ks is not None:
            part = _contract(spec, ks, data, field, [None])[0]
            total = part if total is None else total + part
    return total


def product_evals(spec: PolySpec, tables: Sequence[FArray]) -> FArray:
    """Dense evaluations of g on the hypercube, internal MSB-first order
    (plain torch: the parity ``to_evaluations``)."""
    check_spec(spec, tables)
    full = tuple(1 << s for s in spec.block_sizes) or (1,)
    acc = None
    for term in spec.terms:
        prod = None
        for k in term:
            v = tables[k].reshape(*(_broadcast_dims(spec, k) or (1,)))
            prod = v if prod is None else prod * v
        prod = FArray(prod.data.expand(full), prod.field)
        acc = prod if acc is None else acc + prod
    return FArray(acc.data.reshape(-1).contiguous(), acc.field)
