"""One sumcheck prover round over a product polynomial.

The port's counterpart of ``thaler_study_tpu/ops/round_kernel.py``. A
:class:`PolySpec` describes g(x) = sum over terms of products of dense MLE
factor tables over variable blocks (matmul IP, triangle IP, GKR's W, ...).
This port takes single-block specs: one block, any terms over the tables,
and 0-block scalar tables (the matmul IP and the batched prover's product;
GKR's LibraW phases, whose phase-2 scalar w_u is such a table).
Multi-block specs (triangle IP, dense GKR W) raise ``NotImplementedError``;
they are the multi-block slice.

Tables are flat, MSB-first: the round variable splits each in halves.
:func:`round_step` goes through ``cuda_round.round_partials``: the CUDA
kernel for CUDA tensors, at every table size, and its plain version for CPU
tensors. Every function here takes Goldilocks and the mont32 fields; round
sums of a mont32 field are Montgomery words, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..fields import FArray, FieldConfig
from . import cuda_round


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


def check_single_product(spec: PolySpec, num_tables: int) -> None:
    """Raise unless ``spec`` is a single-block product of all its tables
    (the batched FS prover's shape)."""
    if (
        len(spec.block_sizes) != 1
        or len(spec.terms) != 1
        or sorted(spec.terms[0]) != list(range(num_tables))
        or len(spec.table_blocks) != num_tables
        or any(tb != (0,) for tb in spec.table_blocks)
    ):
        raise NotImplementedError(
            "the fused batch prover takes a single-block product of all its "
            "tables; multi-term specs go through ProductPoly, multi-block ones "
            "(triangle IP, dense GKR W) are the multi-block slice of the port"
        )


def check_single_block(spec: PolySpec, tables: Sequence[FArray]) -> None:
    """Raise unless ``spec`` has one variable block (or none left): every
    table over block 0 or a 0-block scalar of shape (1,), any non-empty
    terms over the tables."""
    ok = (
        len(spec.block_sizes) <= 1
        and len(spec.table_blocks) == len(tables)
        and all(tb in ((0,), ()) for tb in spec.table_blocks)
        and spec.terms
        and all(term and all(0 <= i < len(tables) for i in term) for term in spec.terms)
    )
    if ok:
        size = 1 << spec.block_sizes[0] if spec.block_sizes else 1
        ok = all(t.shape == ((size,) if tb else (1,)) for t, tb in zip(tables, spec.table_blocks))
    if not ok:
        raise NotImplementedError(
            "multi-block specs (triangle IP, dense GKR W) are the multi-block "
            "slice of the port; only single-block specs with 0-block scalar "
            "tables are ported"
        )


def _split(spec: PolySpec, tables: Sequence[FArray]):
    """(folded table ids, scalar table ids, the terms renumbered over the
    folded tables first, then the scalars) - the kernel's view of a spec."""
    fold_ids = [k for k, tb in enumerate(spec.table_blocks) if tb]
    scalar_ids = [k for k, tb in enumerate(spec.table_blocks) if not tb]
    pos = {k: i for i, k in enumerate(fold_ids + scalar_ids)}
    terms = tuple(tuple(pos[k] for k in term) for term in spec.terms)
    return fold_ids, scalar_ids, terms


def _round_sums(field: FieldConfig, partials: torch.Tensor, claim: Optional[FArray]) -> FArray:
    """Round sums s(0..d) from the round kernel's [blocks, d+1] partials;
    with the round claim c known (a 0-d FArray), s(1) = c - s(0), exact
    mod p."""
    sums = FArray(partials, field).sum(axis=0)
    if claim is not None:
        sums.data[1] = (claim - sums[0]).data
    return sums


def round_step(
    spec: PolySpec,
    tables: Sequence[FArray],
    r_prev: Optional[FArray],
    claim: Optional[FArray] = None,
) -> Tuple[FArray, Tuple[FArray, ...]]:
    """Run one fused prover round.

    Returns (sums[degree+1], new_tables). If ``r_prev`` is given the fold
    happens first and ``new_tables`` reflect it (the caller advances the
    spec with ``spec.after_fold()``); 0-block tables are never folded.
    Every term is evaluated at t = 0..degree, single-factor terms
    included. ``claim`` (a 0-d FArray, = g_prev(r_prev)) lets the round
    skip the t = 1 product pass: s(1) = claim - s(0), exact mod p, sums
    unchanged.
    """
    check_single_block(spec, tables)
    field = tables[0].field
    fold_ids, scalar_ids, terms = _split(spec, tables)
    if cuda_round.degree_of(terms, len(fold_ids)) < 1:
        claim = None
    data = [tables[k].data.reshape(1, -1) for k in fold_ids]
    scalars = [tables[k].data.reshape(1) for k in scalar_ids]
    r = None if r_prev is None else r_prev.data.reshape(1)
    folded, partials = cuda_round.round_partials(
        data, r, skip_t1=claim is not None, field=field, terms=terms, scalars=scalars
    )
    sums = _round_sums(field, partials[0], None if claim is None else claim.reshape(()))
    if folded is not None:
        tables = list(tables)
        for k, f in zip(fold_ids, folded):
            tables[k] = FArray(f.reshape(-1), field)
    return sums, tuple(tables)


def fold_step(
    spec: PolySpec, tables: Sequence[FArray], r: FArray
) -> Tuple[FArray, ...]:
    """Fold the current (MSB) variable at r in every table over block 0:
    the parity ``fix_variables`` path (the reference's ``_fold_tables``),
    plain torch."""
    check_single_block(spec, tables)
    return tuple(
        FArray.fold(t[: t.shape[0] // 2], t[t.shape[0] // 2 :], r) if tb else t
        for t, tb in zip(tables, spec.table_blocks)
    )


def _term_products(spec: PolySpec, tables: Sequence[FArray]):
    size = 1 << spec.num_vars()
    for term in spec.terms:
        prod = tables[term[0]]
        for k in term[1:]:
            prod = prod * tables[k]
        yield term, FArray(prod.data.expand(size), prod.field)


def product_evals(spec: PolySpec, tables: Sequence[FArray]) -> FArray:
    """Dense evaluations of g on the hypercube, internal MSB-first order."""
    check_single_block(spec, tables)
    acc = None
    for _, prod in _term_products(spec, tables):
        acc = prod if acc is None else acc + prod
    return FArray(acc.data.contiguous(), acc.field)


def sum_products(spec: PolySpec, tables: Sequence[FArray]) -> FArray:
    """Sum of g over the whole hypercube — the prover's C_1."""
    return product_evals(spec, tables).sum(axis=0)
