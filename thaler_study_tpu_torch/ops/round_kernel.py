"""One sumcheck prover round over a product polynomial.

The port's counterpart of ``thaler_study_tpu/ops/round_kernel.py``. A
:class:`PolySpec` describes g(x) = sum over terms of products of dense MLE
factor tables over variable blocks (matmul IP, triangle IP, GKR's W, ...).
This slice ports single-block products: one block, one term holding every
table (the matmul IP and the batched prover). Multi-block specs (triangle
IP, GKR W) raise ``NotImplementedError``; they are a later slice.

Tables are flat, MSB-first: the round variable splits each in halves.
:func:`round_step` goes through ``cuda_round.round_partials``: the CUDA
kernel for CUDA tensors, at every table size, and its plain version for CPU
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..fields import FArray
from ..fields import goldilocks as gl
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


def check_single_block(spec: PolySpec, num_tables: int) -> None:
    """Raise unless ``spec`` is a single-block product of all its tables."""
    if (
        len(spec.block_sizes) != 1
        or len(spec.terms) != 1
        or sorted(spec.terms[0]) != list(range(num_tables))
        or len(spec.table_blocks) != num_tables
        or any(tb != (0,) for tb in spec.table_blocks)
    ):
        raise NotImplementedError(
            "multi-block or multi-term specs (triangle IP, GKR W) are a "
            "later slice of the port; only single-block products are ported"
        )


def _round_sums(partials: torch.Tensor, claim: Optional[torch.Tensor]) -> torch.Tensor:
    """Round sums s(0..d) from the round kernel's [blocks, d+1] partials;
    with the round claim c known, s(1) = c - s(0) (exact mod p)."""
    sums = gl.sum_mod(partials, 0)
    if claim is not None:
        sums[1] = gl.sub(claim, sums[0])
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
    spec with ``spec.after_fold()``). ``claim`` (a 0-d FArray, =
    g_prev(r_prev)) lets the round skip the t = 1 product pass:
    s(1) = claim - s(0), exact mod p, sums unchanged.
    """
    check_single_block(spec, len(tables))
    field = tables[0].field
    data = [t.data.reshape(1, -1) for t in tables]
    r = None if r_prev is None else r_prev.data.reshape(1)
    folded, partials = cuda_round.round_partials(data, r, skip_t1=claim is not None)
    sums = _round_sums(partials[0], None if claim is None else claim.data.reshape(()))
    if folded is not None:
        tables = tuple(FArray(f.reshape(-1), field) for f in folded)
    return FArray(sums, field), tuple(tables)


def fold_step(
    spec: PolySpec, tables: Sequence[FArray], r: FArray
) -> Tuple[FArray, ...]:
    """Fold the current (MSB) variable at r in every table: the parity
    ``fix_variables`` path (the reference's ``_fold_tables``), plain torch."""
    check_single_block(spec, len(tables))
    return tuple(FArray.fold(t[: t.shape[0] // 2], t[t.shape[0] // 2 :], r) for t in tables)


def product_evals(spec: PolySpec, tables: Sequence[FArray]) -> FArray:
    """Dense evaluations of g on the hypercube, internal MSB-first order."""
    check_single_block(spec, len(tables))
    prod = tables[0]
    for t in tables[1:]:
        prod = prod * t
    return prod


def sum_products(spec: PolySpec, tables: Sequence[FArray]) -> FArray:
    """Sum of g over the whole hypercube — the prover's C_1."""
    return product_evals(spec, tables).sum(axis=0)
