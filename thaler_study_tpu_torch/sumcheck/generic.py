"""Generic sparse multivariate polynomials as SumCheckPolynomials.

Component #3 of the reference — the impl of ``SumCheckPolynomial`` for
``multivariate::SparsePolynomial<F, SparseTerm>``
(sum-check-protocol/src/lib.rs:158-224). This is the pedagogical path (the
production protocols use dense evaluation tables on device); semantics match
the reference exactly, including fix_variables' pad-with-ones trick.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..fields import Felt, FieldConfig
from .hypercube import BooleanHypercube
from .poly import SumCheckPolynomial
from .univariate import UniPoly

# a term is (coeff, ((var, power), ...)) with vars strictly increasing
Term = Tuple[int, ...]


class SparseMultiPoly(SumCheckPolynomial):
    """Sparse multivariate polynomial: sum of coeff * prod x_i^e_i terms."""

    def __init__(
        self,
        num_vars: int,
        terms: Sequence[tuple],  # (Felt coeff, [(var, power), ...])
        field: FieldConfig,
    ):
        self._num_vars = num_vars
        self._field = field
        # combine like terms, drop zero coefficients (arkworks semantics)
        acc: dict = {}
        for coeff, vps in terms:
            key = tuple(sorted((v, p) for v, p in vps if p > 0))
            acc[key] = acc[key] + coeff if key in acc else coeff
        self.terms = [
            (c, list(key)) for key, c in sorted(acc.items()) if not c.is_zero()
        ]

    @property
    def field(self) -> FieldConfig:
        return self._field

    def num_vars(self) -> int:
        return self._num_vars

    def _term_eval(self, vps, point: Sequence[Felt]) -> Felt:
        acc = self._field.one()
        for var, power in vps:
            acc = acc * (point[var] ** power)
        return acc

    def evaluate(self, point: Sequence[Felt]) -> Optional[Felt]:
        if len(point) != self._num_vars:
            return None
        acc = self._field.zero()
        for coeff, vps in self.terms:
            acc = acc + coeff * self._term_eval(vps, point)
        return acc

    def fix_variables(self, partial_point: Sequence[Felt]) -> "SparseMultiPoly":
        """Reference semantics (ref :163-187): evaluate each term at the
        partial point padded with ones, then re-index surviving variables."""
        k = len(partial_point)
        full_point = list(partial_point) + [self._field.one()] * (
            self._num_vars - k
        )
        new_terms = []
        for coeff, vps in self.terms:
            ev = coeff * self._term_eval(vps, full_point)
            new_vps = [(var - k, power) for var, power in vps if var >= k]
            new_terms.append((ev, new_vps))
        return SparseMultiPoly(self._num_vars - k, new_terms, self._field)

    def to_univariate(self) -> UniPoly:
        """Sum over the hypercube of the tail variables, collecting
        coefficients by the degree of variable 0 (ref :189-213)."""
        out = UniPoly.zero(self._field)
        for p in BooleanHypercube(self._num_vars - 1, self._field):
            point = [self._field.one()] + p
            terms = []
            for coeff, vps in self.terms:
                ev = coeff * self._term_eval(vps, point)
                power = next((pw for v, pw in vps if v == 0), 0)
                terms.append((power, ev))
            out = out + UniPoly(terms, self._field)
        return out

    def to_evaluations(self) -> List[Felt]:
        return [
            self.evaluate(point)
            for point in BooleanHypercube(self._num_vars, self._field)
        ]

    def round_degree(self, j: int) -> Optional[int]:
        """deg(g_j) <= deg_{x_j}(g): the max power of variable j over the
        terms (fixing x_0..x_{j-1} and summing the tail cannot raise it)."""
        if not 0 <= j < self._num_vars:
            return None
        return max(
            (pw for _, vps in self.terms for v, pw in vps if v == j),
            default=0,
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SparseMultiPoly)
            and self._num_vars == other._num_vars
            and self.terms == other.terms
        )

    def __repr__(self):
        names = " + ".join(
            f"{c.v}*" + "*".join(f"x{v}^{p}" for v, p in vps)
            for c, vps in self.terms
        )
        return f"SparseMultiPoly({self._num_vars} vars: {names})"
