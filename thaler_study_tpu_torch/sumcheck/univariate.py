"""Sparse univariate polynomials over a prime field (host-side).

The wire format of every sumcheck round: the reference passes arkworks
``univariate::SparsePolynomial`` values between prover and verifier
(sum-check-protocol/src/lib.rs:105-111) and serializes them in Fiat-Shamir
transcripts (fiat-shamir/src/lib.rs:48-58). Terms are (degree, coeff) pairs,
sorted by degree, zero coefficients dropped — matching arkworks' invariants so
serialization is byte-identical.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from ..fields import Felt, FieldConfig


class UniPoly:
    """A sparse univariate polynomial: sorted (degree, coeff) terms."""

    __slots__ = ("terms", "field")

    def __init__(self, terms: Iterable[tuple[int, Felt]], field: FieldConfig):
        acc: dict[int, Felt] = {}
        for d, c in terms:
            acc[d] = acc[d] + c if d in acc else c
        self.terms = tuple(
            (d, c) for d, c in sorted(acc.items()) if not c.is_zero()
        )
        self.field = field

    # -- constructors --
    @classmethod
    def zero(cls, field: FieldConfig) -> "UniPoly":
        return cls((), field)

    @classmethod
    def from_coeffs(cls, coeffs: Sequence[Felt], field: FieldConfig) -> "UniPoly":
        """From a dense low-to-high coefficient list."""
        return cls(list(enumerate(coeffs)), field)

    # -- queries --
    def degree(self) -> int:
        return self.terms[-1][0] if self.terms else 0

    def is_zero(self) -> bool:
        return not self.terms

    def coeff(self, d: int) -> Felt:
        for deg, c in self.terms:
            if deg == d:
                return c
        return self.field.zero()

    def coeffs_dense(self) -> list:
        """Dense low-to-high coefficient list (length degree+1; [] if zero)."""
        if not self.terms:
            return []
        out = [self.field.zero()] * (self.degree() + 1)
        for d, c in self.terms:
            out[d] = c
        return out

    def evaluate(self, x: Felt) -> Felt:
        """Sparse evaluation via pow — same complexity shape as arkworks."""
        acc = self.field.zero()
        for d, c in self.terms:
            acc = acc + c * (x**d)
        return acc

    # -- arithmetic --
    def __add__(self, other: "UniPoly") -> "UniPoly":
        return UniPoly(list(self.terms) + list(other.terms), self.field)

    def __sub__(self, other: "UniPoly") -> "UniPoly":
        return UniPoly(
            list(self.terms) + [(d, -c) for d, c in other.terms], self.field
        )

    def __mul__(self, other: "UniPoly") -> "UniPoly":
        out = []
        for d1, c1 in self.terms:
            for d2, c2 in other.terms:
                out.append((d1 + d2, c1 * c2))
        return UniPoly(out, self.field)

    def scale(self, s: Felt) -> "UniPoly":
        return UniPoly([(d, c * s) for d, c in self.terms], self.field)

    def __eq__(self, other) -> bool:
        return isinstance(other, UniPoly) and self.terms == other.terms

    def __hash__(self):
        return hash(self.terms)

    def __repr__(self):
        if not self.terms:
            return "UniPoly(0)"
        return "UniPoly(" + " + ".join(f"{c.v}*t^{d}" for d, c in self.terms) + ")"


def lagrange_interpolate(points: Sequence[tuple[Felt, Felt]], field) -> UniPoly:
    """Interpolate the unique degree<n polynomial through n points.

    Generalizes the reference's explicit 3-point
    ``interpolate_quadratic_poly`` (matrix-multiplication/src/lib.rs:17-60)
    to any degree; zero coefficients are dropped so the resulting sparse
    polynomial matches the reference's transcripts even when it interpolates
    on a larger domain than the true degree (e.g. GKR's size-4 FFT domain for
    degree-2 round polys, gkr-protocol/src/round_polynomial.rs:78-90 — the
    coefficient form is domain-independent).
    """
    result = UniPoly.zero(field)
    for i, (x_i, y_i) in enumerate(points):
        numer = UniPoly([(0, field.one())], field)
        denom = field.one()
        for j, (x_j, _) in enumerate(points):
            if i == j:
                continue
            numer = numer * UniPoly([(0, -x_j), (1, field.one())], field)
            denom = denom * (x_i - x_j)
        result = result + numer.scale(y_i / denom)
    return result


def interpolate_at_small_points(values: Sequence[Felt], field) -> UniPoly:
    """Interpolate s(t) from values at t = 0, 1, ..., len(values)-1.

    The sumcheck round polynomial from the kernel's partial sums.
    """
    pts = [(field.felt(t), v) for t, v in enumerate(values)]
    return lagrange_interpolate(pts, field)
