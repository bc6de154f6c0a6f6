"""The SumCheckPolynomial protocol — the framework's central abstraction.

Component #2 of the reference (sum-check-protocol/src/lib.rs:121-156): every
protocol (generic multivariate, matmul-IP, triangle-IP, GKR's W) plugs into
the sumcheck state machines by implementing these five methods. Device-backed
implementations keep their evaluation tables as FArrays and implement
``to_univariate`` with one fused round kernel launch.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Sequence

from ..fields import Felt, FieldConfig
from .univariate import UniPoly


class SumCheckPolynomial(ABC):
    """Abstract n-variate polynomial usable in the sumcheck protocol."""

    @abstractmethod
    def evaluate(self, point: Sequence[Felt]) -> Optional[Felt]:
        """Evaluate at ``point``; None if the dimensionality mismatches
        (ref :126)."""

    @abstractmethod
    def fix_variables(self, partial_point: Sequence[Felt]) -> "SumCheckPolynomial":
        """Fix the first ``len(partial_point)`` variables (ref :130)."""

    @abstractmethod
    def to_univariate(self) -> UniPoly:
        """Sum over all-but-the-first variable on the hypercube, producing a
        univariate polynomial in x_1 (ref :148)."""

    @abstractmethod
    def num_vars(self) -> int:
        """Number of free variables (ref :151)."""

    @abstractmethod
    def to_evaluations(self) -> List[Felt]:
        """Evaluations over the boolean hypercube, little-endian index order
        (ref :155)."""

    @property
    @abstractmethod
    def field(self) -> FieldConfig:
        """The coefficient field."""

    def round_degree(self, j: int) -> Optional[int]:
        """Static upper bound on deg(g_j) — the degree of round j's
        univariate polynomial in x_j, derivable from the polynomial's
        structure alone (no evaluations needed).

        The reference never bounds round-polynomial degrees (its documented
        soundness gap, sum-check-protocol/src/lib.rs:284-329); a strict
        verifier holding the oracle uses this to enforce deg(g_j) <= bound
        without the caller passing ``max_degree``. ``None`` means "unknown"
        (no bound is enforced)."""
        return None
