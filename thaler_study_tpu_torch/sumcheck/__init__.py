"""Core sumcheck protocol (ref: sum-check-protocol crate)."""

from .hypercube import BooleanHypercube, FeltRng, RandNums, SeededRng
from .poly import SumCheckPolynomial
from .generic import SparseMultiPoly
from .protocol import (
    FinalRound,
    JthRound,
    NoPolySet,
    Prover,
    ProverClaimMismatch,
    SumCheckError,
    Verifier,
    VerifierRoundResult,
)
from .univariate import (
    UniPoly,
    interpolate_at_small_points,
    lagrange_interpolate,
)

__all__ = [
    "BooleanHypercube",
    "FeltRng",
    "RandNums",
    "SeededRng",
    "SumCheckPolynomial",
    "SparseMultiPoly",
    "Prover",
    "Verifier",
    "VerifierRoundResult",
    "JthRound",
    "FinalRound",
    "SumCheckError",
    "ProverClaimMismatch",
    "NoPolySet",
    "UniPoly",
    "lagrange_interpolate",
    "interpolate_at_small_points",
]
