"""Relaxed polynomial commitment scheme (ref: relaxed-pcs crate)."""

from .merkle import MerkleMultiPath, MerklePath, MerkleTree
from .relaxed import (
    DegreeMismatch,
    EvalMismatch,
    NoProverPoly,
    PCSError,
    Prover,
    Verifier,
    all_field_values,
    all_multidimensional_values,
)

__all__ = [
    "MerkleTree",
    "MerklePath",
    "MerkleMultiPath",
    "Prover",
    "Verifier",
    "PCSError",
    "EvalMismatch",
    "DegreeMismatch",
    "NoProverPoly",
    "all_field_values",
    "all_multidimensional_values",
]
