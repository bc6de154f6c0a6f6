"""Multilinear extensions: dense tables in the internal MSB-first order, and
the reference crate's two evaluation algorithms."""

from .algorithms import (
    cti_multilinear_from_evaluations,
    eq_weight_table,
    vsbw_multilinear_from_evaluations,
)
from .dense import DenseMLE, bitrev, bitrev_perm, fold_msb

__all__ = [
    "DenseMLE",
    "bitrev",
    "bitrev_perm",
    "fold_msb",
    "eq_weight_table",
    "vsbw_multilinear_from_evaluations",
    "cti_multilinear_from_evaluations",
]
