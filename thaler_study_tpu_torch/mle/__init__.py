"""Multilinear extensions: dense tables in the internal MSB-first order."""

from .dense import DenseMLE, bitrev_perm

__all__ = ["DenseMLE", "bitrev_perm"]
