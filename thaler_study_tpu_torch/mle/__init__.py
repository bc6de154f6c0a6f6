"""Multilinear extensions: dense tables in the internal MSB-first order."""

from .dense import DenseMLE, bitrev, bitrev_perm

__all__ = ["DenseMLE", "bitrev", "bitrev_perm"]
