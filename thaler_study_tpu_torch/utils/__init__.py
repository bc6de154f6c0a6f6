"""Utilities: field-operation counters."""

from .counters import COUNTS, OpCounts, count_round

__all__ = ["COUNTS", "OpCounts", "count_round"]
