"""Protocols over the round kernel: product polynomials and batched proving."""

from .batched import BatchedProductPoly, generate_transcripts_batch
from .factor_poly import ProductPoly

__all__ = ["BatchedProductPoly", "ProductPoly", "generate_transcripts_batch"]
