"""Protocols over the round kernel: product polynomials, batched proving and
the matrix-multiplication IP."""

from .batched import BatchedProductPoly, generate_transcripts_batch
from .factor_poly import ProductPoly
from .matmul import MatMulG

__all__ = ["BatchedProductPoly", "MatMulG", "ProductPoly", "generate_transcripts_batch"]
