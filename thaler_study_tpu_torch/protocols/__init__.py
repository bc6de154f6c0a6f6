"""Protocols over the round kernels: product polynomials, batched proving,
the matrix-multiplication IP and the triangle-counting IP."""

from .batched import BatchedProductPoly, generate_transcripts_batch
from .factor_poly import ProductPoly, from_jax_state
from .matmul import MatMulG
from .triangles import TriangleG

__all__ = ["BatchedProductPoly", "MatMulG", "ProductPoly", "TriangleG", "from_jax_state", "generate_transcripts_batch"]
