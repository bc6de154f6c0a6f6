"""Device programs of the port: the round kernel, the FS prover and its
SHA-256 chain. CUDA sources live in ``csrc/``; each builds at its first
launch, so importing this package builds nothing."""

from .round_kernel import (
    PolySpec,
    fold_step,
    product_evals,
    round_step,
    sum_products,
)

__all__ = ["PolySpec", "fold_step", "product_evals", "round_step", "sum_products"]
