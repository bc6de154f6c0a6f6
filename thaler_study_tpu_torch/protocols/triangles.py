"""The triangle-counting IP (Thaler ch. 4.3).

Counterpart of ``thaler_study_tpu/protocols/triangles.py``: the
reference's ``G`` polynomial (triangle-counting/src/lib.rs:22-172)

    g(X, Y, Z) = f~_A(X,Y) * f~_A(Y,Z) * f~_A(X,Z)

over 3*log(n) variables; sumcheck over g computes 6 * (number of triangles).
The reference keeps three copies of the adjacency MLE because fixing
variables diverges per factor (:19-21) — here that is the three factor
tables of a 3-block ProductPoly, each folded independently as the protocol
sweeps X, then Y, then Z: the X phase's round sums on the modular matmul
kernel (the contraction f1_t (f3_t @ f2^T)), the Y and Z phases on the
multi-block round kernel (``ops/round_kernel.py``).

Note on orientation: the reference indexes f~_A with X in the *low* bits of
the flattened adjacency matrix (triangle-counting/src/lib.rs:150-157), which
addresses A[y][x]; the adjacency matrix is symmetric so this equals A[x][y].
We reproduce the same convention for transcript parity.
"""

from __future__ import annotations

import numpy as np

from ..fields import FieldConfig
from ..mle.dense import DenseMLE
from ..ops.round_kernel import PolySpec
from .factor_poly import ProductPoly


class TriangleG(ProductPoly):
    """g(X,Y,Z) = f~_A(X,Y) * f~_A(Y,Z) * f~_A(X,Z)."""

    @classmethod
    def new_adj_matrix(cls, num_vars: int, matrix, field: FieldConfig, device="cuda") -> "TriangleG":
        """From a row-major boolean adjacency matrix: a numpy array of any
        shape (read flat, nonzero = edge, with no per-entry Python work) or
        an iterable of booleans.

        ``num_vars`` = 2*log2(n) (the MLE's variable count, as in the
        reference constructor triangle-counting/src/lib.rs:32-51).
        """
        flat = (np.asarray(matrix).reshape(-1) != 0).astype(np.uint64)
        if flat.size != 1 << num_vars:
            raise ValueError(f"a {num_vars}-variable adjacency MLE takes {1 << num_vars} entries, got {flat.size}")
        k = num_vars // 2
        mle = DenseMLE.from_evals_lsb(flat, num_vars, field, device=device)
        spec = PolySpec(
            block_sizes=(k, k, k),
            table_blocks=((0, 1), (1, 2), (0, 2)),
            terms=((0, 1, 2),),
        )
        # three independent factor tables sharing the initial contents
        return cls(spec, (mle.evals, mle.evals, mle.evals))
