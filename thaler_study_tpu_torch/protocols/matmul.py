"""The matrix-multiplication IP (Thaler ch. 4.4).

Counterpart of ``thaler_study_tpu/protocols/matmul.py``: the reference's
``G`` polynomial (matrix-multiplication/src/lib.rs:12-147)

    g(z) = f~_A(r1, z) * f~_B(z, r2)

whose sumcheck proves C[r1][r2] = (A*B)[r1][r2]. Its rounds are the
2-factor single-block product of :class:`ProductPoly`: one round kernel
launch each.
"""

from __future__ import annotations

from typing import Sequence

from ..fields import Felt, FieldConfig
from ..mle.dense import DenseMLE
from ..ops.round_kernel import single_block_spec
from .factor_poly import ProductPoly


class MatMulG(ProductPoly):
    """g(z) = f~_A(r1,z) * f~_B(z,r2) over log(n) variables."""

    @classmethod
    def new(
        cls,
        n: int,
        a,
        b,
        point: Sequence[Felt],
        field: FieldConfig = None,
        device="cuda",
    ) -> "MatMulG":
        """Build g for the (r1, r2) entry of A*B.

        - ``n``: log2 of the matrix dimension (number of z variables).
        - ``a``, ``b``: row-major entries of the two 2^n x 2^n matrices:
          a numpy integer array (taken as it is, with no per-entry Python
          conversion), or ints or Felts.
        - ``point``: (r1, r2) in F^{2n}.

        Mirrors the reference constructor (matrix-multiplication/
        src/lib.rs:77-92): f_a = MLE(a).relabel(0,n,n).fix(r1);
        f_b = MLE(b).fix(r2).
        """
        field = field or point[0].field
        f_a = (
            DenseMLE.from_evals_lsb(a, 2 * n, field, device=device)
            .relabel(0, n, n)
            .fix_variables(list(point[:n]))
        )
        f_b = DenseMLE.from_evals_lsb(b, 2 * n, field, device=device).fix_variables(list(point[n:]))
        return cls(single_block_spec(2, n), (f_a.evals, f_b.evals))
