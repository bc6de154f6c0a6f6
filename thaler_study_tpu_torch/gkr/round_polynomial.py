"""The GKR round polynomial W (ref: gkr-protocol/src/round_polynomial.rs).

Counterpart of ``thaler_study_tpu/gkr/round_polynomial.py``:

    f^(i)_{r_i}(b, c) = add~_i(r_i,b,c) * (W~_{i+1}(b) + W~_{i+1}(c))
                      + mul~_i(r_i,b,c) * (W~_{i+1}(b) * W~_{i+1}(c))

The reference holds 4 dense MLEs and re-evaluates the whole table on a
size-4 FFT domain per round (round_polynomial.rs:78-90). Here W is a
3-term :class:`ProductPoly` over two variable blocks —

    add(b,c)*Wb(b)  +  add(b,c)*Wc(c)  +  mul(b,c)*Wb(b)*Wc(c)

— so every sumcheck round is one launch of the multi-block round kernel,
degree 2 (the true per-variable degree; the reference's 4-point domain
interpolates to the identical coefficient-form polynomial carried on the
wire). The prover takes it with ``gkr.Prover(..., use_linear=False)``.
"""

from __future__ import annotations

from ..mle.dense import DenseMLE
from ..ops.round_kernel import PolySpec
from ..protocols.factor_poly import ProductPoly


class W(ProductPoly):
    """The 2*k_{i+1}-variate polynomial for one GKR layer's sumcheck."""

    @classmethod
    def new(cls, add_i: DenseMLE, mul_i: DenseMLE, w_b: DenseMLE, w_c: DenseMLE) -> "W":
        k = w_b.num_vars
        if w_c.num_vars != k or add_i.num_vars != 2 * k or mul_i.num_vars != 2 * k:
            raise ValueError(
                f"W takes add_i, mul_i over 2k and W_b, W_c over k variables, got "
                f"{add_i.num_vars}, {mul_i.num_vars}, {w_b.num_vars}, {w_c.num_vars}"
            )
        spec = PolySpec(
            block_sizes=(k, k),
            table_blocks=((0, 1), (0, 1), (0,), (1,)),
            terms=((0, 2), (0, 3), (1, 2, 3)),
        )
        return cls(spec, (add_i.evals, mul_i.evals, w_b.evals, w_c.evals))

    @property
    def w_b_num_vars(self) -> int:
        """Where ``evaluate`` splits the point (ref round_polynomial.rs:49)."""
        return self.spec.block_sizes[0] if self.spec.block_sizes else 0
