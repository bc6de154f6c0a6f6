"""Device-backed product polynomials — the production SumCheckPolynomial.

A :class:`ProductPoly` holds dense MLE factor tables (internal MSB-first
order) plus a static :class:`PolySpec`, and implements the
SumCheckPolynomial parity API of the reference — ``evaluate``,
``fix_variables``, ``to_univariate``, ``num_vars``, ``to_evaluations`` —
while its hot path (``round_univariate``) is one round of
``round_kernel.round_step`` per sumcheck round (fold + partial sums; ref hot
loop: matrix-multiplication/src/lib.rs:110-131). Any field of the port;
any spec of up to three blocks (``round_kernel.check_spec``): the product
of the matmul IP, the multi-term LibraW phases of GKR (whose 0-block scalar
tables are carried unchanged through every fold), GKR's dense W and the
triangle IP. :func:`from_jax_state` builds one from the JAX package's
``(spec, tables)`` mid-protocol.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..fields import FArray, Felt, FieldConfig
from ..mle.dense import bitrev_perm
from ..ops.round_kernel import (
    PolySpec,
    fold_step,
    product_evals,
    round_step,
    sum_products,
)
from ..sumcheck.poly import SumCheckPolynomial
from ..sumcheck.univariate import UniPoly, interpolate_at_small_points
from ..utils.counters import count_round


class ProductPoly(SumCheckPolynomial):
    """g(x) = sum over terms of products of dense MLE factors."""

    def __init__(self, spec: PolySpec, tables: Sequence[FArray]):
        self.spec = spec
        self.tables = tuple(tables)
        self._last_uni: Optional[UniPoly] = None

    @property
    def field(self) -> FieldConfig:
        return self.tables[0].field

    def num_vars(self) -> int:
        return self.spec.num_vars()

    def round_degree(self, j: int) -> Optional[int]:
        """Static per-round degree bound from the spec (PolySpec.round_degrees)."""
        degs = self.spec.round_degrees()
        return degs[j] if 0 <= j < len(degs) else None

    # ---- the fused hot path ----
    def round_univariate(
        self, r_prev: Optional[Felt]
    ) -> Tuple[UniPoly, "ProductPoly"]:
        """One prover round: fold r_prev (if any) then produce g_j.

        One round kernel launch; only the (degree+1) partial sums cross
        back to the host, where they are Lagrange-interpolated into the
        (sparse) coefficient-form round polynomial the verifier expects.

        Every round after the first knows its claim c = g_prev(r_prev), so
        the kernel skips the t = 1 product pass and s(1) = c - s(0) —
        exact mod p, round polynomials unchanged.
        """
        spec, tables = self.spec, self.tables
        device = tables[0].device
        claim_known = False
        if r_prev is not None:
            r = FArray.scalar(r_prev, device=device)
            claim = None
            if self._last_uni is not None:
                claim = FArray.scalar(self._last_uni.evaluate(r_prev), device=device)
                claim_known = spec.after_fold().degree() >= 1
            sums, tables = round_step(spec, tables, r, claim=claim)
            spec = spec.after_fold()
        else:
            sums, tables = round_step(spec, tables, None)
        new_poly = ProductPoly(spec, tables)
        count_round(spec, fold=r_prev is not None, claim_known=claim_known)
        uni = interpolate_at_small_points(sums.to_felts(), self.field)
        new_poly._last_uni = uni
        return uni, new_poly

    def sum_evaluations(self) -> Felt:
        """C_1 = sum of g over the hypercube."""
        return sum_products(self.spec, self.tables).item()

    # ---- parity API ----
    def to_univariate(self) -> UniPoly:
        sums, _ = round_step(self.spec, self.tables, None)
        return interpolate_at_small_points(sums.to_felts(), self.field)

    def fix_variables(self, partial_point: Sequence[Felt]) -> "ProductPoly":
        spec, tables = self.spec, self.tables
        device = tables[0].device
        for r in partial_point:
            tables = fold_step(spec, tables, FArray.scalar(r, device=device))
            spec = spec.after_fold()
        return ProductPoly(spec, tables)

    def evaluate(self, point: Sequence[Felt]) -> Optional[Felt]:
        if len(point) != self.num_vars():
            return None
        folded = self.fix_variables(list(point))
        # all tables are scalars now; combine terms on host
        vals = [t.item() for t in folded.tables]
        acc = self.field.zero()
        for term in folded.spec.terms:
            prod = self.field.one()
            for k in term:
                prod = prod * vals[k]
            acc = acc + prod
        return acc

    def to_evaluations(self) -> List[Felt]:
        """Dense evaluations, little-endian (arkworks hypercube) order."""
        flat = product_evals(self.spec, self.tables)
        ints = flat.to_u64()[bitrev_perm(self.num_vars())]
        return [Felt(int(v), self.field) for v in ints]


def from_jax_state(spec, limbs: Sequence[Sequence], field: FieldConfig, cls=None, device="cuda", mesh=None,
                   n_shard=None):
    """The port's polynomial holding a JAX ``ProductPoly``'s state: ``spec``
    (any object with ``block_sizes``, ``table_blocks`` and ``terms``, such
    as the JAX ``PolySpec``) and per table its numpy uint32 limbs (``(lo,
    hi)`` for Goldilocks, ``(mont,)`` for a mont32 field), the JAX 1-D
    internal-order tables. ``cls`` is the class to build (``ProductPoly``
    by default; ``TriangleG``, ``gkr.W``). With ``mesh`` the tables (made
    on ``device``) are sharded over it: ``cls`` a ``parallel``
    ``ShardedBlockPoly`` (the default) or ``ShardedProductPoly``, with
    ``n_shard`` as their ``from_internal_tables`` take it."""
    port_spec = PolySpec(tuple(spec.block_sizes), tuple(map(tuple, spec.table_blocks)), tuple(map(tuple, spec.terms)))
    tables = [FArray.from_jax_limbs(*t, field=field, device=device) for t in limbs]
    if mesh is not None:
        from ..parallel import ShardedBlockPoly, ShardedProductPoly

        cls = cls or ShardedBlockPoly
        if issubclass(cls, ShardedProductPoly):
            return cls.from_internal_tables(tables, mesh, n_shard=n_shard, terms=port_spec.terms)
        return cls.from_internal_tables(port_spec, tables, mesh, n_shard=n_shard)
    return (cls or ProductPoly)(port_spec, tables)
