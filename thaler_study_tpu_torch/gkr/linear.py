"""Linear-time GKR layer sumcheck (Libra-style bookkeeping tables).

Counterpart of ``thaler_study_tpu/gkr/linear.py``, device-tables branch
(the shipped default). The layer claim

    sum_{b,c} [ add~(r,b,c) (W(b) + W(c)) + mul~(r,b,c) W(b) W(c) ]

is proven in two phases of k rounds each (the Libra algorithm, Xie et al.
2019):

- phase 1 (rounds over b): h(b) = W(b) A1(b) + A2(b), with A1 and A2 the
  phase-1 tables of ``device_tables.phase1_tables``;
- phase 2 (rounds over c, b fixed at u): f(u, c) = B1(c) w_u + B1(c) W(c)
  + B2(c) w_u W(c), with w_u = W~(u) a 0-block scalar table.

Each round is one launch of the round kernel's LibraW shapes
(``ops/cuda_round.LIBRA_PHASE1`` / ``LIBRA_PHASE2``). The transcript is
the same as the dense-W formulation's; the multi-block dense ``W`` and
``mesh=`` are later slices of the port and raise.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..fields import FArray, Felt, FieldConfig
from ..ops.round_kernel import PolySpec
from ..protocols.factor_poly import ProductPoly
from ..sumcheck.univariate import UniPoly
from .circuit import Circuit
from .device_tables import lsb_to_msb, phase1_tables, phase2_tables


class LibraW:
    """The layer-i GKR round polynomial, proven in linear time.

    Implements the sumcheck hot-path interface (``round_univariate``,
    ``advance``, ``sum_evaluations``) that ``sumcheck.Prover`` drives.
    ``w_next`` is layer i+1's values in label order, an FArray on the
    device the tables are built on.
    """

    def __init__(
        self,
        circuit: Circuit,
        layer_i: int,
        r_i: List[Felt],
        w_next: FArray,
        field: FieldConfig,
        mesh=None,
        n_shard=None,
    ):
        if mesh is not None or n_shard is not None:
            raise NotImplementedError(
                "a sharded GKR layer (mesh=) is the multi-device slice of the port (ROADMAP A9)"
            )
        if not isinstance(w_next, FArray):
            raise TypeError("w_next must be the layer's values as an FArray (label order)")
        self.field = field
        k = circuit.num_vars_at(layer_i + 1)
        k_cur = circuit.num_vars_at(layer_i)
        self.k = k
        self.j = 0  # next round index (0..2k-1)
        self.u: List[Felt] = []  # phase-1 challenges
        self._w_lsb = w_next
        self._wiring = circuit.device_wiring(layer_i, w_next.device)
        r_arr = FArray.from_ints([f.v for f in r_i], field, device=w_next.device)
        a1, a2, self._eq_r = phase1_tables(r_arr, w_next, self._wiring, k_cur, k)
        self._w_msb = lsb_to_msb(w_next, k)
        spec = PolySpec(block_sizes=(k,), table_blocks=((0,), (0,), (0,)), terms=((0, 1), (2,)))
        self._inner = ProductPoly(spec, (self._w_msb, a1, a2))

    def num_vars(self) -> int:
        return 2 * self.k

    def sum_evaluations(self) -> Felt:
        return self._inner.sum_evaluations()

    def _enter_phase2(self, r_last: Felt) -> None:
        self.u.append(r_last)
        u_arr = FArray.from_ints([f.v for f in self.u], self.field, device=self._w_lsb.device)
        b1, b2, w_u = phase2_tables(u_arr, self._w_lsb, self._eq_r, self._wiring, self.k)
        spec = PolySpec(
            block_sizes=(self.k,),
            table_blocks=((0,), (0,), (0,), ()),
            terms=((0, 3), (0, 2), (1, 3, 2)),
        )
        self._inner = ProductPoly(spec, (b1, b2, self._w_msb, w_u))

    def round_univariate(self, r_prev: Optional[Felt]) -> Tuple[UniPoly, "LibraW"]:
        j = self.j
        self.j += 1
        if j == 0:
            uni, self._inner = self._inner.round_univariate(None)
            return uni, self
        if j < self.k:
            self.u.append(r_prev)
            uni, self._inner = self._inner.round_univariate(r_prev)
            return uni, self
        if j == self.k:
            # r_prev completes u; the phase-1 tables are dropped without a
            # last fold: phase 2 is built from u and starts with no fold
            self._enter_phase2(r_prev)
            uni, self._inner = self._inner.round_univariate(None)
            return uni, self
        uni, self._inner = self._inner.round_univariate(r_prev)
        return uni, self

    def advance(self, r_prev: Optional[Felt]) -> "LibraW":
        """``round_univariate``'s state transition without the round sums:
        the checkpoint-resume fast-forward (folds and the phase switch)."""
        j = self.j
        self.j += 1
        if j == 0:
            if r_prev is not None:
                raise ValueError("round 0 takes no challenge")
            return self
        if j < self.k:
            self.u.append(r_prev)
            self._inner = self._inner.fix_variables([r_prev])
            return self
        if j == self.k:
            self._enter_phase2(r_prev)
            return self
        self._inner = self._inner.fix_variables([r_prev])
        return self
