"""The GKR protocol: Prover/Verifier state machines and the message types.

Counterpart of ``thaler_study_tpu/gkr/protocol.py`` (ref:
gkr-protocol/src/lib.rs). The wire boundary is the ProverMessage /
VerifierMessage types (ref :222-275); the verifier is a state machine over
an inner sumcheck (ref :38-218); the prover runs one inner sumcheck per
layer (ref :324-474) over the linear-time LibraW polynomial, with the
circuit's forward pass and every table on the prover's device; the final
claim reduction uses the line trick (ref :139-174) with ``line`` and
``restrict_poly`` (ref :278-321).

The dense-W formulation (``use_linear=False``: :class:`round_polynomial.W`,
a two-block spec on the multi-block round kernel) gives the same
transcripts; ``mesh=`` shards each LibraW layer's tables over a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .. import runtime
from ..fields import FArray, Felt, FeltVector, FieldConfig
from ..fields.farray import resolve_device
from ..mle.dense import DenseMLE
from ..sumcheck import (
    FeltRng,
    JthRound,
    Prover as SumCheckProver,
    UniPoly,
    Verifier as SumCheckVerifier,
    VerifierRoundResult,
    lagrange_interpolate,
)
from .circuit import Circuit, CircuitEvaluation
from .linear import LibraW
from .round_polynomial import W


class GKRError(Exception):
    """GKR error type (ref :27-32)."""


class WrongVerifierState(GKRError):
    """Verifier is in the wrong state (ref :29-31)."""


# ---------- messages (the wire boundary) ----------


@dataclasses.dataclass
class Begin:
    """Prover's opening claim about the circuit outputs (ref :246-249)."""

    circuit_outputs: List[Felt]  # or FeltVector (bulk-int backed)


@dataclasses.dataclass
class SumCheckProverMessage:
    """One inner-sumcheck round polynomial (ref :250-254)."""

    p: UniPoly


@dataclasses.dataclass
class FinalRoundMessage:
    """Last round: the round poly plus the line restriction q (ref :255-263)."""

    p: UniPoly
    q: UniPoly


@dataclasses.dataclass
class StartSumCheck:
    """Start the layer-i sumcheck (ref :264-275)."""

    c_1: Felt
    round: int
    num_vars: int


@dataclasses.dataclass
class SumCheckRoundResult:
    """Verifier: result of one inner sumcheck step (ref :223-227)."""

    res: VerifierRoundResult


@dataclasses.dataclass
class RoundStarted:
    """Verifier: the j-th round has started (ref :232-233)."""

    round: int


@dataclasses.dataclass
class R:
    """Verifier: the next layer's random point r_i (ref :235-239)."""

    r: List[Felt]


# ---------- line and restriction ----------


def line(b: Sequence[Felt], c: Sequence[Felt]) -> List[UniPoly]:
    """The unique line l with l(0) = b, l(1) = c: l_i(t) = b_i + (c_i - b_i) t
    (ref :278-284)."""
    field = b[0].field
    return [UniPoly([(0, bi), (1, ci - bi)], field) for bi, ci in zip(b, c)]


def restrict_poly(b: Sequence[Felt], c: Sequence[Felt], mle: DenseMLE) -> UniPoly:
    """Restrict the MLE to the line through b and c: q(t) = W~(l(t)).

    q has degree <= n, so W~ is evaluated at the n + 1 line points l(0..n)
    in one ``evaluate_many`` on the table's device (one launch of the fold
    kernel's evaluation form on the card) and
    Lagrange-interpolated (the same coefficients as the reference's
    product expansion, ref :291-321)."""
    field = b[0].field
    n = mle.num_vars
    ls = line(b, c)
    t_felts = [field.felt(t) for t in range(n + 1)]
    points = [[l.evaluate(t_f) for l in ls] for t_f in t_felts]
    values = mle.evaluate_many(points)
    return lagrange_interpolate(list(zip(t_felts, values)), field)


def _mle_eval(evals, point: Sequence[Felt], field: FieldConfig) -> Felt:
    """The MLE of a value vector at a field point, on the host runtime.
    ``evals``: a list of Felts or a FeltVector (read in bulk)."""
    if len(evals) != 1 << len(point):
        raise ValueError(f"{len(evals)} values for a {len(point)}-variable MLE")
    ints = evals.ints if isinstance(evals, FeltVector) else [e.v for e in evals]
    return Felt(runtime.mle_eval(ints, [x.v for x in point], field.p), field)


# ---------- Prover ----------


def _input_values(inputs, field: FieldConfig):
    """Felts, ints or a numpy integer array -> what FArray.from_ints takes."""
    if isinstance(inputs, np.ndarray):
        return inputs
    if isinstance(inputs, FeltVector):
        return np.asarray(inputs.ints, dtype=np.uint64)
    return [f.v if isinstance(f, Felt) else int(f) % field.p for f in inputs]


class Prover:
    """GKR prover (ref :324-474).

    The circuit's forward pass runs on ``device`` (``Circuit.evaluate_device``)
    and each layer's sumcheck runs over the linear-time LibraW polynomial
    (or, with ``use_linear=False``, the reference's dense W over two blocks
    of 2k variables), whose tables stay there. ``device="cpu"`` runs the
    plain versions of the kernels. Both give the same transcripts. With
    ``mesh`` (a ``parallel`` mesh) each LibraW layer's tables are sharded
    over it, ``n_shard`` variables (default log2 of the mesh size), as in
    the JAX package; the dense W is not sharded, as there.
    """

    def __init__(
        self,
        circuit: Circuit,
        inputs,
        field: FieldConfig,
        use_linear: bool = True,
        mesh=None,
        n_shard=None,
        device="cuda",
    ):
        self.circuit = circuit
        self.mesh = mesh
        self.n_shard = n_shard
        self.field = field
        self.use_linear = use_linear
        self.device = resolve_device(device)
        inp = FArray.from_ints(_input_values(inputs, field), field, device=self.device)
        self.layers_dev = circuit.evaluate_device(inp)  # label order
        self._layers_host_cache: dict = {}
        self.i = 0
        self.prover: Optional[SumCheckProver] = None
        self.w: Optional[DenseMLE] = None
        self.r: List[Felt] = []

    def _layer_host(self, i: int) -> np.ndarray:
        """Layer i's values as a host uint64 array (pulled once)."""
        if i not in self._layers_host_cache:
            self._layers_host_cache[i] = self.layers_dev[i].to_u64()
        return self._layers_host_cache[i]

    @property
    def evaluation(self) -> CircuitEvaluation:
        """Felt view of the per-layer values (reference-compatible)."""
        n_layers = len(self.circuit.layers) + 1
        return CircuitEvaluation(
            [[Felt(int(v), self.field) for v in self._layer_host(i)] for i in range(n_layers)]
        )

    def start_protocol(self) -> Begin:
        """Send W_0, the claimed output values (ref :363-367)."""
        return Begin(circuit_outputs=FeltVector(self._layer_host(0), self.field))

    def start_round(self, i: int, r_i: Sequence[Felt]) -> StartSumCheck:
        """Spin up the layer-i sumcheck over W (ref :373-436)."""
        num_vars_next = self.circuit.num_vars_at(i + 1)
        if self.use_linear:
            w = LibraW(self.circuit, i, list(r_i), self.layers_dev[i + 1], self.field, mesh=self.mesh,
                       n_shard=self.n_shard)
            self.w = DenseMLE.from_evals_msb(w._w_msb, num_vars_next)
        else:
            self.w = DenseMLE.from_evals_lsb_farray(self.layers_dev[i + 1], num_vars_next)
            add_i = self.circuit.add_i_ext(list(r_i), i, device=self.device)
            mul_i = self.circuit.mul_i_ext(list(r_i), i, device=self.device)
            w = W.new(add_i, mul_i, self.w, self.w)
        self.i = i
        self.prover = SumCheckProver(w)
        self.r = []
        return StartSumCheck(c_1=self.prover.c_1(), round=i, num_vars=2 * num_vars_next)

    def round_msg(self, j: int):
        """Inner sumcheck step j (ref :439-456)."""
        last = 2 * self.circuit.num_vars_at(self.i + 1) - 1
        if j == last:
            b = self.r[: len(self.r) // 2]
            c = self.r[len(self.r) // 2 :]
            q = restrict_poly(b, c, self.w)
            p = self.prover.round(self.r[j - 1], j)
            return FinalRoundMessage(p=p, q=q)
        point = self.field.one() if j == 0 else self.r[j - 1]
        return SumCheckProverMessage(p=self.prover.round(point, j))

    def receive_verifier_msg(self, msg) -> None:
        """Collect inner-sumcheck challenges (ref :459-468)."""
        if isinstance(msg, SumCheckRoundResult):
            if isinstance(msg.res, JthRound):
                self.r.append(msg.res.r)
            else:
                raise GKRError("unexpected FinalRound from inner verifier")

    def c_1(self) -> Felt:
        return self.prover.c_1()


# ---------- Verifier ----------


class _RunningSumCheck:
    """Inner-sumcheck state. The wiring predicates are kept symbolically
    (layer + r_i) and evaluated sparsely at the final bc point in O(gates)
    on the host runtime."""

    def __init__(self, verifier: SumCheckVerifier, layer_i: int, r_i: List[Felt]):
        self.bc: List[Felt] = []
        self.verifier = verifier
        self.layer_i = layer_i
        self.r_i = r_i


class Verifier:
    """GKR verifier (ref :38-218), host code.

    ``strict`` closes the reference's two documented soundness gaps (the
    unchecked degree of q, ref TODO at gkr-protocol/src/lib.rs:149-151, and
    the inner sumcheck's degree bound and final-round sum consistency).
    The default mode behaves as the reference.
    """

    def __init__(self, circuit: Circuit, field: FieldConfig, strict: bool = False):
        self.circuit = circuit
        self.field = field
        self.r: List[List[Felt]] = []
        self.m: List[Felt] = []
        self.state: Optional[_RunningSumCheck] = None
        self.strict = strict

    def receive_prover_msg(self, msg, rng: FeltRng):
        if isinstance(msg, SumCheckProverMessage):
            return self._sum_check_step(msg.p, rng)
        if isinstance(msg, StartSumCheck):
            return self._start_round(msg.c_1, msg.round, msg.num_vars)
        if isinstance(msg, FinalRoundMessage):
            return self._final_round_message(msg.p, msg.q, rng)
        if isinstance(msg, Begin):
            return self._begin(msg.circuit_outputs, rng)
        raise GKRError(f"unknown prover message {type(msg)}")

    def _begin(self, circuit_outputs, rng: FeltRng) -> R:
        num_output_vars = self.circuit.num_vars_at(0)
        r_zero = [rng.draw(self.field) for _ in range(num_output_vars)]
        m_zero = _mle_eval(circuit_outputs, r_zero, self.field)
        self.r = [r_zero]
        self.m = [m_zero]
        return R(r=r_zero)

    def _start_round(self, c_1: Felt, round_i: int, num_vars: int) -> RoundStarted:
        """An oracle-less inner verifier (ref :89-105); the wiring predicates
        are evaluated sparsely at the end."""
        verifier = SumCheckVerifier(num_vars, None, max_degree=2 if self.strict else None, strict=self.strict)
        verifier.set_c_1(c_1)
        self.state = _RunningSumCheck(verifier, round_i, list(self.r[-1]))
        return RoundStarted(round_i)

    def _wiring_at(self, st: _RunningSumCheck) -> tuple:
        """add~(r_i, b*, c*) and mul~(r_i, b*, c*) in O(gates)."""
        p = self.field.p
        half = len(st.bc) // 2
        eq_r = runtime.eq_table([f.v for f in st.r_i], p)
        eq_b = runtime.eq_table([f.v for f in st.bc[:half]], p)
        eq_c = runtime.eq_table([f.v for f in st.bc[half:]], p)
        b_idx, c_idx, is_mul = self.circuit._wiring[st.layer_i]
        add_val = runtime.wiring_eval_sparse(eq_r[: len(b_idx)], eq_b, eq_c, b_idx, c_idx, ~is_mul, p)
        mul_val = runtime.wiring_eval_sparse(eq_r[: len(b_idx)], eq_b, eq_c, b_idx, c_idx, is_mul, p)
        return Felt(add_val, self.field), Felt(mul_val, self.field)

    def _sum_check_step(self, p: UniPoly, rng: FeltRng) -> SumCheckRoundResult:
        if self.state is None:
            raise WrongVerifierState()
        res = self.state.verifier.round(p, rng)
        if isinstance(res, JthRound):
            self.state.bc.append(res.r)
        return SumCheckRoundResult(res=res)

    def final_random_point(self, rng: FeltRng) -> SumCheckRoundResult:
        """Draw the last inner challenge directly (ref :108-119)."""
        if self.state is None:
            raise WrongVerifierState()
        final_point = rng.draw(self.field)
        self.state.bc.append(final_point)
        return SumCheckRoundResult(res=JthRound(final_point))

    def _final_round_message(self, p: UniPoly, q: UniPoly, rng: FeltRng) -> R:
        """Check add~(bc)(q(0) + q(1)) + mul~(bc) q(0) q(1) == p(r_last), then
        reduce two claims to one by the line trick (ref :139-174)."""
        if self.state is None:
            raise WrongVerifierState()
        st = self.state
        zero, one = self.field.zero(), self.field.one()
        if self.strict:
            k = len(st.bc) // 2
            if q.degree() > k:
                raise GKRError(f"strict: deg(q) = {q.degree()} exceeds the line-restriction bound {k}")
            inner = st.verifier
            if inner.g_part:
                prev = inner.g_part[-1].evaluate(inner.r[-1])
                if prev != p.evaluate(zero) + p.evaluate(one):
                    raise GKRError("strict: final-round sum consistency failed")
            if p.degree() > 2:
                raise GKRError(f"strict: deg(p) = {p.degree()} exceeds the W-round bound 2")
        q_0, q_1 = q.evaluate(zero), q.evaluate(one)
        add_at_bc, mul_at_bc = self._wiring_at(st)
        evaluation = add_at_bc * (q_0 + q_1) + mul_at_bc * (q_0 * q_1)
        if evaluation != p.evaluate(st.bc[-1]):
            raise GKRError(f"final round check failed: {evaluation} != p(r_last)")
        r_star = rng.draw(self.field)
        half = len(st.bc) // 2
        l = line(st.bc[:half], st.bc[half:])
        r_next = [li.evaluate(r_star) for li in l]
        self.r.append(r_next)
        self.m.append(q.evaluate(r_star))
        self.state = None
        return R(r=r_next)

    def check_input(self, inputs) -> bool:
        """Final check m_d == W~_input(r_d) (ref :210-217)."""
        if isinstance(inputs, np.ndarray):
            inputs = FeltVector(np.ascontiguousarray(inputs, dtype=np.uint64) % np.uint64(self.field.p), self.field)
        elif not isinstance(inputs, FeltVector):
            inputs = [x if isinstance(x, Felt) else self.field.felt(int(x)) for x in inputs]
        return _mle_eval(inputs, self.r[-1], self.field) == self.m[-1]
