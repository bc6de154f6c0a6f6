"""The sumcheck Prover and Verifier state machines.

Components #4 and #5 of the reference (sum-check-protocol/src/lib.rs:73-117
and :227-331). The state machines are host-side (they hold O(n) state and do
O(d) field ops per round); the polynomial they drive may keep its tables on
device, in which case each ``round`` call launches exactly one fused round
kernel (fold previous challenge + compute the round's partial sums).
"""

from __future__ import annotations

import dataclasses
from typing import Generic, List, Optional, TypeVar, Union

from ..fields import Felt
from .hypercube import FeltRng
from .poly import SumCheckPolynomial
from .univariate import UniPoly

P = TypeVar("P", bound=SumCheckPolynomial)


class SumCheckError(Exception):
    """Base error (reference Error enum, sum-check-protocol/src/lib.rs:24-31)."""


class ProverClaimMismatch(SumCheckError):
    """g_{j-1}(r_{j-1}) != g_j(0) + g_j(1) (ref :26-27)."""

    def __init__(self, expected, got):
        super().__init__(f"prover claim mismatches evaluation {expected} {got}")
        self.expected = expected
        self.got = got


class NoPolySet(SumCheckError):
    """Verifier has no oracle access to the polynomial (ref :29-30)."""


@dataclasses.dataclass
class JthRound:
    """Round result carrying the verifier's random challenge r_j."""

    r: Felt


@dataclasses.dataclass
class FinalRound:
    """Final round result: accept (True) or reject (False)."""

    accepted: bool


VerifierRoundResult = Union[JthRound, FinalRound]


class Prover(Generic[P]):
    """Sumcheck prover: claims C_1 = sum of g over the hypercube, then per
    round sends the univariate g_j (ref :73-117)."""

    def __init__(self, g: P):
        self.g = g
        self._num_vars = g.num_vars()
        # C_1 = sum over the hypercube. Device-backed polynomials compute
        # this with one reduction kernel via their `sum_evaluations` if
        # available; the generic path materializes evaluations (ref :89).
        if hasattr(g, "sum_evaluations"):
            self.c_1_value = g.sum_evaluations()
        else:
            evals = g.to_evaluations()
            acc = g.field.zero()
            for e in evals:
                acc = acc + e
            self.c_1_value = acc
        self.r: List[Felt] = []

    def c_1(self) -> Felt:
        return self.c_1_value

    def num_vars(self) -> int:
        return self._num_vars

    def round(self, r_prev: Felt, j: int) -> UniPoly:
        """Perform round j: fold in the previous challenge (j > 0), then
        produce g_j (ref :105-112). Device-backed polynomials fuse both into
        a single round kernel launch via `round_univariate`."""
        if j != 0:
            self.r.append(r_prev)
            if hasattr(self.g, "round_univariate"):
                g_j, self.g = self.g.round_univariate(r_prev)
                return g_j
            self.g = self.g.fix_variables([r_prev])
        elif hasattr(self.g, "round_univariate"):
            g_j, self.g = self.g.round_univariate(None)
            return g_j
        return self.g.to_univariate()

    def advance(self, r_prev: Optional[Felt]) -> None:
        """Apply ``round``'s state transition without computing the round
        polynomial — the cheap fast-forward used when resuming from a
        checkpointed transcript (the challenge stream is re-derivable, so
        only the folds need replaying; SURVEY.md section 5).

        ``r_prev=None`` replays round 0 (which folds nothing but may bump
        stateful polynomials like gkr.linear.LibraW)."""
        if r_prev is None:
            if hasattr(self.g, "advance"):
                self.g = self.g.advance(None)
            return
        self.r.append(r_prev)
        if hasattr(self.g, "advance"):
            self.g = self.g.advance(r_prev)
        else:
            self.g = self.g.fix_variables([r_prev])


class Verifier(Generic[P]):
    """Sumcheck verifier (ref :227-331).

    ``g`` is the optional oracle; with ``None`` the final round raises
    :class:`NoPolySet` (GKR injects None and replaces the oracle check with
    its own final round — gkr-protocol/src/lib.rs:92).

    Note: like the reference, no degree bound is enforced on incoming g_j
    (a documented fidelity gap of the reference; see SURVEY.md #5).
    """

    def __init__(
        self,
        n: int,
        g: Optional[P] = None,
        max_degree: Optional[int] = None,
        strict: bool = False,
    ):
        self.n = n
        self.c_1: Optional[Felt] = None
        self.g_part: List[UniPoly] = []
        self.r: List[Felt] = []
        self.g = g
        # Optional strict mode: the reference never bounds deg(g_j) (its
        # documented soundness gap); passing max_degree enforces it. Under
        # ``strict`` the bound is also self-derived per round from the
        # oracle's static structure (SumCheckPolynomial.round_degree), so a
        # strict verifier with an oracle needs no extra arguments.
        self.max_degree = max_degree
        # ``strict`` additionally closes the reference's missing FINAL-round
        # sum-consistency check (ref :298-310 only tests the oracle
        # evaluation; a cheating prover who can predict r_n — e.g. under a
        # seeded rng — could send g_n with the right g_n(r_n) but an
        # inconsistent g_n(0) + g_n(1)). Default mode stays
        # behavior-identical to the reference.
        self.strict = strict

    def set_c_1(self, c_1: Felt):
        self.c_1 = c_1

    def _round_degree_bound(self) -> Optional[int]:
        """The deg(g_j) bound for the upcoming round: an explicit
        ``max_degree`` wins; otherwise strict mode asks the oracle's static
        structure (round_degree) — None when neither is available."""
        if self.max_degree is not None:
            return self.max_degree
        if self.strict and self.g is not None:
            rd = getattr(self.g, "round_degree", None)
            if rd is not None:
                return rd(len(self.r))
        return None

    def round(self, g_j: UniPoly, rng: FeltRng) -> VerifierRoundResult:
        bound = self._round_degree_bound()
        if bound is not None and g_j.degree() > bound:
            raise ProverClaimMismatch(
                f"degree bound {bound}", f"degree {g_j.degree()}"
            )
        field = g_j.field if not g_j.is_zero() else (
            self.c_1.field if self.c_1 is not None else g_j.field
        )
        r_j = rng.draw(field)
        zero, one = field.zero(), field.one()

        if not self.r:
            # first round: C_1 = g_1(0) + g_1(1) (ref :284-297)
            evaluation = g_j.evaluate(zero) + g_j.evaluate(one)
            if self.c_1 != evaluation:
                raise ProverClaimMismatch(f"start {self.c_1}", f"{evaluation}")
            self.g_part.append(g_j)
            self.r.append(r_j)
            return JthRound(r_j)

        if len(self.r) == self.n - 1:
            # last round: oracle check g_n(r_n) = g(r_1..r_n) (ref :298-310)
            if self.strict and self.g_part:
                # strict mode: the sum-consistency check the reference
                # omits in its final round
                prev_evaluation = self.g_part[-1].evaluate(self.r[-1])
                evaluation = g_j.evaluate(zero) + g_j.evaluate(one)
                if prev_evaluation != evaluation:
                    raise ProverClaimMismatch(
                        f"final-round {prev_evaluation}", f"{evaluation}"
                    )
            self.r.append(r_j)
            if self.g is None:
                raise NoPolySet()
            oracle = self.g.evaluate(self.r)
            return FinalRound(g_j.evaluate(r_j) == oracle)

        # middle rounds: g_{j-1}(r_{j-1}) = g_j(0) + g_j(1) (ref :311-329)
        prev_evaluation = self.g_part[-1].evaluate(self.r[-1])
        evaluation = g_j.evaluate(zero) + g_j.evaluate(one)
        if prev_evaluation != evaluation:
            raise ProverClaimMismatch(f"{prev_evaluation}", f"{evaluation}")
        self.g_part.append(g_j)
        self.r.append(r_j)
        return JthRound(r_j)
