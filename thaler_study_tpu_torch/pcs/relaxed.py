"""The relaxed polynomial commitment scheme (Thaler ch. 7 warm-up).

Counterpart of ``thaler_study_tpu/pcs/relaxed.py``, after
relaxed-pcs/src/lib.rs (excluded from the reference's workspace build —
Cargo.toml:9-10 — but part of the repo's capability surface): the prover
commits to *all* |F|^m evaluations of a multilinear polynomial in a Merkle
tree; the verifier checks a claimed line restriction by opening one
committed point on a random line.

Only sensible for tiny fields (the reference tests use F5 with m=2); the
enumeration cost is inherent to the "relaxed" scheme, not an implementation
limit. The prover's evaluations (``DenseMLE.evaluate_many``: the fold
kernel's evaluation form on the card, one launch) and its SHA-256 tree (``MerkleTree``: the Merkle kernel on the card,
``hashlib`` on the CPU) run on the polynomial's device.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

from ..fields import Felt, FieldConfig
from ..gkr.protocol import line, restrict_poly
from ..mle.dense import DenseMLE
from ..sumcheck.hypercube import FeltRng
from ..sumcheck.univariate import UniPoly
from .merkle import MerkleMultiPath, MerklePath, MerkleTree


class PCSError(Exception):
    """Crate error type (ref relaxed-pcs/src/lib.rs:22-41)."""


class EvalMismatch(PCSError):
    """Evaluation does not match the committed leaf (ref :27-28)."""


class DegreeMismatch(PCSError):
    """Prover claim degree mismatch (ref :39-40)."""


class NoProverPoly(PCSError):
    """Prover has not committed a polynomial (ref :30-31)."""


def all_field_values(field: FieldConfig) -> List[Felt]:
    """The IF trait's value enumeration (ref :47-53)."""
    return [field.felt(v) for v in range(field.p)]


def all_multidimensional_values(field: FieldConfig, m: int) -> List[Tuple[Felt, ...]]:
    """All of F^m in sorted order (ref :55-61 + permutations.rs)."""
    vals = all_field_values(field)
    return [tuple(p) for p in itertools.product(vals, repeat=m)]


class Prover:
    """PCS prover (ref :152-214).

    ``hash_family`` selects the Merkle instantiation — "sha256" (the
    production tree, built on the polynomial's device) or
    "pedersen" (arkworks' Pedersen CRH over JubJub, the reference's own
    config at relaxed-pcs/src/lib.rs:231-284; host-side, anchored to
    tests/data/pedersen_golden.json). The hash family is a type
    parameter in the reference too (``MerkleTree<P: Config>``)."""

    def __init__(self, poly: DenseMLE, hash_family: str = "sha256"):
        self.poly = poly
        field = poly.field
        points = all_multidimensional_values(field, poly.num_vars)
        # one fold chain over all |F|^m points on the polynomial's device
        values = poly.evaluate_many([list(pt) for pt in points])
        # pad to a power of two with zeros (ref :172-177)
        target = 1 << (len(values) - 1).bit_length()
        values = values + [field.zero()] * (target - len(values))
        self.values = values
        self.point_index = {pt: i for i, pt in enumerate(points)}
        if hash_family == "pedersen":
            from .pedersen import PedersenMerkleTree

            self.tree = PedersenMerkleTree(values)
        else:
            self.tree = MerkleTree(values, device=poly.evals.device)

    def merkle_root(self) -> bytes:
        return self.tree.root()

    def poly_restriction_to_line(
        self, b: Sequence[Felt], c: Sequence[Felt]
    ) -> UniPoly:
        """q(t) = poly(l(t)) (ref :202-204, via gkr restrict_poly)."""
        return restrict_poly(b, c, self.poly)

    def challenge(self, point: Sequence[Felt]) -> Tuple[MerklePath, Felt]:
        """Open the committed evaluation at ``point`` (ref :207-213)."""
        idx = self.point_index[tuple(point)]
        return self.tree.generate_proof(idx), self.values[idx]

    def challenge_many(
        self, points: Sequence[Sequence[Felt]]
    ) -> Tuple[MerkleMultiPath, List[Felt]]:
        """Open several committed evaluations in one batched multiproof
        (shared interior siblings emitted once). Leaves are returned in the
        multiproof's sorted-index order."""
        idxs = sorted({self.point_index[tuple(p)] for p in points})
        return self.tree.generate_multi_proof(idxs), [
            self.values[i] for i in idxs
        ]


class Verifier:
    """PCS verifier (ref :65-149)."""

    def __init__(self, num_vars: int, degree: int, merkle_root: bytes):
        self.num_vars = num_vars
        self.degree = degree * num_vars  # ref :89: total degree bound
        self.merkle_root = merkle_root
        self.line: List[UniPoly] = []
        self.x: Felt = None
        self.challenge_point: List[Felt] = []
        self.prover_univariate: UniPoly = None

    def random_line(self, rng: FeltRng, field: FieldConfig):
        """Draw the random challenge line (ref :100-105)."""
        b = [rng.draw(field) for _ in range(self.num_vars)]
        c = [rng.draw(field) for _ in range(self.num_vars)]
        self.line = line(b, c)
        return b, c

    def commited_univariate(self, p: UniPoly) -> None:
        """Receive q with a degree check (ref :108-114) — note the PCS *does*
        enforce the degree bound the sumcheck verifier skips."""
        if p.degree() != self.degree:
            raise DegreeMismatch(
                f"expected degree {self.degree}, got {p.degree()}"
            )
        self.prover_univariate = p

    def challenge_prover(self, rng: FeltRng, field: FieldConfig) -> List[Felt]:
        """Pick x, send the line point l(x) (ref :117-125)."""
        self.x = rng.draw(field)
        self.challenge_point = [l.evaluate(self.x) for l in self.line]
        return list(self.challenge_point)

    def verify_prover_reply(self, path: MerklePath, leaf: Felt) -> None:
        """Verify the Merkle opening and q(x) == leaf (ref :128-148)."""
        if not path.verify(self.merkle_root, leaf):
            raise PCSError("merkle path verification failed")
        if self.prover_univariate is None:
            raise NoProverPoly()
        evaluation = self.prover_univariate.evaluate(self.x)
        if leaf != evaluation:
            raise EvalMismatch(f"{leaf} != {evaluation}")

    def challenge_prover_many(
        self, rng: FeltRng, field: FieldConfig, count: int
    ) -> List[List[Felt]]:
        """Multi-opening: draw ``count`` distinct line parameters x_i and
        return the points l(x_i). Checking q against the commitment at
        several points of the same random line drives the soundness error
        of the line-agreement check down from deg/|F| per the usual
        distance amplification (each x_i is an independent agreement
        test)."""
        xs: List[Felt] = []
        while len(xs) < count:
            x = rng.draw(field)
            if x not in xs:
                xs.append(x)
        self.xs = xs
        self.points_many = [[l.evaluate(x) for l in self.line] for x in xs]
        return [list(p) for p in self.points_many]

    def verify_prover_reply_many(
        self, multi: MerkleMultiPath, leaves: Sequence[Felt]
    ) -> None:
        """Verify a batched opening: one multiproof against the root, then
        q(x_i) == leaf_i for every challenge point."""
        if self.prover_univariate is None:
            raise NoProverPoly()
        if not multi.verify(self.merkle_root, leaves):
            raise PCSError("merkle multiproof verification failed")
        # map committed index -> expected q(x): recompute each point's index
        by_index = {}
        for x, pt in zip(self.xs, self.points_many):
            idx = 0
            for coord in pt:
                idx = idx * coord.field.p + coord.v
            by_index[idx] = self.prover_univariate.evaluate(x)
        for idx, leaf in zip(multi.indices, leaves):
            want = by_index.get(idx)
            if want is None:
                raise PCSError("opened leaf not among the challenge points")
            if leaf != want:
                raise EvalMismatch(f"{leaf} != {want}")
