"""One-call convenience API over the protocol stack.

Counterpart of ``thaler_study_tpu/api.py``: build the polynomial, run the
Fiat-Shamir transform, verify. Each call takes ``device`` (``"cuda"`` by
default; ``"cpu"`` runs the plain versions of the kernels): the matmul
and triangle-counting IPs through the Fiat-Shamir transform, and
``run_gkr`` for the interactive GKR protocol.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .fiat_shamir import (
    FiatShamirTranscript,
    SumcheckInteractiveProver,
    SumcheckInteractiveVerifier,
    generate_transcript,
    verify_transcript,
)
from .fields import GOLDILOCKS, Felt, FieldConfig
from .protocols import MatMulG, TriangleG
from .sumcheck import Prover, Verifier


def prove_matmul_entry(
    n_log: int,
    a,
    b,
    i: int,
    j: int,
    field: FieldConfig = GOLDILOCKS,
    device="cuda",
) -> Tuple[Felt, FiatShamirTranscript]:
    """Non-interactive proof that (A*B)[i][j] equals the returned claim.

    ``a``, ``b``: row-major entries of two 2^n_log x 2^n_log matrices (a
    numpy integer array, or ints or Felts). Returns (claimed_entry,
    transcript).
    """
    point = _index_point(i, n_log, field) + _index_point(j, n_log, field)
    g = MatMulG.new(n_log, a, b, point, field, device=device)
    prover = SumcheckInteractiveProver(Prover(g))
    claim = prover.prover.c_1()
    return claim, generate_transcript(prover, field)


def verify_matmul_entry(
    n_log: int,
    a,
    b,
    i: int,
    j: int,
    transcript: FiatShamirTranscript,
    field: FieldConfig = GOLDILOCKS,
    device="cuda",
) -> bool:
    """Verify a :func:`prove_matmul_entry` transcript (the verifier re-derives
    the oracle polynomial from the public matrices)."""
    point = _index_point(i, n_log, field) + _index_point(j, n_log, field)
    g = MatMulG.new(n_log, a, b, point, field, device=device)
    verifier = SumcheckInteractiveVerifier(Verifier(n_log, g), field)
    return verify_transcript(transcript, verifier, field)


def prove_triangle_count(
    adjacency, n_nodes: int, field: FieldConfig = GOLDILOCKS, device="cuda"
) -> Tuple[int, FiatShamirTranscript]:
    """Non-interactive proof of the triangle count of an undirected graph.

    ``adjacency``: row-major booleans of the n x n symmetric matrix (a
    numpy array, read flat, or an iterable). Returns (6 * triangle_count
    mod p, transcript) — the protocol's 6-Delta convention (Thaler ch. 4.3;
    triangle-counting/src/lib.rs:16-18).
    """
    k = (n_nodes - 1).bit_length()
    g = TriangleG.new_adj_matrix(2 * k, adjacency, field, device=device)
    prover = SumcheckInteractiveProver(Prover(g))
    claim = prover.prover.c_1()
    return claim.v, generate_transcript(prover, field)


def verify_triangle_count(
    adjacency,
    n_nodes: int,
    transcript: FiatShamirTranscript,
    field: FieldConfig = GOLDILOCKS,
    device="cuda",
) -> bool:
    """Verify a :func:`prove_triangle_count` transcript (the verifier
    re-derives the oracle polynomial from the public adjacency matrix)."""
    k = (n_nodes - 1).bit_length()
    g = TriangleG.new_adj_matrix(2 * k, adjacency, field, device=device)
    verifier = SumcheckInteractiveVerifier(Verifier(g.num_vars(), g), field)
    return verify_transcript(transcript, verifier, field)


def run_gkr(
    circuit,
    inputs: Sequence,
    field: FieldConfig = GOLDILOCKS,
    seed: int = 0,
    mesh=None,
    n_shard=None,
    device="cuda",
) -> Tuple[List[Felt], bool]:
    """Run the full interactive GKR protocol on a circuit, the prover's
    tables on ``device``.

    Returns (claimed_outputs, accepted). The interactive loop mirrors the
    reference's protocol test loop (gkr-protocol/src/lib.rs:551-624); the
    verifier draws from ``SeededRng(seed)``. ``mesh`` and ``n_shard`` (a
    sharded prover) are the multi-device slice of the port and raise.
    """
    if mesh is not None or n_shard is not None:
        raise NotImplementedError("a sharded GKR run (mesh=, n_shard=) is the multi-device slice of the port (ROADMAP A7)")
    from .gkr import Prover as GKRProver
    from .gkr import R
    from .gkr import Verifier as GKRVerifier
    from .sumcheck import SeededRng

    felt_inputs = [x if isinstance(x, Felt) else field.felt(int(x)) for x in inputs]
    rng = SeededRng(seed)
    prover = GKRProver(circuit, felt_inputs, field, device=device)
    begin = prover.start_protocol()
    verifier = GKRVerifier(circuit, field)
    r_i = verifier.receive_prover_msg(begin, rng).r
    for i in range(len(circuit.layers)):
        msg = prover.start_round(i, r_i)
        num_vars = 2 * circuit.num_vars_at(i + 1)
        verifier.receive_prover_msg(msg, rng)
        for j in range(num_vars - 1):
            vm = verifier.receive_prover_msg(prover.round_msg(j), rng)
            prover.receive_verifier_msg(vm)
        prover.receive_verifier_msg(verifier.final_random_point(rng))
        vm = verifier.receive_prover_msg(prover.round_msg(num_vars - 1), rng)
        if not isinstance(vm, R):
            raise AssertionError("the verifier did not return the next layer's point")
        r_i = vm.r
    return begin.circuit_outputs, verifier.check_input(felt_inputs)


def _index_point(v: int, bits: int, field: FieldConfig) -> List[Felt]:
    """Little-endian boolean point for a matrix index (the reference's
    u32_to_boolean_vec, matrix-multiplication/src/lib.rs:305-313)."""
    return [field.one() if (v >> b) & 1 else field.zero() for b in range(bits)]
