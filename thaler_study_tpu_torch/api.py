"""One-call convenience API over the protocol stack.

Counterpart of ``thaler_study_tpu/api.py``: build the polynomial, run the
Fiat-Shamir transform, verify. Each call takes ``device`` (``"cuda"`` by
default; ``"cpu"`` runs the plain versions of the kernels). The triangle
IP entry points are the multi-block slice of the port and raise;
``run_gkr`` drives the GKR prover.
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
from .protocols import MatMulG
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


def prove_triangle_count(adjacency, n_nodes: int, field: FieldConfig = GOLDILOCKS, device="cuda"):
    raise NotImplementedError(
        "the triangle IP needs multi-block specs in the round kernel, a later slice of the port"
    )


def verify_triangle_count(adjacency, n_nodes: int, transcript, field: FieldConfig = GOLDILOCKS, device="cuda"):
    raise NotImplementedError(
        "the triangle IP needs multi-block specs in the round kernel, a later slice of the port"
    )


def run_gkr(
    circuit, inputs: Sequence, field: FieldConfig = GOLDILOCKS, seed: int = 0, device="cuda"
) -> Tuple[List[Felt], bool]:
    """Run the full interactive GKR protocol on a circuit, the prover's
    tables on ``device``.

    Returns (claimed_outputs, accepted). The interactive loop mirrors the
    reference's protocol test loop (gkr-protocol/src/lib.rs:551-624); the
    verifier draws from ``SeededRng(seed)``.
    """
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
