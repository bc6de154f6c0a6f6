"""One-call convenience API over the protocol stack.

Counterpart of ``thaler_study_tpu/api.py``: build the polynomial, run the
Fiat-Shamir transform, verify. Each call takes ``device`` (``"cuda"`` by
default; ``"cpu"`` runs the plain versions of the kernels). The triangle
IP and GKR entry points are later slices of the port and raise.
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


def run_gkr(circuit, inputs: Sequence, field: FieldConfig = GOLDILOCKS, seed: int = 0, device="cuda"):
    raise NotImplementedError("GKR (host layer and fused device path) is a later slice of the port")


def _index_point(v: int, bits: int, field: FieldConfig) -> List[Felt]:
    """Little-endian boolean point for a matrix index (the reference's
    u32_to_boolean_vec, matrix-multiplication/src/lib.rs:305-313)."""
    return [field.one() if (v >> b) & 1 else field.zero() for b in range(bits)]
