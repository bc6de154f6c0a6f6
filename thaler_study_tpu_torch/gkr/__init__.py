"""The GKR protocol (ref: gkr-protocol crate): the port of
``thaler_study_tpu.gkr`` with its exports (the fused prover and the dense
``W`` included)."""

from .circuit import (
    Circuit,
    CircuitEvaluation,
    CircuitLayer,
    Gate,
    GateType,
    circuit_from_book,
)
from .protocol import (
    Begin,
    FinalRoundMessage,
    GKRError,
    Prover,
    R,
    RoundStarted,
    StartSumCheck,
    SumCheckProverMessage,
    SumCheckRoundResult,
    Verifier,
    WrongVerifierState,
    line,
    restrict_poly,
)
from .fused import generate_gkr_transcript_fused, supports_fused_gkr
from .round_polynomial import W
from .transcript import (
    GKRTranscript,
    deserialize_gkr_message,
    generate_gkr_transcript,
    resume_gkr_transcript,
    serialize_gkr_message,
    verify_gkr_transcript,
)

__all__ = [
    "GKRTranscript",
    "generate_gkr_transcript",
    "generate_gkr_transcript_fused",
    "supports_fused_gkr",
    "verify_gkr_transcript",
    "resume_gkr_transcript",
    "serialize_gkr_message",
    "deserialize_gkr_message",
    "Circuit",
    "CircuitLayer",
    "CircuitEvaluation",
    "Gate",
    "GateType",
    "circuit_from_book",
    "Prover",
    "Verifier",
    "Begin",
    "SumCheckProverMessage",
    "FinalRoundMessage",
    "StartSumCheck",
    "SumCheckRoundResult",
    "RoundStarted",
    "R",
    "line",
    "restrict_poly",
    "W",
    "GKRError",
    "WrongVerifierState",
]
