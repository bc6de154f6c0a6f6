"""Fiat-Shamir non-interactive transform (ref: fiat-shamir crate)."""

from .hash_to_field import DefaultFieldHasher, XmdChain, expand_message_xmd
from .serialize import (
    deserialize_c1_and_poly,
    deserialize_unipoly,
    serialize_c1_and_poly,
    serialize_felt,
    serialize_unipoly,
)
from .transcript import (
    FiatShamirTranscript,
    SerializationError,
    SumcheckInteractiveProver,
    SumcheckInteractiveVerifier,
    generate_transcript,
    generate_transcript_device,
    resume_transcript,
    verify_transcript,
)

__all__ = [
    "DefaultFieldHasher",
    "XmdChain",
    "expand_message_xmd",
    "serialize_felt",
    "serialize_unipoly",
    "serialize_c1_and_poly",
    "deserialize_unipoly",
    "deserialize_c1_and_poly",
    "FiatShamirTranscript",
    "SumcheckInteractiveProver",
    "SumcheckInteractiveVerifier",
    "generate_transcript",
    "generate_transcript_device",
    "resume_transcript",
    "verify_transcript",
    "SerializationError",
]
