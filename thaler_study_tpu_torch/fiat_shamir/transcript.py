"""The Fiat-Shamir transform: interactive -> non-interactive.

Mirrors the reference crate exactly (fiat-shamir/src/lib.rs):

- :class:`SumcheckInteractiveProver` / :class:`SumcheckInteractiveVerifier`
  adapt the sumcheck state machines to a byte-message interface
  (ref ``InteractiveProver``/``InteractiveVerifier`` impls :44-66, :151-171).
- :func:`generate_transcript` derives challenge r_j as the hash of the
  *running concatenation* of all serialized prover messages (ref :75-98).
- :func:`verify_transcript` replays the transcript, feeding each derived
  challenge into the unmodified interactive verifier via :class:`RandNums`
  (ref :123-143).

This path is RNG-free and fully deterministic — the bit-exactness anchor
against the Rust reference (SURVEY.md section 3.2). The batched device
prover (``protocols/batched.py``) produces the same bytes.
"""

from __future__ import annotations

from typing import List

from ..fields import Felt, FieldConfig
from ..sumcheck import (
    FinalRound,
    JthRound,
    Prover,
    RandNums,
    Verifier,
)
from .hash_to_field import XmdChain
from .serialize import (
    deserialize_c1_and_poly,
    deserialize_unipoly,
    serialize_c1_and_poly,
    serialize_unipoly,
)


class SerializationError(Exception):
    """Codec error (ref Error::Serialization, fiat-shamir/src/lib.rs:14-16)."""


class SumcheckInteractiveProver:
    """Byte-level adapter over the sumcheck Prover (ref :44-66)."""

    def __init__(self, prover: Prover):
        self.prover = prover

    def g_1(self) -> bytes:
        """Serialized (c_1, g_1) round-0 message (ref :45-53)."""
        p = self.prover.round(self.prover.g.field.one(), 0)
        return serialize_c1_and_poly(self.prover.c_1(), p)

    def round(self, j: int, r_j: Felt) -> bytes:
        return serialize_unipoly(self.prover.round(r_j, j))

    def num_rounds(self) -> int:
        return self.prover.num_vars()


class SumcheckInteractiveVerifier:
    """Byte-level adapter over the sumcheck Verifier (ref :151-171)."""

    def __init__(self, verifier: Verifier, field: FieldConfig):
        self.verifier = verifier
        self.field = field

    def round(self, j: int, g_j_bytes: bytes, rng: RandNums) -> bool:
        try:
            if j == 0:
                c_1, p = deserialize_c1_and_poly(g_j_bytes, self.field)
                self.verifier.set_c_1(c_1)
                self.verifier.round(p, rng)
                return True
            p, offset = deserialize_unipoly(g_j_bytes, 0, self.field)
            if offset != len(g_j_bytes):
                raise SerializationError("trailing bytes")
        except ValueError as e:
            raise SerializationError(str(e)) from e
        res = self.verifier.round(p, rng)
        if isinstance(res, FinalRound):
            return res.accepted
        assert isinstance(res, JthRound)
        return True


class FiatShamirTranscript:
    """The proof object: the list of serialized round messages (ref :69-71).

    """

    def __init__(self, g: List[bytes]):
        self.g = list(g)

    def to_bytes(self) -> bytes:
        import struct

        out = [struct.pack("<Q", len(self.g))]
        for m in self.g:
            out.append(struct.pack("<Q", len(m)))
            out.append(m)
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "FiatShamirTranscript":
        import struct

        (n,) = struct.unpack_from("<Q", data, 0)
        offset = 8
        g = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<Q", data, offset)
            offset += 8
            g.append(data[offset : offset + ln])
            offset += ln
        return cls(g)


def generate_transcript(
    prover, field: FieldConfig, dst: bytes = b""
) -> FiatShamirTranscript:
    """Non-interactive prover run (ref generate_transcript :75-98).

    Challenge r_j = H(g_1 || ... || g_j) over the *running concatenation* of
    serialized messages, with H = DefaultFieldHasher<Sha256>.
    """
    chain = XmdChain(field, dst)
    g_1 = prover.g_1()
    chain.absorb(g_1)
    g = [g_1]
    for j in range(1, prover.num_rounds()):
        r_j = chain.draw(1)[0]
        g_j = prover.round(j, r_j)
        chain.absorb(g_j)
        g.append(g_j)
    return FiatShamirTranscript(g)


def verify_transcript(
    transcript: FiatShamirTranscript,
    verifier,
    field: FieldConfig,
    dst: bytes = b"",
) -> bool:
    """Non-interactive verification (ref verify_transcript :123-143).

    Challenge derivation carries a SHA-256 midstate over the absorbed
    prefix (XmdChain) — O(T) total hashing, byte-identical to the
    reference's full re-hash per round."""
    chain = XmdChain(field, dst)
    for j in range(len(transcript.g)):
        chain.absorb(transcript.g[j])
        r_j = chain.draw(1)[0]
        if not verifier.round(j, transcript.g[j], RandNums([r_j])):
            return False
    return True
