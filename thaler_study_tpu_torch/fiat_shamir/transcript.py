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

    def advance(self, r_j: Felt) -> None:
        """Fold a past challenge without computing its round message: the
        cheap path when resuming from a checkpointed transcript
        (``Prover.advance``)."""
        self.prover.advance(r_j)

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


def generate_transcript_device(
    poly,
    field: FieldConfig,
    dst: bytes = b"",
    mesh=None,
    n_shard=None,
) -> FiatShamirTranscript:
    """Non-interactive prover run with the whole proof on the device
    (``ops/fs_kernel.fs_prove_device``: fold, round sums, serialization and
    the SHA-256 challenge chain), byte-identical to
    :func:`generate_transcript`.

    ``poly`` is the SumCheckPolynomial (a ``ProductPoly`` for the device
    path). With ``mesh`` (a ``parallel.Mesh``) the same proof runs sharded
    across the mesh (``ops/fs_kernel.fs_prove_device_sharded``: the
    trailing ``n_shard`` variables of the last block on the mesh, one
    reduction of the round sums per round). Where the device path declines
    (a (spec, field, dst) it does not cover, or a zero coefficient that
    makes message lengths value-dependent) the proof runs the per-round
    loop, as the JAX package does, over a ``parallel.ShardedBlockPoly``
    when a mesh is given: the same bytes. Without ``mesh``, ``n_shard`` is
    ignored, as there.
    """
    from ..ops.fs_kernel import fs_prove_device, fs_prove_device_sharded

    spec = getattr(poly, "spec", None)
    tables = getattr(poly, "tables", None)
    if spec is not None and tables is not None:
        if mesh is not None:
            msgs = fs_prove_device_sharded(spec, tables, mesh, n_shard=n_shard, dst=dst)
        else:
            msgs = fs_prove_device(spec, tables, dst)
        if msgs is not None:
            return FiatShamirTranscript(msgs)
        if mesh is not None:
            # the exact fallback keeps the distributed layout
            from ..parallel import ShardedBlockPoly

            poly = ShardedBlockPoly.from_internal_tables(spec, tables, mesh, n_shard=n_shard)
    return generate_transcript(SumcheckInteractiveProver(Prover(poly)), field, dst)


def resume_transcript(
    prover,
    field: FieldConfig,
    partial: FiatShamirTranscript,
    dst: bytes = b"",
    verify_prefix: bool = False,
) -> FiatShamirTranscript:
    """Resume a non-interactive proof from a partial transcript checkpoint.

    The transcript is the checkpoint format: the challenge stream is
    re-derivable from the recorded messages, so a fresh prover is
    fast-forwarded by folding those challenges (``advance``; no round sums)
    and then produces the remaining rounds, byte-identical to an
    uninterrupted run.

    ``verify_prefix=True`` also recomputes each checkpointed round message
    and checks it against the recorded bytes (it detects a checkpoint that
    does not belong to this prover's inputs, at the cost of re-proving the
    prefix): a mismatch raises :class:`SerializationError`.
    """
    chain = XmdChain(field, dst)
    t = len(partial.g)
    if t == 0:
        return generate_transcript(prover, field, dst)
    if verify_prefix and prover.g_1() != partial.g[0]:
        raise SerializationError("checkpoint prefix mismatch at round 0")
    g = list(partial.g)
    for j in range(t):
        if j >= 1:
            r_j = chain.draw(1)[0]
            if not verify_prefix:
                prover.advance(r_j)
            elif prover.round(j, r_j) != partial.g[j]:
                raise SerializationError(f"checkpoint prefix mismatch at round {j}")
        # round 0 needs no replay: emitting g_1 folds nothing
        chain.absorb(partial.g[j])
    for j in range(t, prover.num_rounds()):
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
