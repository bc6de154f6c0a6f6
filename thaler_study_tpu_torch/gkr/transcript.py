"""Non-interactive GKR: serialized message log + Fiat-Shamir challenges,
with checkpoint/resume.

Counterpart of ``thaler_study_tpu/gkr/transcript.py``, host code for any
DST: the same message codecs (the bulk ``Begin`` codec included), the same
challenge chain and the same bytes. The original notes follow.

The reference has NO serialization or non-interactive transform for GKR —
its ProverMessage/VerifierMessage enums live in one address space
(gkr-protocol/src/lib.rs:222-275), and its Fiat-Shamir crate covers plain
sumcheck only (fiat-shamir/src/lib.rs). This module is the framework-native
extension of the reference's FS construction to the full GKR protocol
(VERDICT r1 next-round #8): the byte formats reuse the arkworks canonical
layouts of ``fiat_shamir.serialize`` and the challenge derivation reuses
``DefaultFieldHasher<Sha256>`` over the running concatenation of all
serialized messages, exactly like fiat-shamir/src/lib.rs:75-98.

Wire format (framework-defined; 1-byte tag + ark-style payload):

  0x00 Begin              u64-LE count, then count field elements
  0x01 StartSumCheck      c_1 felt, u64-LE layer index, u64-LE num_vars
  0x02 SumCheckProverMsg  SparsePolynomial (u64-LE len, (u64-LE deg, felt)*)
  0x03 FinalRoundMessage  two SparsePolynomials p, q

Challenge schedule (each drawn from H(all messages so far); multiple
challenges needed at one position are drawn with a single
``hash_to_field(count=n)`` call so they are independent):

  after Begin:                       count = k_0       -> r_0
  after inner message j < last-1:    count = 1         -> r_j
  after inner message j = last-1:    count = 2         -> r_{last-1}, r_last
                                     (r_last is the verifier-drawn "final
                                      random point", ref lib.rs:108-119)
  after FinalRoundMessage:           count = 1         -> r* (line trick)

The transcript doubles as the checkpoint format: every challenge is
re-derivable from the message prefix, so :func:`resume_gkr_transcript`
fast-forwards a fresh prover with fold-only ``advance`` steps (no round-sum
recomputation) and continues producing byte-identical messages — mirroring
``fiat_shamir.resume_transcript`` semantics.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from ..fiat_shamir.hash_to_field import XmdChain
from ..fiat_shamir.serialize import (
    deserialize_felt,
    deserialize_unipoly,
    serialize_felt,
    serialize_unipoly,
)
from ..fiat_shamir.transcript import FiatShamirTranscript, SerializationError
from ..fields import Felt, FeltVector, FieldConfig
from ..sumcheck import JthRound, RandNums
from .protocol import (
    Begin,
    FinalRoundMessage,
    Prover,
    R,
    StartSumCheck,
    SumCheckProverMessage,
    SumCheckRoundResult,
    Verifier,
    line,
)

_TAG_BEGIN = 0
_TAG_START = 1
_TAG_SUMCHECK = 2
_TAG_FINAL = 3


# ---------------------------------------------------------------------------
# message codecs
# ---------------------------------------------------------------------------


def serialize_gkr_message(msg) -> bytes:
    if isinstance(msg, Begin):
        outs = msg.circuit_outputs
        header = bytes([_TAG_BEGIN]) + struct.pack("<Q", len(outs))
        if len(outs):
            field_ = (
                outs.field if isinstance(outs, FeltVector) else outs[0].field
            )
            size = field_.byte_size
            if size <= 8:
                # bulk LE encode: at a 2^20-output layer this message is
                # megabytes; per-felt to_bytes calls dominate otherwise
                vals = np.asarray(
                    outs.ints
                    if isinstance(outs, FeltVector)
                    else [f.v for f in outs],
                    dtype=np.uint64,
                )
                body = (
                    vals.astype("<u8").tobytes()
                    if size == 8
                    else np.ascontiguousarray(
                        vals.astype("<u8").view(np.uint8).reshape(-1, 8)[
                            :, :size
                        ]
                    ).tobytes()
                )
                return header + body
        return header + b"".join(serialize_felt(f) for f in outs)
    if isinstance(msg, StartSumCheck):
        return (
            bytes([_TAG_START])
            + serialize_felt(msg.c_1)
            + struct.pack("<QQ", msg.round, msg.num_vars)
        )
    if isinstance(msg, SumCheckProverMessage):
        return bytes([_TAG_SUMCHECK]) + serialize_unipoly(msg.p)
    if isinstance(msg, FinalRoundMessage):
        return (
            bytes([_TAG_FINAL])
            + serialize_unipoly(msg.p)
            + serialize_unipoly(msg.q)
        )
    raise SerializationError(f"unknown GKR prover message {type(msg)}")


def deserialize_gkr_message(data: bytes, field: FieldConfig):
    if not data:
        raise SerializationError("empty GKR message")
    tag = data[0]
    if tag == _TAG_BEGIN:
        (n,) = struct.unpack_from("<Q", data, 1)
        size = field.byte_size
        if size <= 8:
            # bulk LE decode (see serialize_gkr_message): one numpy pass
            # instead of n per-felt python calls
            if len(data) != 9 + n * size:
                raise SerializationError("trailing bytes in Begin")
            raw = np.frombuffer(data, dtype=np.uint8, count=n * size, offset=9)
            padded = np.zeros((n, 8), dtype=np.uint8)
            padded[:, :size] = raw.reshape(n, size)
            vals = padded.view("<u8").reshape(n)
            if bool((vals >= np.uint64(field.p)).any()):
                raise ValueError("non-canonical field element")
            # FeltVector keeps the uint64 array as-is — no per-element
            # python-int or Felt construction; the verifier's MLE
            # evaluation consumes the array directly
            return Begin(circuit_outputs=FeltVector(vals, field))
        offset = 9
        outs = []
        for _ in range(n):
            f, offset = deserialize_felt(data, offset, field)
            outs.append(f)
        if offset != len(data):
            raise SerializationError("trailing bytes in Begin")
        return Begin(circuit_outputs=outs)
    if tag == _TAG_START:
        c_1, offset = deserialize_felt(data, 1, field)
        round_i, num_vars = struct.unpack_from("<QQ", data, offset)
        if offset + 16 != len(data):
            raise SerializationError("trailing bytes in StartSumCheck")
        return StartSumCheck(c_1=c_1, round=round_i, num_vars=num_vars)
    if tag == _TAG_SUMCHECK:
        p, offset = deserialize_unipoly(data, 1, field)
        if offset != len(data):
            raise SerializationError("trailing bytes in SumCheckProverMessage")
        return SumCheckProverMessage(p=p)
    if tag == _TAG_FINAL:
        p, offset = deserialize_unipoly(data, 1, field)
        q, offset = deserialize_unipoly(data, offset, field)
        if offset != len(data):
            raise SerializationError("trailing bytes in FinalRoundMessage")
        return FinalRoundMessage(p=p, q=q)
    raise SerializationError(f"unknown GKR message tag {tag}")


class GKRTranscript(FiatShamirTranscript):
    """The non-interactive GKR proof: the serialized message log.

    Same container semantics (and ``to_bytes``/``from_bytes`` framing) as
    :class:`FiatShamirTranscript`; the messages are GKR-tagged."""


# ---------------------------------------------------------------------------
# challenge chain
# ---------------------------------------------------------------------------


class _Chain:
    """The running-concat hash chain (ref fiat-shamir/src/lib.rs:82-93).

    Carries a SHA-256 midstate over the absorbed prefix (XmdChain) so each
    challenge draw hashes only the new bytes — O(T) total over a T-byte
    transcript instead of the reference's O(T^2) re-hash per challenge.
    Byte-identical to hashing the full running concatenation."""

    def __init__(self, field: FieldConfig, dst: bytes):
        self.xmd = XmdChain(field, dst)
        self.messages: List[bytes] = []

    def push(self, raw: bytes) -> None:
        self.messages.append(raw)
        self.xmd.absorb(raw)

    def draw(self, count: int) -> List[Felt]:
        return self.xmd.draw(count)


def _next_layer_point(prover: Prover, r_star: Felt) -> List[Felt]:
    """r_{i+1} = l(r*) from the prover's collected inner challenges
    (the line trick the verifier applies at ref lib.rs:159-170)."""
    half = len(prover.r) // 2
    b, c = prover.r[:half], prover.r[half:]
    return [li.evaluate(r_star) for li in line(b, c)]


def _run_step(name: str, layer, j, fn):
    return fn()


def generate_gkr_transcript(
    prover: Prover, field: FieldConfig, dst: bytes = b"", step=None
) -> GKRTranscript:
    """Run the full GKR prover non-interactively.

    ``step(name, layer, j, fn)``, when given, runs each step of the loop as
    ``fn()`` and returns its result, so that a caller can time or trace the
    steps: "begin" (layer None), then per layer one "layer" step around
    that layer's "start_round", its "round" steps j = 0 .. 2k - 1 (the last
    is the FinalRoundMessage) and a "hash" step after each message (j of
    the message before it, None after Begin and StartSumCheck)."""
    run = step or _run_step
    circuit = prover.circuit
    chain = _Chain(field, dst)

    def absorb(raw: bytes, count: int) -> List[Felt]:
        chain.push(raw)
        return chain.draw(count) if count else []

    begin = run("begin", None, None, lambda: serialize_gkr_message(prover.start_protocol()))
    r_0 = run("hash", None, None, lambda: absorb(begin, circuit.num_vars_at(0)))

    def layer(i: int, r_i: List[Felt]) -> List[Felt]:
        start = run("start_round", i, None, lambda: serialize_gkr_message(prover.start_round(i, r_i)))
        run("hash", i, None, lambda: absorb(start, 0))
        num_vars = 2 * circuit.num_vars_at(i + 1)
        for j in range(num_vars - 1):
            msg = run("round", i, j, lambda: serialize_gkr_message(prover.round_msg(j)))
            # one challenge, then r_{last-1} and the final random point
            for r in run("hash", i, j, lambda: absorb(msg, 1 if j < num_vars - 2 else 2)):
                prover.receive_verifier_msg(SumCheckRoundResult(res=JthRound(r)))
        last = num_vars - 1
        final = run("round", i, last, lambda: serialize_gkr_message(prover.round_msg(last)))
        (r_star,) = run("hash", i, last, lambda: absorb(final, 1))
        return _next_layer_point(prover, r_star)

    r_i = r_0
    for i in range(len(circuit.layers)):
        r_i = run("layer", i, None, lambda: layer(i, r_i))
    return GKRTranscript(chain.messages)


def verify_gkr_transcript(
    transcript: GKRTranscript,
    verifier: Verifier,
    inputs,
    field: FieldConfig,
    dst: bytes = b"",
) -> bool:
    """Replay the message log through the interactive verifier, feeding it
    the re-derived challenges (the RandNums mechanism of ref lib.rs:102-119).
    Returns True iff every check passes including the final input check."""
    chain = _Chain(field, dst)
    msgs = [deserialize_gkr_message(m, field) for m in transcript.g]
    idx = 0
    if not msgs or not isinstance(msgs[0], Begin):
        raise SerializationError("transcript must start with Begin")
    chain.push(transcript.g[0])
    k_0 = verifier.circuit.num_vars_at(0)
    r_0 = chain.draw(k_0)
    res = verifier.receive_prover_msg(msgs[0], RandNums(r_0))
    if not isinstance(res, R):
        return False
    idx = 1
    num_layers = len(verifier.circuit.layers)
    for i in range(num_layers):
        msg = msgs[idx]
        if not isinstance(msg, StartSumCheck) or msg.round != i:
            raise SerializationError(f"expected StartSumCheck({i})")
        chain.push(transcript.g[idx])
        verifier.receive_prover_msg(msg, RandNums([]))
        idx += 1
        num_vars = 2 * verifier.circuit.num_vars_at(i + 1)
        if msg.num_vars != num_vars:
            return False
        for j in range(num_vars - 1):
            msg = msgs[idx]
            if not isinstance(msg, SumCheckProverMessage):
                raise SerializationError("expected SumCheckProverMessage")
            chain.push(transcript.g[idx])
            if j < num_vars - 2:
                (r_j,) = chain.draw(1)
                verifier.receive_prover_msg(msg, RandNums([r_j]))
            else:
                r_j, r_last = chain.draw(2)
                verifier.receive_prover_msg(msg, RandNums([r_j]))
                verifier.final_random_point(RandNums([r_last]))
            idx += 1
        msg = msgs[idx]
        if not isinstance(msg, FinalRoundMessage):
            raise SerializationError("expected FinalRoundMessage")
        chain.push(transcript.g[idx])
        (r_star,) = chain.draw(1)
        res = verifier.receive_prover_msg(msg, RandNums([r_star]))
        if not isinstance(res, R):
            return False
        idx += 1
    if idx != len(msgs):
        raise SerializationError("trailing messages in transcript")
    return verifier.check_input(inputs)


def resume_gkr_transcript(
    prover: Prover,
    field: FieldConfig,
    partial: GKRTranscript,
    dst: bytes = b"",
    verify_prefix: bool = False,
) -> GKRTranscript:
    """Resume a non-interactive GKR proof from a partial transcript.

    Fast-forwards ``prover`` (a fresh instance over the same circuit and
    inputs) by replaying the recorded messages: challenges are re-derived
    from the byte prefix and applied with fold-only ``advance`` steps —
    round polynomials and line restrictions are NOT recomputed — then the
    remaining messages are produced normally. Output is byte-identical to
    an uninterrupted :func:`generate_gkr_transcript` run.

    ``verify_prefix=True`` recomputes every checkpointed message and checks
    it against the recorded bytes (cost = re-proving the prefix).
    """
    if not partial.g:
        return generate_gkr_transcript(prover, field, dst)
    chain = _Chain(field, dst)
    t = len(partial.g)
    pos = 0  # messages consumed

    def replay(raw: bytes, recompute) -> None:
        if verify_prefix:
            got = serialize_gkr_message(recompute())
            if got != raw:
                raise SerializationError(
                    f"checkpoint prefix mismatch at message {pos}"
                )
        chain.push(raw)

    # --- Begin ---
    replay(partial.g[0], prover.start_protocol)
    pos = 1
    r_i = chain.draw(prover.circuit.num_vars_at(0))
    num_layers = len(prover.circuit.layers)
    for i in range(num_layers):
        if pos >= t:
            break
        # --- StartSumCheck (state build is unavoidable on resume) ---
        start_msg = prover.start_round(i, r_i)
        if verify_prefix:
            if serialize_gkr_message(start_msg) != partial.g[pos]:
                raise SerializationError(
                    f"checkpoint prefix mismatch at message {pos}"
                )
        chain.push(partial.g[pos])
        pos += 1
        num_vars = 2 * prover.circuit.num_vars_at(i + 1)
        j = 0
        while j < num_vars - 1 and pos < t:
            raw = partial.g[pos]
            if verify_prefix:
                jj = j
                replay(raw, lambda: prover.round_msg(jj))
            else:
                # fold-only advance past message j
                prover.prover.advance(None if j == 0 else prover.r[j - 1])
                chain.push(raw)
            pos += 1
            if j < num_vars - 2:
                (r_j,) = chain.draw(1)
                prover.receive_verifier_msg(
                    SumCheckRoundResult(res=JthRound(r_j))
                )
            else:
                r_j, r_last = chain.draw(2)
                prover.receive_verifier_msg(
                    SumCheckRoundResult(res=JthRound(r_j))
                )
                prover.receive_verifier_msg(
                    SumCheckRoundResult(res=JthRound(r_last))
                )
            j += 1
        if pos >= t:
            # continue this layer's remaining rounds live
            g = list(partial.g)
            while j < num_vars - 1:
                g.append(serialize_gkr_message(prover.round_msg(j)))
                chain.push(g[-1])
                if j < num_vars - 2:
                    (r_j,) = chain.draw(1)
                    prover.receive_verifier_msg(
                        SumCheckRoundResult(res=JthRound(r_j))
                    )
                else:
                    r_j, r_last = chain.draw(2)
                    prover.receive_verifier_msg(
                        SumCheckRoundResult(res=JthRound(r_j))
                    )
                    prover.receive_verifier_msg(
                        SumCheckRoundResult(res=JthRound(r_last))
                    )
                j += 1
            g.append(serialize_gkr_message(prover.round_msg(num_vars - 1)))
            chain.push(g[-1])
            (r_star,) = chain.draw(1)
            r_i = _next_layer_point(prover, r_star)
            return _continue_layers(prover, chain, g, i + 1, r_i)
        # --- recorded FinalRoundMessage ---
        raw = partial.g[pos]
        if verify_prefix:
            last = num_vars - 1
            replay(raw, lambda: prover.round_msg(last))
        else:
            prover.prover.advance(prover.r[num_vars - 2])
            chain.push(raw)
        pos += 1
        (r_star,) = chain.draw(1)
        r_i = _next_layer_point(prover, r_star)
    if pos != t:
        raise SerializationError("checkpoint longer than the protocol")
    # all recorded layers consumed; continue with the remaining layers
    done_layers = sum(
        1 for m in partial.g if m and m[0] == _TAG_FINAL
    )
    return _continue_layers(
        prover, chain, list(partial.g), done_layers, r_i
    )


def _continue_layers(
    prover: Prover,
    chain: _Chain,
    g: List[bytes],
    start_layer: int,
    r_i: List[Felt],
) -> GKRTranscript:
    num_layers = len(prover.circuit.layers)
    for i in range(start_layer, num_layers):
        g.append(serialize_gkr_message(prover.start_round(i, r_i)))
        chain.push(g[-1])
        num_vars = 2 * prover.circuit.num_vars_at(i + 1)
        for j in range(num_vars - 1):
            g.append(serialize_gkr_message(prover.round_msg(j)))
            chain.push(g[-1])
            if j < num_vars - 2:
                (r_j,) = chain.draw(1)
                prover.receive_verifier_msg(
                    SumCheckRoundResult(res=JthRound(r_j))
                )
            else:
                r_j, r_last = chain.draw(2)
                prover.receive_verifier_msg(
                    SumCheckRoundResult(res=JthRound(r_j))
                )
                prover.receive_verifier_msg(
                    SumCheckRoundResult(res=JthRound(r_last))
                )
        g.append(serialize_gkr_message(prover.round_msg(num_vars - 1)))
        chain.push(g[-1])
        (r_star,) = chain.draw(1)
        r_i = _next_layer_point(prover, r_star)
    return GKRTranscript(g)
