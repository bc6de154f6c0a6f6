"""Fused non-interactive GKR proving: each layer's rounds with no host read.

Counterpart of ``thaler_study_tpu/gkr/fused.py``. The per-layer path
(``gkr/transcript.generate_gkr_transcript``) reads each round's sums back
to the host, interpolates and hashes there: 2k host reads per layer. Here
every layer is issued from Python as a fixed sequence of launches, and its
scalars (claims, challenges, the chain's state, r_{i+1}) stay on the card:

- phase 1: the eq table of r_i over k_cur variables, the phase-1 tables
  (K2), then k rounds of K1 with the round tail as its epilogue (one
  launch each), the first also writing StartSumCheck;
- phase 2: the eq table of u, the phase-2 tables (K2) and W~(u) (a dot
  product kept on the card as K1's phase-2 scalar), k - 1 rounds of K1
  with the round tail, the second-to-last message drawing r_{2k-2} and
  r_last, then the final K1, the line restriction and the final tail (the
  FinalRoundMessage, r* and r_{i+1} = u + (c - u) r*).

The tails (``ops/gkr_tail.py``) write every message into one byte buffer
on the card. After the Begin message, which the host serializes and whose
midstate it takes with the native runtime, the proof has one
device-to-host read: all layers' transcript bytes and the zero flag. The
host only slices the messages out of it. Output is byte-identical to
``generate_gkr_transcript``.

As in the JAX package, the fixed message lengths assume every serialized
coefficient is nonzero (arkworks drops zero terms); a zero is flagged on
the card and the proof is redone on the per-layer path.

Scope (``supports_fused_gkr``): Goldilocks, the empty DST, every layer with
k >= 2 variables, one device. Every other input takes the per-layer path,
on the same device; ``mesh=`` (the multi-device slice, ROADMAP A7) raises.
Not ported: the JAX package's one-program layer scan (``_scan_proof_jit``;
the layer loop here already has no sync), the ``interp`` line restriction
and the ``plan`` / ``segment`` scatter modes (A/B switches), and
``_pack_outputs`` (the transcript bytes are written on the card).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..fields import FArray, FieldConfig
from ..ops.cuda_round import LIBRA_PHASE2, round_partials
from ..ops.gkr_tail import (
    ROUND_LEN,
    START_LEN,
    GKRChain,
    LayerTail,
    RoundTail,
    final_len,
    final_tail,
    libra_round_tail,
    midstate,
)
from ..ops.sha_chain import draw_many_py
from .device_tables import line_restrict_coeffs, lsb_to_msb, phase1_tables, phase2_tables
from .transcript import GKRTranscript, generate_gkr_transcript, serialize_gkr_message

# proofs routed to the per-layer path: unsupported inputs and zero flags
fallbacks = 0


def supports_fused_gkr(circuit, field: FieldConfig, dst: bytes) -> bool:
    """Goldilocks, the empty DST and k >= 2 variables in every layer's
    inputs (``thaler_study_tpu/gkr/fused.py:500``)."""
    if dst != b"" or field.backend != "goldilocks":
        return False
    return all(circuit.num_vars_at(i + 1) >= 2 for i in range(len(circuit.layers)))


def _layer_lens(k: int) -> List[int]:
    """Message lengths of one layer: StartSumCheck with the first round
    message (one tail launch), 2k - 2 more round messages, the final one."""
    return [START_LEN, ROUND_LEN] + [ROUND_LEN] * (2 * k - 2) + [final_len(k)]


class _Layer:
    """One layer's state on the card: what its round tails read and write
    (``ops/gkr_tail.LayerTail``: the chain, the transcript bytes, the zero
    flag, the running claim, the challenge vector u then c, the round
    kernel's ticket counter), the write position in the transcript bytes,
    and the proof's ping-pong buffers for the folded tables."""

    def __init__(self, prover, i: int, chain, msgs, zero, counter, bufs, off: int):
        circuit = prover.circuit
        self.i, self.k, self.k_cur = i, circuit.num_vars_at(i + 1), circuit.num_vars_at(i)
        self.w_lsb = prover.layers_dev[i + 1]
        dev = self.w_lsb.device
        self.wiring = circuit.device_wiring(i, dev)
        self.tail = LayerTail(chain, msgs, zero, torch.empty(1, dtype=torch.int64, device=dev),
                              torch.empty(2 * self.k, dtype=torch.int64, device=dev), counter)
        self.chal, self.claim = self.tail.chal, self.tail.claim
        self.bufs, self.off = bufs, off

    def _out(self, tables, j: int):
        """Round j's fold target: the halves land in ping-pong buffer
        (j - 1) % 2 (the previous fold's output is in the other one)."""
        n = tables[0].shape[1] // 2
        return [b[(j - 1) % 2][:n].view(1, n) for b in self.bufs]

    def round(self, tables, j: int, r, skip_t1: bool, phase: int, scalars, chal_idx: int, draws: int, start=None):
        """Inner round j of a phase: K1 with the round tail as its epilogue;
        returns the folded tables (or the input tables for a round without
        a fold)."""
        tail = RoundTail(self.tail, self.off, chal_idx, draws, start)
        out = None if r is None else self._out(tables, j)
        folded, _ = libra_round_tail(tables, r, skip_t1, phase, scalars, tail, out)
        self.off += tail.length
        return folded or tables

    def phase1(self, r_i: FArray):
        """Eq table, phase-1 tables, k rounds: the challenges u go to
        chal[:k]; returns (W in MSB-first order, eq_r)."""
        k = self.k
        a1, a2, eq_r = phase1_tables(r_i, self.w_lsb, self.wiring, self.k_cur, k)
        w_msb = lsb_to_msb(self.w_lsb, k)
        tables = [t.data.reshape(1, -1) for t in (w_msb, a1, a2)]
        for j in range(k):
            r = None if j == 0 else self.chal[j - 1 : j]
            start = (self.i, k) if j == 0 else None
            tables = self.round(tables, j, r, j > 0, 1, [], j, 1, start)
        return w_msb, eq_r

    def phase2(self, w_msb: FArray, eq_r: FArray) -> FArray:
        """Eq table of u, phase-2 tables and W~(u), k - 1 rounds, the final
        round, the line restriction and the final tail: the challenges c go
        to chal[k:]; returns r_{i+1}."""
        k, field, chal = self.k, w_msb.field, self.chal
        u = FArray(chal[:k], field)
        b1, b2, w_u = phase2_tables(u, self.w_lsb, eq_r, self.wiring, k)
        tables = [t.data.reshape(1, -1) for t in (b1, b2, w_msb)]
        for j in range(k - 1):
            r = None if j == 0 else chal[k + j - 1 : k + j]
            # the second-to-last message draws r_{2k-2} and r_last
            tables = self.round(tables, j, r, True, 2, [w_u.data], k + j, 1 if j < k - 2 else 2)
        r = chal[2 * k - 2 : 2 * k - 1]  # k >= 2: the last round folds
        _, partials = round_partials(tables, r, True, self._out(tables, k - 1), field, LIBRA_PHASE2, [w_u.data])
        c = FArray(chal[k:], field)
        q = line_restrict_coeffs(self.w_lsb, u, c - u, k)
        r_next = torch.empty(k, dtype=torch.int64, device=chal.device)
        self.off += final_tail(
            partials, self.claim, q.data, chal, k, self.tail.chain, self.tail.msgs, self.off, self.tail.zero, r_next
        )
        return FArray(r_next, field)


def _prove_fused(prover, field: FieldConfig, timings: Optional[list] = None) -> Optional[List[bytes]]:
    """The fused proof's messages, or None when a serialized coefficient is
    zero. ``timings``, when given, receives ("prelude" | "phase1" |
    "phase2" | "pull" | "assemble", layer, seconds) with a device sync
    after every step (which serializes the host with the card, so only
    profiling runs pass it)."""
    circuit = prover.circuit
    dev = prover.device
    clock = [time.perf_counter()]

    def mark(name: str, layer: int) -> None:
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings.append((name, layer, now - clock[0]))
            clock[0] = now

    # prelude: Begin; its midstate over Z_pad || Begin, hashed once on the
    # host, gives r_0 and seeds the device chain
    begin_raw = serialize_gkr_message(prover.start_protocol())
    state, rest = midstate(begin_raw)
    r0 = draw_many_py(field, state.tolist(), rest, len(begin_raw), circuit.num_vars_at(0))
    chain = GKRChain.seeded(state, rest, len(begin_raw), dev)
    lens = [n for i in range(len(circuit.layers)) for n in _layer_lens(circuit.num_vars_at(i + 1))]
    out = torch.zeros(4 + sum(lens), dtype=torch.uint8, device=dev)
    zero, msgs = out[:4].view(torch.int32), out[4:]
    counters = torch.zeros(len(circuit.layers), dtype=torch.int32, device=dev)
    # ping-pong fold buffers, three tables x (half, quarter) of the widest layer
    half = 1 << (max(circuit.num_vars_at(i + 1) for i in range(len(circuit.layers))) - 1)
    bufs = [[torch.empty(half, dtype=torch.int64, device=dev), torch.empty(half // 2, dtype=torch.int64, device=dev)]
            for _ in range(3)]
    r_i = FArray.from_ints(r0, field, device=dev)
    mark("prelude", -1)

    off = 0
    for i in range(len(circuit.layers)):
        layer = _Layer(prover, i, chain, msgs, zero, counters[i : i + 1], bufs, off)
        w_msb, eq_r = layer.phase1(r_i)
        mark("phase1", i)
        r_i = layer.phase2(w_msb, eq_r)
        off = layer.off
        mark("phase2", i)

    host = out.cpu().numpy()  # the one read: the zero flag and every message
    mark("pull", -1)
    if host[:4].any():
        return None
    blob = host[4:].tobytes()
    cuts = np.cumsum([0] + lens).tolist()
    msgs_out = [begin_raw] + [blob[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    mark("assemble", -1)
    return msgs_out


def generate_gkr_transcript_fused(
    prover, field: FieldConfig, dst: bytes = b"", timings: Optional[list] = None, mesh=None
) -> GKRTranscript:
    """Drop-in for ``generate_gkr_transcript``: the fused proof on the
    prover's device, or the per-layer path for inputs outside
    :func:`supports_fused_gkr` and for a flagged zero coefficient (each
    counted in ``fallbacks``). ``prover`` is a fresh ``gkr.Prover``; the
    fused path reads only its circuit and forward-pass values. ``timings``:
    see :func:`_prove_fused`."""
    global fallbacks
    if mesh is not None:
        raise NotImplementedError("a sharded fused GKR proof (mesh=) is the multi-device slice of the port (ROADMAP A7)")
    msgs = _prove_fused(prover, field, timings) if supports_fused_gkr(prover.circuit, field, dst) else None
    if msgs is None:
        fallbacks += 1
        return generate_gkr_transcript(prover, field, dst)
    return GKRTranscript(msgs)
