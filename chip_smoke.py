#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

Usage, from the repository root on a machine with a card:

    python3 chip_smoke.py [--seed 42] [--n 22] [--batch 64] [--reps 5] [--mm-log 13]
                          [--gkr-depth 16] [--gkr-log 20] [--tri-nodes 4096]
                          [--tri-nodes-small 1024] [--tri-nodes-cmp 256]
                          [--wide-depth 8] [--wide-log 11] [--fused-trace-only]

``--fused-trace-only`` builds the kernels and the flagship circuit, traces
one fused GKR proof and prints its device time by kernel and by aten op
(the plain-torch launches), and stops: it reads only names that earlier
trees of the port have too, so a copy of this script placed at the root
of an older checkout traces that tree's proof the same way.

The paths, each driven through the entry points a user calls:

- the batched Fiat-Shamir sumcheck prover
  (``protocols.batched.generate_transcripts_batch`` ->
  ``ops.fs_kernel.fs_prove_device_batch``): B whole proofs of a 2-factor
  product over a 2^n hypercube per dispatch, n = 22 and B = 64 by default,
  over Goldilocks (4.3 GB of tables on the card) and over BabyBear
  (2.15 GB);
- the matrix-multiplication IP entry point (``api.prove_matmul_entry`` /
  ``verify_matmul_entry``) on two 2^mm_log x 2^mm_log matrices made from the
  seed with numpy, 8192 x 8192 by default, over F5 and Goldilocks;
- the GKR prover (``gkr.Prover`` -> ``gkr.generate_gkr_transcript``, then
  ``gkr.verify_gkr_transcript``) on the flagship circuit of
  ``benches/gkr_benchmark.py``: 16 layers x 2^20 gates over Goldilocks,
  wiring, gate types and inputs drawn from the seed with numpy as the
  benchmark draws them, and over BabyBear on the same circuit with inputs
  drawn below p (the path of K1's mont32 form at full width); and
  ``api.run_gkr`` with ``generate_gkr_transcript`` on the book circuit
  (F389), a 5-layer mixed-width circuit (Goldilocks and BabyBear) and the
  BabyBear flagship;
- the fused GKR prover (``gkr.generate_gkr_transcript_fused``) on two small
  Goldilocks circuits and on the flagship;
- the triangle-counting IP (``api.prove_triangle_count`` /
  ``verify_triangle_count``) on the symmetric G(n, 0.05) drawn from the
  seed: 4096 nodes over Goldilocks (36 variables, three 2^24-entry factor
  tables), 1024 nodes over Goldilocks and BabyBear, 256 nodes against
  ``device="cpu"``; and the dense-W GKR prover (``gkr.Prover(...,
  use_linear=False)``) on the book circuit, the 5-layer mixed-width circuit
  and an 8 x 2^11 circuit (2^22-entry wiring tables);
- the batched prover beyond the fused 2-factor product
  (``generate_transcripts_batch``): a non-empty 16-byte DST (the per-round
  path: ``BatchedProductPoly.c_1`` / ``round_batch``, one round kernel
  launch and one host read per round) at n = 22, B = 64 over Goldilocks;
  the fused path at k = 1 (B = 64) and k = 4 (B = 16), n = 22, over
  Goldilocks and BabyBear; ``fiat_shamir.generate_transcript_device`` over
  multi-block specs (the triangle spec at 4096 nodes over Goldilocks and
  1024 over BabyBear, a mixed-degree 2-block spec, dense W's spec on the 8 x
  2^11 circuit's first layer): ``round_step`` and one FS tail launch per
  round, one host read;
- the PCS (``pcs.Prover`` / ``Verifier``): F389, m = 2 (151,321 points,
  2^18 leaves), its SHA-256 tree on the Merkle kernel; the Merkle build
  alone at 2^22 Goldilocks leaves; the Pedersen family (host integers) on
  its golden tree and over F5;
- slice 13, the sharded prover on a mesh of 8 shards on the card
  (``parallel.make_mesh([cuda] * 8)``, n_shard 3): the fused FS prover
  (``fs_prove_device_sharded``) over a 2-factor product at n = 28
  (Goldilocks and BabyBear, the batch cell's bytes); the 4096-node
  Goldilocks and 1024-node BabyBear triangles sharded on Z, per round over
  ``ShardedBlockPoly`` and through ``generate_transcript_device(mesh=)``;
  the per-layer GKR prover with ``mesh=`` on the flagship circuit (both
  fields) and ``api.run_gkr(mesh=, n_shard=)``; a one-rank NCCL process
  group (a ``FileStore``) behind ``make_mesh_2d(dcn_size=1)``;
- slice 14, the sharded fused GKR prover
  (``gkr.generate_gkr_transcript_fused(..., mesh=)``) on the flagship
  circuit, 8 shards of the card (n_shard 3): K2 over each device's shard
  rows, K1 over the rows, one reduction and the round tail over the
  reduced rows per sharded round, then the gathered residual rounds;
- slice 15 runs through the same sharded paths: each device's shard rows
  of a LibraW round in one launch of K1's TOTAL form
  (``cuda_round.libra_round_total``), of the triangle's contracted term in
  one launch per t of the tensor-core matmul's dot form over shard rows
  (``modmatmul.contract_total``, also the unsharded triangle's with one
  row), every row of a round written by a kernel
  (the multi-block kernel's sums into their rows, scaled in the launch),
  the reduction's sums across processes by ``ops/row_sums.py``;
- slice 16, the one-program forms: the batch dispatch's rounds 2..n-1 and
  the unsharded fused GKR proof's layer loop, each captured as a CUDA
  graph at its program's first run (``ops/fs_kernel._BatchProgram``,
  ``gkr/fused._Program``) and replayed by every later dispatch or proof:
  the counted main-path runs above are replays;
- slice 17 runs through the sharded paths too: every sharded factor
  table laid out by the shard layout kernel (``ops/shard_layout.py``,
  one launch per table and group) and every multi-block round and fold
  of a device's shard rows in one launch of their rows forms
  (``multiblock.round_sums`` and ``fold_tables`` over [rows, ...] tables);
- slice 20 runs through the paths above: the GKR forward pass (one
  launch of ``csrc/forward.cu`` per layer), the bit reversal of the
  matmul entry's two 2^26-word MLEs, of the triangle's input and of each
  GKR layer's W (``csrc/mle.cu``, inside the fused program's graph too),
  the matmul entry's fold chains (13 of 26 variables, one launch each),
  each per-layer GKR restriction and the PCS commit's 151,321 evaluations
  (one launch of the fold kernel's evaluation form each).

Phases, each ending in ``torch.cuda.synchronize()``:

1. device: card name and power limit; build the kernels with nvcc (one
   process per source, in parallel) and the host runtime with g++;
2. each kernel instantiation against its plain torch version on the card,
   on the same tensors, exactly (field values have no rounding): the round
   kernel over Goldilocks and over the mont32 fields BabyBear, F1572869,
   F389 and F5; the FS tail over the same five fields at every buffer fill
   (nbytes % 64 = 0..63), degree 2 and 3, round 0 / middle / last, its
   transcript bytes included; the SHA-256 chain helper against Python; the
   round kernel's two LibraW shapes (K1) with and without fold and skip-1
   at several sizes, per-block partials and the round finished in the
   launch (``libra_round_sums``: s(0..2), skip-1 with and without the
   claim) at 2^2 to 2^20 entries, tables at p - 1 and one word off 16
   bytes, and the phase-table kernel (K2, over its static plan)
   on skewed and sparse wirings and on random ones at every k = 4..20
   (Goldilocks and BabyBear; k = 4 for the other fields) with random
   values and values at p - 1, over the same five fields (and in phase 4
   on the flagship's own layer 0 wiring, over Goldilocks and BabyBear);
   the eq-table kernel at n = 0..20, alone and with the dot W~(u) in the
   same pass (Goldilocks, BabyBear), the line restriction's tiles through
   the fused path's form (u and c from a challenge vector) at k = 2..20
   (Goldilocks, BabyBear) and the delta form, K1 with the GKR round tail as
   its epilogue
   (TAIL) against K1's plain version then the tail's at every fill x
   (StartSumCheck, one draw, two draws), and the final tail at k in
   (2, 3, 10, 20) x every fill; the multi-block round kernel and its flat
   fold (the triangle spec at every block transition, dense W in both
   phases, single-block k = 1, k = 4 and a scalar-table product; fold and
   skip-1 on and off), and the two modular matmuls, the CUDA-core kernel
   and the tensor-core kernel (C = A B^T and the contraction's partials
   without a view and at t = 0..3, M, N, K off the tiles, K up to 4096; the
   tensor-core kernel also at M = 1, a ragged N and K at its flush length
   K_c and K_c + 1, and its digit pre-pass against the plain digit planes)
   over the five fields, random words and words at p - 1 and p - 2; the
   batch round kernel at k = 1..8 (Goldilocks, BabyBear, F5; fold and
   skip-1 on and off; N = 2^2 to 2^16, B = 1, 3, 64; random words and
   words at p - 1), the FS tail at degrees 1 and 4..8 over the five fields
   at every fill, and the Merkle kernel at 1 to 2^17 leaves of 1, 2, 3, 4
   and 8 bytes (each stage of its one launch) against ``hashlib``, every
   level;
3. each path at full size, with the launch counts set to 0 just before it
   and read just after: per field, instances 0 and B - 1 byte-identical to
   the plain path on CPU copies, accepted by the verifier and rejected when
   tampered, and a batch with an all-zero factor in one instance; the
   matmul entry against the product entry computed with Python ints, the
   verifier, a tampered transcript, and a smaller entry against the same
   call on the CPU; the GKR circuits: the small ones byte-identical to
   ``device="cpu"`` through both entry points, the flagship's outputs equal
   to the plain forward pass on the CPU, accepted by the verifier and
   rejected when tampered, over Goldilocks and over BabyBear (K1's launch
   counts, ``api.run_gkr``, and a 2 x 2^12 cut byte-identical to
   ``device="cpu"``); the fused path byte-identical to ``device="cpu"``
   and to the per-layer path (small circuits) and to the per-layer run
   (flagship), with no fallback and the launch counts of its design; the
   triangle IP's 6 Delta against trace(A^3) (float64 on the card, exact for
   these sizes), accepted, a tampered copy rejected, the launches of each
   kernel per proof (c_1 and the X phase on the tensor-core matmul, none
   on the CUDA-core matmul); the dense W
   byte-identical to the LibraW run on the card and on the CPU, accepted,
   tampered copy rejected; slice 12: the DST batch's instances 0 and
   B - 1 byte-identical to single proofs with the DST, accepted with it and
   rejected tampered or without it, a cut byte-identical to
   ``device="cpu"``; the fused k = 1 and k = 4 batches byte-identical to
   the host loop on the card, n launches of each kernel; the device
   transcripts byte-identical to ``api.prove_triangle_count``'s and to the
   host loop, one FS tail launch per round, no device-to-host read inside
   the round loop (a trace); the PCS accepted, a changed leaf, a wrong
   degree and a changed leaf in a 16-point multi-opening rejected, its
   root equal to ``device="cpu"``'s; the Pedersen tree equal to
   ``tests/data/pedersen_golden.json``;
4. timing with CUDA events, a dependent host read and a profiler trace,
   and the FS tail's latency floor (one thread's chain of dependent SHA-256
   compressions, times the compressions on a round's chain); for GKR, the
   proof's seconds with a breakdown by step, the device idle share and the
   plain-torch kernels per sumcheck round from a trace of one layer (both
   fields), and K1 and K2 at the flagship's shapes; for the
   fused path, the median of warm proofs, its ``timings`` breakdown, the
   prelude's parts, a trace of one proof (device idle share, one
   device-to-host read after the prelude, no standalone round tail, the
   plain-torch time by aten op), and its kernels at the flagship's shapes
   (K1 with TAIL beside K1 alone; the eq table, the eq table with the dot
   and the line restriction); each triangle proof split into input
   building, c_1, the X, Y and Z phases and hashing; the multi-block kernels
   and both modular matmuls at the triangle path's shapes (round 0, the
   middle and the last contracted round of the X phase at 4096 and 1024
   nodes, round 0 at 256 nodes) and at C = A B^T from 1^3 to 256^3: the
   crossover that sends every shape to the tensor cores; the CUDA-core
   matmul against an operations bound from its SASS (``cuobjdump -sass``),
   the tensor-core matmul against the int8 rate (its SASS shown to hold
   warpgroup MMA instructions; at K = 128 to show what its epilogue costs),
   ``torch._int_mm`` over the same digit planes as a yardstick; slice 12:
   the DST dispatch against the fused one on the same tables (and its idle
   share), the fused k = 1 and k = 4 dispatches, the batch round kernel at
   k = 1 and 4 and the FS tail at degree 1 and 4 from CUDA graphs (the
   tail beside its latency floor and held against its plain version at
   that shape), the
   triangle proof through ``generate_transcript_device`` in turns with
   ``prove_triangle_count``, the PCS commit split (``evaluate_many``, leaf
   bytes, the tree's kernels, the whole ``MerkleTree``) and the Merkle build at 2^22
   Goldilocks and 2^18 F389 leaves against the largest of its operations
   bound (the pinned SASS instructions per hash,
   ``MERKLE_SASS_PER_HASH``), its depth floor (1 + 2 log2 n compressions
   in series) and its bytes bound, with the kernel's own SASS by pipe;
   slice 13 (phases 2-5 in ``sharded_slice``, the GKR part in
   ``sharded_gkr`` on the flagship): the batched tensor-core matmul (grid y
   = the shard) at the 4096-node sharded triangle's per-shard shapes (X
   round 0: 8 x M = 2048, N = 4096, K = 512; the middle of the X phase), its
   batched digit pre-pass and C = A B^T at ragged shapes, both fields; the
   no-claim round sums (s(1) left 0 for the reduction) of the batch round
   kernel over the n = 28 proof's 8 shard rows, of K1 over the flagship's
   8 shards of 2^17, of MB over one shard row of the triangle's Y phase
   with the replicated table folded before it, and the FS tail over the 8
   x blocks partial rows, each against its plain version and timed from a
   CUDA graph; every sharded path byte-identical to its unsharded run,
   timed in turns with it, with its launches and collectives;
   slice 15 (in the same functions): K1's TOTAL form over the flagship's
   8 shard rows (both phases, fold on and off, random words and words at
   p - 1) and the tensor-core matmul's dot form over shard rows at the
   sharded triangle's X round 0 and middle shapes against their plain
   versions (exact), timed from CUDA graphs, K1's beside its per-row form;
   the row sums (rows, lanes out and back) and the multi-block kernel's
   scaled sums into a row against their plain versions;
   slice 17 (in ``sharded_slice``): the shard layout kernel against its
   plain version at n (the sharded FS proof's tables, S = 8) and at small
   odd shapes (S = 2 and 64, partial and one-row groups, words at p - 1),
   timed from CUDA graphs beside ``.T.contiguous()`` (its library call) and
   its bytes bound; MB's rows form over the 8 shard rows (with its scale,
   the claim, and without skip-1) and the fold's rows form against their
   plain versions, timed beside 8 per-row launches; the layout's launches
   on the sharded FS proof and the triangles (one per table and group) and
   MB's per sharded triangle round (one); the digit pre-pass rows' library
   call (the same byte planes by view, permute, pad and copy);
   a traced run of the sharded FS
   proof, the sharded triangle proofs and the sharded fused flagship with
   each sharded round in a synced range: 0 plain-torch kernels per round
   is the pass (``ranged_trace``, ``check_ranged``);
   slice 16: each program's first run (the eager loop and the capture)
   and a replay with the eager run's launch counts, byte-identical to it;
   a second input per program (the batch tables with every row rolled by
   one word, fresh flagship inputs) replayed byte-identical to the eager
   route (``fs_kernel._prove_batch(..., graph=False)``,
   ``gkr.fused._transcript(..., graph=False)``) and to ``device="cpu"``
   (the batch's instances 0 and B - 1), accepted, rejected when
   tampered; graph against eager in turns (dispatch_ms and field-ops/s;
   the flagship proof with and without its forward pass), traces of both
   routes (idle share, device-to-host reads, device records), the
   replayed proof's ``timings`` (the JAX package's scan names) and the
   eager route's per-step split, the bytes each program holds;
   slice 14 (``sharded_fused_slice``, on the flagship): the sharded fused
   proof byte-identical to the unsharded one, accepted, a tampered copy
   rejected, its launches, reductions, gathers and challenge sends against
   ``sharded_fused_counts``, its median in turns with the unsharded fused
   proof, its ``timings`` breakdown, a trace (one device-to-host read after
   the first eq table, the device idle share, time by kernel); K2 over the
   8 shard rows on the flagship's layer 0 wiring and the round tail over 8
   reduced rows (every fill x StartSumCheck / one / two draws) against
   their plain versions, timed from CUDA graphs beside their bounds;
   slice 18: K2 over shard rows on the group's layout-ordered plan over
   Goldilocks and BabyBear words (groups 0-7, 3, 6-7 and 1-5), timed in
   turns with the unsharded K2, the plan's bytes; the FS tail over the n =
   28 proof's 2,048 partial rows in the wide form (``fs_kernel.tail_warps``)
   and in the one-warp form forced on the same rows, both against the plain
   version, timed in turns with each other and with the one-warp tail over
   the batch dispatch's 32 rows;
   slice 20 (``mle_slice``): the bit reversal (2^0..2^26), the fold chain
   (n = 26 at every k = 1..13 and 26; n = 3, 10, 20), the evaluation (P =
   1..21 points over 2^1..2^20; the PCS's 151,321 points) and the forward
   pass (1 to 2^20 gates) against their plain versions over five fields,
   random words and every word p - 1, then timed from CUDA graphs beside
   their bounds (the bit reversal also beside ``index_select`` with a
   prebuilt index); on the paths: the matmul entry's MLE build split into
   upload, bit reversal, relabel and fold chain, the triangle's input
   building into widening, upload and bit reversal, the fused flagship's
   forward pass into upload and layers, the PCS commit's
   ``evaluate_many`` into host and kernel; the row sums beside one empty
   one-block launch (their latency floor);
5. the ``kernels`` line and the last line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero. Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

# H100 SXM device memory rate (NVIDIA data sheet); the bound for kernels
# whose work is a stream over their tables
PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        check=True,
        capture_output=True,
        text=True,
    )
    return out.stdout.strip()


def device_spans(prof, ranges: str = ""):
    """The device records of a trace, sorted, and the microseconds their
    union covers; records named with the prefix ``ranges`` (a
    ``record_function`` range's own record on the device timeline, which
    spans the kernels inside it) are left out."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not (ranges and e.name.startswith(ranges)))
    busy_us, end = 0.0, float("-inf")
    for s0, s1, _ in spans:
        if s1 > end:
            busy_us += s1 - max(s0, end)
            end = s1
    return spans, busy_us


def aten_split(prof):
    """The trace's device time by aten op (the plain-torch launches; the
    port's own kernels are launched through ctypes and have no aten op):
    [(op, device ms, calls)], largest first."""
    rows = []
    for avg in prof.key_averages():
        us = getattr(avg, "self_device_time_total", None)
        if us is None:
            us = getattr(avg, "self_cuda_time_total", 0.0)
        if avg.key.startswith("aten::") and us > 0:
            rows.append((avg.key, us / 1e3, avg.count))
    return sorted(rows, key=lambda r: -r[1])


def gate_circuit(gkr, widths, grng):
    """A random circuit of the given layer widths (output layer first, then
    the input count), wiring and gate types drawn as
    benches/gkr_benchmark.py draws them: b, c, then MUL with probability
    0.5, per layer."""
    layers = []
    for width, nxt in zip(widths[:-1], widths[1:]):
        b = grng.integers(0, nxt, width)
        c = grng.integers(0, nxt, width)
        mul = grng.random(width) < 0.5
        layers.append(gkr.CircuitLayer([
            gkr.Gate(gkr.GateType.MUL if m else gkr.GateType.ADD, (x, y))
            for x, y, m in zip(b.tolist(), c.tolist(), mul.tolist())
        ]))
    return gkr.Circuit(layers, widths[-1])


def field_inputs(seed: int, field, width: int):
    """A GKR circuit's inputs in ``field`` other than Goldilocks, drawn below
    p from the seed (the flagship's Goldilocks inputs come from its own
    generator, as benches/gkr_benchmark.py draws them)."""
    import numpy as np

    return np.random.default_rng(seed + 7).integers(0, field.p, width)


def gkr_layer_trace(circuit, inputs, field, layer: int, card: str = "") -> dict:
    """One per-layer GKR proof on the card (``gkr.generate_gkr_transcript``)
    with ``layer`` traced by the profiler, each of its rounds in a
    ``record_function`` range that ends in a sync (the round already ends in
    its host read): the layer's wall time, device busy time and idle share,
    and per round the device records that start in it, split into the
    port's kernels, plain-torch kernels and copies. Imports
    ``thaler_study_tpu_torch`` as ``sys.path`` finds it, so that
    ``scripts/k1_times.py`` runs it on any tree of the port."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from thaler_study_tpu_torch import gkr

    out = {}

    def step(name, at, j, fn):
        if at != layer or name not in ("layer", "round"):
            return fn()
        if name == "round":
            with record_function(f"gkr round {j}"):
                v = fn()
                torch.cuda.synchronize()
            return v
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            v = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans, busy_us = device_spans(prof, "gkr round ")
        ranges = [(e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == DeviceType.CPU and e.name.startswith("gkr round ")]
        per, plain = [], []
        for a, b in sorted(ranges):
            recs = [n for t, _, n in spans if a <= t <= b]
            copies = sum("Memcpy" in n or "Memset" in n for n in recs)
            port = sum(any(kn in n for kn in PORT_KERNELS) for n in recs)
            per.append((port, len(recs) - port - copies, copies))
            plain.append([n for n in recs if not ("Memcpy" in n or "Memset" in n
                                                  or any(kn in n for kn in PORT_KERNELS))])
        out.update(wall_ms=wall_ms, busy_ms=busy_us / 1e3, idle=1 - busy_us / 1e3 / wall_ms, records=len(spans),
                   per_round=per, plain=plain)
        return v

    torch.cuda.synchronize()
    gkr.generate_gkr_transcript(gkr.Prover(circuit, inputs, field), field, step=step)
    rounds = out["per_round"]
    # the sumcheck rounds alone: round k also builds phase 2's tables, and
    # round 2k - 1 is the final message
    k = circuit.num_vars_at(layer + 1)
    pure = [j for j in range(len(rounds)) if j not in (k, 2 * k - 1)]
    inner = [rounds[j] for j in pure]
    plain, names = out.pop("plain"), {}
    for j in pure:
        for n in plain[j]:
            names[n[:80]] = names.get(n[:80], 0) + 1
    out["plain_names"] = sorted(names.items(), key=lambda x: -x[1])[:4]
    out["plain_per_round"] = sum(r[1] for r in inner) / len(inner)
    out["copies_per_round"] = sum(r[2] for r in inner) / len(inner)
    # the final round: the last sumcheck round and the restriction
    # (restrict_poly: one evaluation launch since slice 20)
    out["restrict_round"] = rounds[2 * k - 1]
    restrict_names = sorted({n[:60] for n in plain[2 * k - 1]})
    log(f"GKR per-layer {field.name} trace of layer {layer}: {out['wall_ms']:.3f} ms wall (profiler on), "
        f"{out['records']} device records, busy {out['busy_ms']:.3f} ms, idle share {out['idle']:.1%}; per round "
        f"(port kernels, plain-torch kernels, copies): {rounds}; plain-torch kernels per sumcheck round "
        f"{out['plain_per_round']:.2f}, copies {out['copies_per_round']:.2f}; the plain-torch kernels of those "
        f"rounds by name {out['plain_names']}; the final round with the restriction {out['restrict_round']}, its "
        f"plain-torch kernels {restrict_names} {card}")
    return out


# the fused proof's device records by kernel (the first match of a name);
# line_fold_kernel is the line restriction of trees before the tiles
FUSED_KERNELS = ("libra_round_kernel", "phase_tables_kernel", "eq_table_kernel", "line_tile_kernel",
                 "line_fold_kernel", "gkr_final_tail_kernel", "bitrev_kernel", "Memcpy DtoH", "Memcpy HtoD")


def template_flag(name: str, kernel: str) -> bool:
    """Whether the last template argument of ``kernel`` in a record's name
    is true (K1's TAIL, the eq table's DOT)."""
    return name.split(kernel + "<", 1)[-1].split(">", 1)[0].endswith("true")


def fused_trace(gkr, circuit, inputs, field, prove=None):
    """One fused proof of a fresh prover under the profiler (``prove``:
    prover -> transcript, default ``gkr.generate_gkr_transcript_fused``):
    (wall ms, device records, busy us, device ms by kernel label, aten
    split)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prover = gkr.Prover(circuit, inputs, field)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if prove is None:
            gkr.generate_gkr_transcript_fused(prover, field)
        else:
            prove(prover)
        traced_ms = (time.perf_counter() - t0) * 1e3
    spans, busy_us = device_spans(prof)
    by_kernel = {}
    for s0, s1, name in spans:
        label = next((k_ for k_ in FUSED_KERNELS if k_ in name), "other")
        if label in ("libra_round_kernel", "eq_table_kernel") and template_flag(name, label):
            label += " TAIL" if label == "libra_round_kernel" else " DOT"
        ms_, n_ = by_kernel.get(label, (0.0, 0))
        by_kernel[label] = (ms_ + (s1 - s0) / 1e3, n_ + 1)
    return traced_ms, spans, busy_us, by_kernel, aten_split(prof)


def tail_by_round(spans, k: int, depth: int):
    """K1 with the round tail (TAIL) in a traced fused proof of ``depth``
    layers of k variables: each inner round's mean over the layers (us; 2k
    - 1 launches per layer, in issue order), or None where the trace does
    not hold them all."""
    tail_us = [s1 - s0 for s0, s1, name in spans
               if "libra_round_kernel<" in name and template_flag(name, "libra_round_kernel")]
    if not spans or len(tail_us) != depth * (2 * k - 1):
        return None
    return [statistics.mean(tail_us[j :: 2 * k - 1]) for j in range(2 * k - 1)]


def split_line(by_kernel, aten, top=14) -> str:
    """The trace's kernels and its largest aten ops as one log line."""
    kern = ", ".join(f"{k_} {v[0]:.3f} ms over {v[1]}" for k_, v in sorted(by_kernel.items()))
    ops = ", ".join(f"{op} {ms:.3f} ms over {n_}" for op, ms, n_ in aten[:top])
    total = sum(ms for _, ms, _ in aten)
    return (f"kernels: {kern}; plain torch by aten op ({total:.3f} ms over "
            f"{sum(n_ for _, _, n_ in aten)} calls): {ops or 'not measured (no device time in key_averages)'}")


def fused_trace_only(args, card: str) -> int:
    """--fused-trace-only: the flagship's fused proof traced, split by
    kernel and by aten op."""
    import numpy as np
    import torch

    from thaler_study_tpu_torch import _build, gkr
    from thaler_study_tpu_torch.fields import GOLDILOCKS

    _build.build()
    _build.load_host("native")
    width = 1 << args.gkr_log
    grng = np.random.default_rng(args.seed)
    circuit = gate_circuit(gkr, [width] * args.gkr_depth + [width], grng)
    inputs = grng.integers(0, 1 << 62, width)
    for _ in range(2):  # warm: caches, allocator
        gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, GOLDILOCKS), GOLDILOCKS)
    torch.cuda.synchronize()
    for run in range(2):
        traced_ms, spans, busy_us, by_kernel, aten = fused_trace(gkr, circuit, inputs, GOLDILOCKS)
        log(f"fused trace {run}: {traced_ms:.3f} ms wall (profiler on), device busy {busy_us / 1e3:.3f} ms over "
            f"{len(spans)} device records, idle share {1 - busy_us / 1e3 / traced_ms:.1%}; "
            f"{split_line(by_kernel, aten)} [{card}]")
    return 0


# ---- the multi-block slice: the triangle IP and the dense GKR W ----------
#
# Module-level so that a rehearsal can drive it with CPU tensors (dev =
# cpu): every kernel call, entry point and timer below goes through ``dev``,
# ``sync`` and the timers passed in.

TRI_BLOCKS = ((0, 1), (1, 2), (0, 2))
W_BLOCKS = ((0, 1), (0, 1), (0,), (1,))
W_TERMS = ((0, 2), (0, 3), (1, 2, 3))
FIELDS5 = ("GOLDILOCKS", "BABYBEAR", "F1572869", "F389", "F5")
# csrc/modmatmul.cu: each thread's pass of the K loop makes BK x TM x TN
# products (16 x 4 x 4)
MM_PRODUCTS_PER_LOOP = 256
# The modular matmul's operations bound holds the kernel to fixed counts of
# SASS instructions per product (all, IMAD-family), counted once in the K
# loop of csrc/modmatmul.cu's first version (cuobjdump -sass, sm_90a), so
# that a redesign is measured against the same yardstick; each run prints
# the current build's counts beside them.
MM_SASS_PER_PRODUCT = {"goldilocks": (28.390625, 12.59765625), "mont32": (9.37109375, 2.453125)}
# The tensor-core matmul's operations bound (csrc/modmatmul_tc.cu): P digit
# products of 8 bits per field product (8 x 8 bytes Goldilocks, 4 x 4
# mont32) at the card's dense int8 rate, 1,979 T operations/s = 989.5 T
# multiply-adds/s; each run prints the design's own pair count beside it.
TC_MACS_PER_S = 989.5e12
TC_PAIRS = {"goldilocks": 64, "mont32": 16}
# the slice's sizes: the triangle IP's main-path graph, its graphs over
# Goldilocks and BabyBear at BENCHMARKS.md config 4's scale, the graph held
# against device="cpu", and the wide dense-W GKR circuit (layers, log2 width)
TRI_NODES, TRI_NODES_SMALL, TRI_NODES_CMP = 4096, 1024, 256
WIDE_DEPTH, WIDE_LOG = 8, 11


def slice_words(gen, field, shape, dev, fill="random"):
    """Words of ``field`` (canonical Goldilocks, Montgomery mont32): random
    with boundary words first (0, 1, p - 1, p - 2 and, for mont32, their
    Montgomery images), or every word p - 1 (``fill="max"``: the largest
    word, the lazy accumulators' worst case), or every word p - 2
    (``fill="p-2"``: the Goldilocks word with most digits at 255,
    0xFFFFFFFEFFFFFFFF, the tensor-core digit sums' worst case)."""
    import torch

    from thaler_study_tpu_torch.fields import goldilocks as gl

    if field.backend == "goldilocks":
        if fill in ("max", "p-2"):
            return torch.full(shape, gl.to_i64(gl.P - (1 if fill == "max" else 2)), dtype=torch.int64, device=dev)
        lo = torch.randint(0, 1 << 32, shape, generator=gen, device=dev, dtype=torch.int64)
        hi = torch.randint(0, (1 << 32) - 1, shape, generator=gen, device=dev, dtype=torch.int64)
        x = (hi << 32) | lo
        edge = torch.tensor([gl.to_i64(v) for v in (0, 1, gl.P - 1, gl.P - 2)], dtype=torch.int64, device=dev)
    else:
        p = field.p
        if fill in ("max", "p-2"):
            return torch.full(shape, p - (1 if fill == "max" else 2), dtype=torch.int32, device=dev)
        x = torch.randint(0, p, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)
        e = [v % p for v in (0, 1, p - 1, p - 2)]
        edge = torch.tensor(e + [v * field.mont_r % p for v in e], dtype=torch.int32, device=dev)
    m = min(x.numel(), edge.numel())
    x.view(-1)[:m] = edge[:m]
    return x


def word_err(a, b) -> int:
    """0 when the word tensors are equal, else the largest |a - b| over
    (up to 64 of) the words that differ, as integers."""
    import torch

    from thaler_study_tpu_torch.fields.farray import tensor_u64

    if a.shape == b.shape and torch.equal(a, b):
        return 0
    if a.shape != b.shape:
        return 1 << 64
    diff = (a != b).nonzero()[:64]
    ua, ub = tensor_u64(a[tuple(diff.T)]), tensor_u64(b[tuple(diff.T)])
    return max(abs(int(x) - int(y)) for x, y in zip(ua, ub))


def folded_spec(spec, j):
    for _ in range(j):
        spec = spec.after_fold()
    return spec


def triangle_graph(n_nodes: int, seed: int, p: float = 0.05):
    """The symmetric G(n, p) of tests/test_reference_scales.py:78-83: the
    strict upper triangle drawn from ``default_rng(seed)``, mirrored."""
    import numpy as np

    upper = np.triu(np.random.default_rng(seed).random((n_nodes, n_nodes)) < p, k=1)
    return upper | upper.T


def six_delta(adj, dev) -> int:
    """trace(A^3) = 6 x the triangles, exactly: A^2 in float64 on ``dev``
    (entries are integers below n <= 2^13, every partial sum of the product
    and of the final sum an integer below 2^53, so no rounding occurs)."""
    import torch

    a = torch.from_numpy(adj.astype("float64")).to(dev)
    total = ((a @ a) * a).sum()
    if total.item() >= 2.0**53:
        raise AssertionError("trace(A^3) is beyond float64's exact integers")
    return int(total.item())


def triangle_launches(k: int, threshold: int):
    """The launches of one triangle proof over 3 blocks of k variables: the
    tensor-core matmul (c_1 and each contracted round: one per t, t = 1
    left out after round 0) and its digit pre-pass (B's planes once per
    round, A_t's per launch), none of the CUDA-core matmul; the multi-block
    round kernel (every other round; c_1 where it is not contracted), the
    multi-block fold (the contracted rounds after round 0)."""
    n = {"modmatmul": 0, "modmatmul_tc": 0, "modmatmul_digits": 0, "multiblock_round": 0, "multiblock_fold": 0}

    def contract(ts):
        n["modmatmul_tc"] += ts
        n["modmatmul_digits"] += 1 + ts

    if 1 << (3 * k) > threshold:
        contract(1)
    else:
        n["multiblock_round"] += 1
    for j in range(3 * k):
        x_left = k - j  # X variables before round j's sums
        grid = 1 << (x_left - 1 + 2 * k) if x_left >= 1 else 0
        if grid > threshold:
            contract(3 if j == 0 else 2)
            n["multiblock_fold"] += j > 0
        else:
            n["multiblock_round"] += 1
    return n


# the port's kernels by name (csrc/*.cu); every other kernel record of a
# trace is a plain-torch launch
PORT_KERNELS = ("mb_round_kernel", "mb_fold_kernel", "tc_kernel", "digits_kernel", "modmatmul_kernel",
                "round_kernel", "libra_round_kernel", "fs_tail_kernel", "sha_chain_kernel", "phase_tables_kernel",
                "eq_table_kernel", "line_tile_kernel", "gkr_final_tail_kernel", "libra_total_kernel",
                "gkr_round_tail_kernel", "row_sums_kernel", "leaf_kernel", "node_kernel", "top_kernel",
                "shard_rows_kernel", "build_kernel", "bitrev_kernel", "fold_kernel", "forward_kernel")


def triangle_trace(n_nodes: int, seed: int, card: str = "") -> dict:
    """Two traces of warm triangle proofs over Goldilocks on the card, with
    the ``thaler_study_tpu_torch`` first on ``sys.path`` (so that
    ``scripts/triangle_trace.py`` runs it on any tree of the port): one
    ``api.prove_triangle_count`` (MB's device records, their count and
    sum, the device idle share), and one proof driven round by round, each
    round synced inside a ``record_function`` range (the device records
    that start in it: the port's kernels, plain-torch kernels, copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from thaler_study_tpu_torch import api
    from thaler_study_tpu_torch.fiat_shamir import SumcheckInteractiveProver, generate_transcript
    from thaler_study_tpu_torch.fields import GOLDILOCKS
    from thaler_study_tpu_torch.protocols import TriangleG
    from thaler_study_tpu_torch.sumcheck import Prover

    k = (n_nodes - 1).bit_length()
    adj = triangle_graph(n_nodes, seed)
    for _ in range(2):  # warm: kernels built, caches, allocator
        api.prove_triangle_count(adj, n_nodes, GOLDILOCKS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.prove_triangle_count(adj, n_nodes, GOLDILOCKS)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, busy_us = device_spans(prof)
    mb = [(s1 - s0) / 1e3 for s0, s1, name in spans if "mb_round_kernel" in name]
    out = {"wall_ms": wall_ms, "records": len(spans), "busy_ms": busy_us / 1e3, "idle": 1 - busy_us / 1e3 / wall_ms,
           "mb_launches": len(mb), "mb_ms": sum(mb)}

    class Ranged(SumcheckInteractiveProver):
        def g_1(self):
            with record_function("tri round 0"):
                v = super().g_1()
                torch.cuda.synchronize()
            return v

        def round(self, j, r_j):
            with record_function(f"tri round {j}"):
                v = super().round(j, r_j)
                torch.cuda.synchronize()
            return v

    g = TriangleG.new_adj_matrix(2 * k, adj, GOLDILOCKS, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        generate_transcript(Ranged(Prover(g)), GOLDILOCKS)
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CPU and e.name.startswith("tri round ")}
    dev = [(s0, name) for s0, _, name in device_spans(prof, "tri round ")[0]]
    per = {}
    for name, (a, b) in ranges.items():
        recs = [n for t, n in dev if a <= t <= b]
        copies = sum("Memcpy" in n or "Memset" in n for n in recs)
        port = sum(any(kn in n for kn in PORT_KERNELS) for n in recs)
        per[name] = (port, len(recs) - port - copies, copies)
    phases = {"X": range(0, k), "Y": range(k, 2 * k), "Z": range(2 * k, 3 * k)}
    out["per_round"] = {ph: [per.get(f"tri round {j}", (None, None, None)) for j in js] for ph, js in phases.items()}
    for ph in ("Y", "Z"):
        plain = [p[1] for p in out["per_round"][ph] if p[1] is not None]
        out[f"plain_per_{ph}_round"] = sum(plain) / len(plain) if plain else None
    log(f"triangle trace, {n_nodes} nodes over Goldilocks (warm): api.prove_triangle_count {wall_ms:.3f} ms wall "
        f"(profiler on), {len(spans)} device records, busy {busy_us / 1e3:.3f} ms, idle share {out['idle']:.1%}; "
        f"MB (mb_round_kernel) {len(mb)} records, {sum(mb):.4f} ms in all; per round, driven round by round and "
        f"synced (port kernels, plain-torch kernels, copies): Y {out['per_round']['Y']}, Z {out['per_round']['Z']}, "
        f"X {out['per_round']['X']}; plain-torch kernels per Y round {out['plain_per_Y_round']}, per Z round "
        f"{out['plain_per_Z_round']} {card}")
    return out


def port_launches() -> int:
    """Every launch of the port's kernels so far, from the wrappers' counters
    (K1 with the round tail is counted once, as a launch of K1)."""
    from thaler_study_tpu_torch.gkr import device_tables
    from thaler_study_tpu_torch.ops import (cuda_round, forward_kernel, fs_kernel, gkr_tail, merkle_kernel, mle_kernel,
                                            modmatmul, multiblock, row_sums, shard_layout)

    counts = (cuda_round.launches, cuda_round.libra_launches, cuda_round.total_launches, fs_kernel.launches,
              multiblock.launches, multiblock.fold_launches, modmatmul.launches, modmatmul.tc_launches,
              modmatmul.digit_launches, modmatmul.total_launches, device_tables.launches, device_tables.eq_launches,
              device_tables.eq_dot_launches, device_tables.line_launches, device_tables.rows_launches,
              gkr_tail.final_launches, gkr_tail.round_launches, merkle_kernel.launches, row_sums.launches,
              shard_layout.launches, forward_kernel.launches, mle_kernel.bitrev_launches, mle_kernel.fold_launches,
              mle_kernel.eval_launches)
    return sum(sum(c.values()) for c in counts)


RANGE_GAP_S = 0.002  # idle host time around each traced range


def ranged_trace(run, targets) -> dict:
    """``run()`` under the profiler, each call of a method in ``targets``
    ((class, name, kind) triples; ``kind(self, *args)`` gives the call's
    (label, rounds)) inside a ``record_function`` range with a sync before
    and after: per label the rounds, the kernel launches the host issued
    in the ranges (the runtime's launch calls, on the host's clock like the
    ranges), the port's launches among them (its wrappers' counters), so
    the plain-torch launches as the difference, and the device records that
    start in the ranges (the port's kernels, the others by name, copies;
    the card's clock may place a short record outside its range, so these
    are a report, and the count of plain-torch launches is the host's).
    The host idles ``RANGE_GAP_S`` after the sync before a range and after
    its end, so that the records of the work just before and after a range
    (the sharded fused layer's gathers, launched the moment its rounds
    return) cannot be placed inside it by that clock's offset."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    saved, seq, port = [], [0], []

    def wrap(cls, name, kind):
        orig = getattr(cls, name)

        def ranged(self, *args, **kwargs):
            label, rounds = kind(self, *args)
            torch.cuda.synchronize()
            time.sleep(RANGE_GAP_S)
            with record_function(f"ranged {label} {rounds} {seq[0]}"):
                seq[0] += 1
                before = port_launches()
                out = orig(self, *args, **kwargs)
                torch.cuda.synchronize()
                port.append(port_launches() - before)
            time.sleep(RANGE_GAP_S)
            return out

        setattr(cls, name, ranged)
        saved.append((cls, name, orig))

    for target in targets:
        wrap(*target)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)
    events = list(prof.events())
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == DeviceType.CPU and e.name.startswith("ranged ")]
    calls = [e.time_range.start for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith(("cudaLaunch", "cuLaunch"))]
    started = [(e.time_range.start, e.name) for e in events
               if e.device_type == DeviceType.CUDA and not e.name.startswith("ranged ")]
    out = {}
    for a, b, rname in ranges:
        _, label, rounds, i = rname.split(" ")
        recs = [n for t, n in started if a <= t <= b]
        copies = [n for n in recs if "Memcpy" in n or "Memset" in n]
        ours = [n for n in recs if any(kn in n for kn in PORT_KERNELS)]
        others = [n for n in recs if n not in copies and n not in ours]
        o = out.setdefault(label, {"rounds": 0, "launched": 0, "port": 0, "records": 0, "others": 0, "copies": 0,
                                   "names": {}})
        o["rounds"] += int(rounds)
        o["launched"] += sum(a <= t <= b for t in calls)
        o["port"] += port[int(i)]
        o["records"] += len(ours)
        o["others"] += len(others)
        o["copies"] += len(copies)
        for n in others:
            o["names"][n[:70]] = o["names"].get(n[:70], 0) + 1
    return out


def check_ranged(what: str, out: dict, labels, card: str) -> None:
    """Log :func:`ranged_trace`'s counts per sharded round and raise unless
    every label in ``labels`` was traced and launched the port's kernels
    and no other kernel: the host's launch calls in its ranges equal the
    port's launches, and no device record of another kernel starts in
    them."""
    parts = []
    for label in labels:
        o = out.get(label)
        if o is None or not o["rounds"]:
            raise AssertionError(f"{what}: no traced {label} round")
        r, plain = o["rounds"], o["launched"] - o["port"]
        parts.append(f"{label} {r} rounds: per round {o['port'] / r:.2f} launches of the port's kernels, "
                     f"{plain / r:.2f} plain-torch launches ({o['launched']} launch calls in all), device records "
                     f"{o['records'] / r:.2f} of the port, {o['others'] / r:.2f} others, {o['copies'] / r:.2f} copies")
        if plain or o["others"] or not o["port"]:
            raise AssertionError(f"{what}, {label} rounds: {o['launched']} launch calls for {o['port']} of the "
                                 f"port's, other device records {o['names']}")
    log(f"{what}, traced sharded rounds (each synced): {'; '.join(parts)} {card}")


def sass_functions(lib: str, kernel: str):
    """The SASS of each function in ``lib`` whose name holds ``kernel``
    (``cuobjdump -sass``), each from its name line on; raises where the SASS
    cannot be read or holds no such function."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], check=True, capture_output=True, text=True).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", text)[1:] if kernel in f.split("\n", 1)[0]]
    if not funcs:
        raise AssertionError(f"no {kernel} in the SASS of {lib}")
    return funcs


def gmma_count(lib: str, kernel: str) -> int:
    """Warpgroup MMA instructions (``*GMMA*``) in the SASS of ``kernel``'s
    instantiations in ``lib``."""
    import re

    return sum(len(re.findall(r"\b[A-Z]*GMMA\b", f)) for f in sass_functions(lib, kernel))


def sass_per_product(lib: str, kernel: str, backend_tag: str, products: int):
    """Instructions in the largest loop of ``kernel``'s SASS in ``lib``
    (the instantiation whose name holds ``backend_tag``), per product of
    that loop body: (all instructions, IMAD-family instructions)."""
    import re

    body = next((f for f in sass_functions(lib, kernel) if backend_tag in f.split("\n", 1)[0]), None)
    if body is None:
        raise AssertionError(f"no {kernel} ({backend_tag}) in the SASS of {lib}")
    ins = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    best = (0, 0, 0)
    for addr, op, rest in ins:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            loop = [o for a, o, _ in ins if int(t.group(1), 16) <= a <= addr and not o.startswith("NOP")]
            if len(loop) > best[0]:
                best = (len(loop), sum(o.startswith("IMAD") for o in loop), addr)
    if not best[0]:
        raise AssertionError(f"no loop in the SASS of {kernel} ({backend_tag})")
    return best[0] / products, best[1] / products


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock (``nvidia-smi``); raises where it cannot
    be read."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
                         check=True, capture_output=True, text=True)
    return float(out.stdout.strip())


def outputs_err(a, b) -> int:
    """``word_err`` over two outputs of a wrapper: tensors, None, or
    (nested) lists and tuples of them."""
    if a is None or b is None:
        return 0 if a is None and b is None else 1 << 64
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return 1 << 64
        return max([0] + [outputs_err(x, y) for x, y in zip(a, b)])
    return word_err(a, b)


def multiblock_slice(seed, tag, dev, sync, graph_ms, time_ms, reset_counts, read_counts, tri_nodes=TRI_NODES,
                     tri_nodes_small=TRI_NODES_SMALL, tri_nodes_cmp=TRI_NODES_CMP, wide_depth=WIDE_DEPTH,
                     wide_log=WIDE_LOG):
    """Phases 2-4 of the multi-block slice; returns its rows of the
    ``kernels`` line. ``reset_counts`` / ``read_counts`` set to 0 and read
    every launch counter of the port; the sizes default to the slice's own
    (a CPU rehearsal passes smaller ones)."""
    import time

    import numpy as np
    import torch

    from thaler_study_tpu_torch import _build, api, gkr
    from thaler_study_tpu_torch import fields as tf
    from thaler_study_tpu_torch.fiat_shamir import (
        FiatShamirTranscript,
        SerializationError,
        SumcheckInteractiveProver,
        generate_transcript,
    )
    from thaler_study_tpu_torch.fields import GOLDILOCKS, BABYBEAR, F389, FArray
    from thaler_study_tpu_torch.ops import mle_kernel, modmatmul, multiblock
    from thaler_study_tpu_torch.ops import round_kernel as rk
    from thaler_study_tpu_torch.protocols import TriangleG
    from thaler_study_tpu_torch.sumcheck import Prover, SumCheckError

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 8)
    fields = [getattr(tf, name) for name in FIELDS5]
    err = {}

    def note_err(key, e, what):
        if e:
            raise AssertionError(f"{key[0]} kernel != plain ({key[1]}): {what}")
        err[key] = max(err.get(key, 0), e)

    # ---- phase 2: the multi-block round kernel against its plain version ----
    k_tri, k_w, n1 = 4, 5, 10
    start = {
        "triangle": rk.PolySpec((k_tri,) * 3, TRI_BLOCKS, ((0, 1, 2),)),
        "dense W": rk.PolySpec((k_w, k_w), W_BLOCKS, W_TERMS),
        "k = 1": rk.single_block_spec(1, n1),
        "k = 4": rk.single_block_spec(4, n1),
        "scalar": rk.PolySpec((n1,), ((0,), (0,), ()), ((0, 2), (1,), (0, 1, 2))),
    }
    # the folds before each checked round: every block transition of the
    # triangle (X with 4, 3, 2, 1 bits left, X -> Y, Y with 1 left, Y -> Z, Z)
    # and of dense W (b, b -> c, c)
    states = {"triangle": (0, 1, 2, 3, 4, 6, 7, 8, 10), "dense W": (0, 2, 4, 5, 8),
              "k = 1": (0, 3), "k = 4": (0, 3), "scalar": (0, 3)}
    for field in fields:
        key = ("multiblock_round", field.backend)
        checks = 0
        for name, spec0 in start.items():
            for j in states[name]:
                spec = folded_spec(spec0, j)
                for fold in (False, True):
                    if fold and spec.num_vars() < 2:
                        continue
                    post = spec.after_fold() if fold else spec
                    degree = post.degree()
                    plan = multiblock.round_plan(spec, fold, post.terms, degree)
                    for fill in ("random", "max"):
                        tables = [slice_words(gen, field, (rk._table_size(spec, t),), dev, fill)
                                  for t in range(len(spec.table_blocks))]
                        r = slice_words(gen, field, (1,), dev, fill) if fold else None
                        claim = slice_words(gen, field, (1,), dev, fill)
                        # skip-1 off; on with the claim (s(1) = claim - s(0)); on without (s(1) = 0)
                        for skip, cl in ((False, None), (True, claim), (True, None)) if degree >= 1 else ((False, None),):
                            folded, sums = multiblock.round_sums(plan, tables, r, field, skip, cl)
                            ref_f, ref = multiblock.round_sums_plain(plan, tables, r, field, skip, cl)
                            sync()
                            e = max([word_err(sums, ref)] + [word_err(a, b) for a, b in zip(folded, ref_f)
                                                             if a is not None or b is not None])
                            note_err(key, e, f"{name} after {j} folds, fold={fold} skip={skip} claim="
                                             f"{cl is not None} {fill} ({multiblock.kernel_class(plan)})")
                            checks += 1
                    if fold:  # the flat fold of the same tables
                        halves = [rk._table_size(spec, t) // 2 if 0 in tb else 0
                                  for t, tb in enumerate(spec.table_blocks)]
                        got = multiblock.fold_tables(tables, halves, r, field)
                        want = multiblock.fold_tables_plain(tables, halves, r, field)
                        sync()
                        note_err(("multiblock_fold", field.backend),
                                 max(word_err(a, b) for a, b in zip(got, want)), f"{name} after {j} folds")
        log(f"multi-block round kernel == plain (exact) over {field.name} in {checks} cases: the triangle spec "
              f"(k = {k_tri}) at every block transition, dense W (k = {k_w}) in both phases, single-block k = 1, "
              f"k = 4 and a scalar-table product (n = {n1}); fold on / off, skip-1 off / on with the claim / on "
              f"without, random and p - 1 words, s(0..D) and the folded tables; the flat fold kernel on the same "
              f"tables")

    # ---- phase 2: the modular matmuls against their plain versions ---------
    # the CUDA-core kernel (csrc/modmatmul.cu) and the tensor-core kernel
    # (csrc/modmatmul_tc.cu) each at every shape, in every mode, whatever the
    # routing rule would pick; the tensor-core kernel also at M = 1, a ragged
    # N and K at its flush length K_c and K_c + 1, and its digit pre-pass
    shapes = ((1, 1, 1), (5, 7, 3), (63, 65, 17), (64, 64, 64), (129, 1, 4096), (100, 130, 4096))
    for field in fields:
        kc = modmatmul.FLUSH_K[field.backend]
        tc_shapes = shapes + ((1, 300, 520), (33, 200, 96), (3, 5, kc), (3, 5, kc + 1))
        tc_tile, cc_tile = modmatmul.tile(field, True), modmatmul.tile(field, False)
        checks = {"cc": 0, "tc": 0, "digits": 0}
        for m, n, kk in tc_shapes:
            for fill in ("random", "max", "p-2"):
                a = slice_words(gen, field, (2 * m, kk), dev, fill)
                b = slice_words(gen, field, (n, kk), dev, fill)
                d = slice_words(gen, field, (2 * m, n), dev, fill)
                fa, fb = FArray(a[:m], field), FArray(b, field)
                c_ref = modmatmul.modmatmul_plain(fa, fb).data
                kernels = [("tc", "modmatmul_tc", modmatmul.modmatmul_tc, modmatmul.contract_partials_tc, tc_tile)]
                if (m, n, kk) in shapes and fill != "p-2":
                    kernels.append(("cc", "modmatmul", modmatmul.modmatmul_cc, modmatmul.contract_partials_cc,
                                    cc_tile))
                for tag_, name, mm_fn, contract_fn, tiles in kernels:
                    key = (name, field.backend)
                    c = mm_fn(fa, fb).data
                    sync()
                    note_err(key, word_err(c, c_ref), f"C = A B^T at {m} x {n} x {kk} {fill}")
                    for t in (None, 0, 1, 2, 3):
                        aa, dd = (a[:m], d[:m]) if t is None else (a, d)
                        got = contract_fn(aa, b, dd, field, t)
                        want = modmatmul.contract_partials_plain(aa, b, dd, field, t, tiles)
                        sync()
                        note_err(key, word_err(got, want), f"contraction at {m} x {n} x {kk}, t={t} {fill}")
                    checks[tag_] += 6
                for t in (None, 3):
                    got = modmatmul.digit_planes(a if t is not None else a[:m], field, t)
                    want = modmatmul.digit_planes_plain(a if t is not None else a[:m], field, t)
                    sync()
                    note_err(("modmatmul_digits", field.backend), word_err(got, want),
                             f"digit planes of {m if t is None else 2 * m} x {kk}, t={t} {fill}")
                    checks["digits"] += 1
        # the routing: a CUDA tensor at any shape reaches the tensor-core kernel
        for m, n, kk in (shapes[1], shapes[-1]):
            a, b, d = (slice_words(gen, field, shape, dev) for shape in ((m, kk), (n, kk), (m, n)))
            before = (modmatmul.tc_launches[field.backend], modmatmul.launches[field.backend])
            routed = modmatmul.contract_partials(a, b, d, field)
            c = modmatmul.modmatmul(FArray(a, field), FArray(b, field)).data
            sync()
            after = (modmatmul.tc_launches[field.backend], modmatmul.launches[field.backend])
            if dev.type == "cuda" and (after[0] != before[0] + 2 or after[1] != before[1]):
                raise AssertionError(f"contract_partials or modmatmul at {m} x {n} x {kk} did not take the "
                                     "tensor-core kernel")
            note_err(("modmatmul_tc", field.backend),
                     word_err(routed, modmatmul.contract_partials_plain(a, b, d, field, None, tc_tile)),
                     f"routed contraction at {m} x {n} x {kk}")
            note_err(("modmatmul_tc", field.backend),
                     word_err(c, modmatmul.modmatmul_plain(FArray(a, field), FArray(b, field)).data),
                     f"routed C = A B^T at {m} x {n} x {kk}")
        log(f"modular matmul kernels == plain (exact) over {field.name}: the CUDA-core kernel in {checks['cc']} cases "
            f"(M, N, K) in {shapes}; the tensor-core kernel in {checks['tc']} cases, also at M = 1, a ragged N and "
            f"K = K_c = {kc} and K_c + 1 (its flush); C = A B^T and the contraction's partials (no view, views at "
            f"t = 0..3), random, p - 1 and p - 2 words; its digit pre-pass in {checks['digits']} cases; "
            f"contract_partials and modmatmul at {shapes[1]} and {shapes[-1]} routed to the tensor cores")

    # ---- phase 3: the triangle IP at full size ------------------------------
    thr = rk.CONTRACT_THRESHOLD

    class TimedProver(SumcheckInteractiveProver):
        """The FS adapter with each round synced and timed."""

        def __init__(self, prover):
            super().__init__(prover)
            self.round_s = []

        def g_1(self):
            t0 = time.perf_counter()
            out = super().g_1()
            sync()
            self.round_s.append(time.perf_counter() - t0)
            return out

        def round(self, j, r_j):
            t0 = time.perf_counter()
            out = super().round(j, r_j)
            sync()
            self.round_s.append(time.perf_counter() - t0)
            return out

    def rejects(adj, n_nodes, t, field) -> bool:
        try:
            return not api.verify_triangle_count(adj, n_nodes, t, field, device=dev)
        except (SumCheckError, SerializationError, ValueError):
            return True

    def triangle_run(n_nodes, field, seed, main_path=False):
        k = (n_nodes - 1).bit_length()
        t0 = time.perf_counter()
        adj = triangle_graph(n_nodes, seed)
        graph_s = time.perf_counter() - t0
        six = six_delta(adj, dev)
        # split by step (each round synced): input building, c_1, X, Y, Z
        t0 = time.perf_counter()
        g = TriangleG.new_adj_matrix(2 * k, adj, field, device=dev)
        sync()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        prover = TimedProver(Prover(g))
        sync()
        c1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        split_t = generate_transcript(prover, field)
        rounds_total = time.perf_counter() - t0
        phase = [sum(prover.round_s[i * k:(i + 1) * k]) for i in range(3)]
        hash_s = rounds_total - sum(phase)
        # the entry points, the launch counts set to 0 just before
        sync()
        reset_counts()
        t0 = time.perf_counter()
        claim, t = api.prove_triangle_count(adj, n_nodes, field, device=dev)
        prove_s = time.perf_counter() - t0
        counts = read_counts()
        want = triangle_launches(k, thr)
        got = {name: counts[name][field.backend] for name in want}
        if counts["mle_bitrev"][field.backend] != 1:
            raise AssertionError(f"triangle {n_nodes} {field.name}: {counts['mle_bitrev']} bit reversals, expected "
                                 "one (the input building)")
        # the main path's kernels all launch; the CUDA-core matmul is on no
        # path
        if got != want or (main_path and not all(v for name, v in got.items() if name != "modmatmul")):
            raise AssertionError(f"triangle {n_nodes} {field.name}: launches {got}, expected {want}")
        if claim != six % field.p:
            raise AssertionError(f"triangle {n_nodes} {field.name}: 6 Delta {claim} != trace(A^3) = {six}")
        if t.to_bytes() != split_t.to_bytes():
            raise AssertionError(f"triangle {n_nodes} {field.name}: two proofs of one graph differ")
        t0 = time.perf_counter()
        ok = api.verify_triangle_count(adj, n_nodes, t, field, device=dev)
        verify_s = time.perf_counter() - t0
        bad = [bytearray(m) for m in t.g]
        bad[len(bad) // 2][-1] ^= 1
        if not ok or not rejects(adj, n_nodes, FiatShamirTranscript([bytes(m) for m in bad]), field):
            raise AssertionError(f"triangle {n_nodes} {field.name}: accepted {ok}, tampered copy not rejected")
        if main_path:
            # the input building by step, each synced: the host's widening
            # to 0/1 words, their upload, the bit reversal on the card
            parts = dict.fromkeys(("widen", "upload", "bitrev"), 0.0)
            t0 = time.perf_counter()
            flat = (np.asarray(adj).reshape(-1) != 0).astype(np.uint64)
            parts["widen"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            x = FArray.from_ints(flat, field, device=dev)
            sync()
            parts["upload"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rev = mle_kernel.bitrev(x, 2 * k)
            sync()
            parts["bitrev"] = time.perf_counter() - t0
            if not torch.equal(rev.data, TriangleG.new_adj_matrix(2 * k, adj, field, device=dev).tables[0].data):
                raise AssertionError(f"triangle {n_nodes}: the input building by step != TriangleG.new_adj_matrix")
            log(f"triangle IP, {n_nodes} nodes, input building by step (host clock, 2^{2 * k} words): widening on the "
                f"host {parts['widen'] * 1e3:.2f} ms, upload {parts['upload'] * 1e3:.2f} ms, bit reversal "
                f"{parts['bitrev'] * 1e3:.3f} ms {tag}")
            del flat, x, rev
        log(f"triangle IP, {n_nodes} nodes (G(n, 0.05), {int(adj.sum()) // 2} edges, {3 * k} variables, tables "
              f"of 2^{2 * k}) over {field.name}: 6 Delta = {claim} == trace(A^3) (float64 on the card); "
              f"api.prove_triangle_count {prove_s:.3f} s, verify_triangle_count {verify_s:.3f} s, accepted, a "
              f"tampered copy rejected; launches {got}; split (each round synced): graph drawn (numpy) "
              f"{graph_s:.3f} s, input building (TriangleG.new_adj_matrix) {build_s:.3f} s, c_1 {c1_s:.3f} s, "
              f"X phase {phase[0]:.3f} s, Y {phase[1]:.3f} s, Z {phase[2]:.3f} s, hashing {hash_s:.3f} s; "
              f"per round (s) {[round(x, 4) for x in prover.round_s]} {tag}")
        return {"launches": got, "prove_s": prove_s, "verify_s": verify_s, "build_s": build_s, "c1_s": c1_s,
                "phases": phase, "hash_s": hash_s, "adj": adj, "transcript": t}

    n_big, n_mid = tri_nodes, tri_nodes_small
    runs = {}
    runs[("big", "goldilocks")] = triangle_run(n_big, GOLDILOCKS, seed, main_path=True)
    big = runs[("big", "goldilocks")]
    runs[("mid", "goldilocks")] = triangle_run(n_mid, GOLDILOCKS, seed + 1)
    runs[("mid", "mont32")] = triangle_run(n_mid, BABYBEAR, seed + 1)
    del big["adj"], big["transcript"]
    # a smaller proof on the card byte-identical to device="cpu"
    n_cmp = tri_nodes_cmp
    adj = triangle_graph(n_cmp, seed + 2)
    t_card = api.prove_triangle_count(adj, n_cmp, GOLDILOCKS, device=dev)
    t0 = time.perf_counter()
    t_cpu = api.prove_triangle_count(adj, n_cmp, GOLDILOCKS, device="cpu")
    cpu_s = time.perf_counter() - t0
    if t_card[0] != t_cpu[0] or t_card[1].to_bytes() != t_cpu[1].to_bytes():
        raise AssertionError(f"triangle {n_cmp} nodes: the card's proof != device='cpu'")
    log(f"triangle IP, {n_cmp} nodes over Goldilocks: the card's transcript byte-identical to device='cpu' "
          f"({len(t_card[1].to_bytes())} bytes; the CPU plain versions took {cpu_s:.2f} s)")

    # ---- phase 3: the dense GKR W -------------------------------------------
    def gkr_accepts(t, circuit, inputs, field) -> bool:
        try:
            return gkr.verify_gkr_transcript(t, gkr.Verifier(circuit, field), inputs, field)
        except (gkr.GKRError, SumCheckError, SerializationError, ValueError):
            return False

    def dense_launches(circuit):
        """Per layer of k variables: c_1 and rounds 0..k (two blocks before
        the fold) on the multi-block kernel; rounds k + 1..2k - 1 (W_b a
        scalar: the LibraW phase-2 shape) on K1."""
        ks = [circuit.num_vars_at(i + 1) for i in range(len(circuit.layers))]
        return {"multiblock_round": sum(k + 2 for k in ks), "libra_round": sum(max(k - 1, 0) for k in ks)}

    mixed = [4, 1 << 12, 2, 1 << 10, 1 << 6, 1 << 8]
    cases = [("book circuit", F389, None), ("5-layer mixed-width circuit", GOLDILOCKS, mixed),
             ("5-layer mixed-width circuit", BABYBEAR, mixed),
             (f"{wide_depth} x 2^{wide_log} circuit", GOLDILOCKS, [1 << wide_log] * (wide_depth + 1))]
    for label, field, widths in cases:
        if widths is None:
            circuit, inputs = gkr.circuit_from_book(), [3, 2, 3, 1]
        else:
            srng = np.random.default_rng(seed + 2)
            circuit = gate_circuit(gkr, widths, srng)
            inputs = [field.p - 1] + srng.integers(0, min(field.p, 1 << 62), widths[-1] - 1).tolist()
        felts = field.felts(inputs)
        sync()
        reset_counts()
        t0 = time.perf_counter()
        t_dense = gkr.generate_gkr_transcript(gkr.Prover(circuit, felts, field, use_linear=False, device=dev), field)
        dense_s = time.perf_counter() - t0
        counts = read_counts()
        got = {name: counts[name][field.backend] for name in dense_launches(circuit)}
        if got != dense_launches(circuit):
            raise AssertionError(f"dense W {label}: launches {got}, expected {dense_launches(circuit)}")
        t0 = time.perf_counter()
        t_lin = gkr.generate_gkr_transcript(gkr.Prover(circuit, felts, field, device=dev), field)
        lin_s = time.perf_counter() - t0
        same = [t_dense.to_bytes() == t_lin.to_bytes()]
        if field is F389:
            t_cpu = gkr.generate_gkr_transcript(gkr.Prover(circuit, felts, field, use_linear=False, device="cpu"),
                                                field)
            same.append(t_dense.to_bytes() == t_cpu.to_bytes())
        else:
            t_cpu = gkr.generate_gkr_transcript(gkr.Prover(circuit, felts, field, device="cpu"), field)
            same.append(t_dense.to_bytes() == t_cpu.to_bytes())
        if not all(same):
            raise AssertionError(f"dense W {label} {field.name}: transcripts differ {same}")
        bad = [bytearray(m) for m in t_dense.g]
        bad[len(bad) // 2][-1] ^= 1
        if not gkr_accepts(t_dense, circuit, felts, field) or gkr_accepts(
                gkr.GKRTranscript([bytes(m) for m in bad]), circuit, felts, field):
            raise AssertionError(f"dense W {label} {field.name}: honest rejected or tampered accepted")
        log(f"GKR dense W (use_linear=False), {label} {field.name} (widths "
              f"{[len(l) for l in circuit.layers] + [circuit.num_inputs]}): byte-identical to the LibraW run on the "
              f"card and to {'the dense W' if field is F389 else 'the LibraW'} run on device='cpu' "
              f"({len(t_dense.g)} messages), accepted, a tampered copy rejected; prove {dense_s:.3f} s "
              f"(LibraW {lin_s:.3f} s); launches {got} {tag}")

    # ---- phase 4: the two kernels at the path's shapes ----------------------
    from thaler_study_tpu_torch.mle.dense import bitrev

    k_big = (n_big - 1).bit_length()
    adj_mle = FArray(slice_words(gen, GOLDILOCKS, (1 << (2 * k_big),), dev), GOLDILOCKS)
    log(f"bit reversal of the {n_big}-node adjacency MLE (2^{2 * k_big} entries, one launch of the bit-reversal "
        f"kernel): {time_ms(lambda: bitrev(adj_mle, 2 * k_big), 3):.3f} ms per call (CUDA events, host issue "
        f"included) {tag}")
    del adj_mle
    log("library_ms is null in the slice's rows: no PyTorch call computes a matrix product mod p, a fold mod p "
        "or a sumcheck round's sums mod p")
    # a warm main-path proof traced: MB's launches and their sum, the
    # plain-torch launches per Y and Z round, the device idle share
    if dev.type == "cuda":
        triangle_trace(n_big, seed, tag)
    else:
        log("triangle trace: not measured (no card)")

    def timed_vs_plain(key, what, kernel, plain, plain_reps, count=20):
        """(kernel ms from a CUDA graph, plain ms). The wrapper runs once
        outside the graph on the inputs it is timed on; its output is held
        word for word against the plain version's from its timing run, so
        that max_abs_err covers the main path's shapes."""
        got, out = kernel(), [None]

        def run_plain():
            out[0] = plain()

        plain_ms = time_ms(run_plain, plain_reps)
        sync()
        note_err(key, outputs_err(got, out[0]), f"{what}, at the path's shape")
        del got, out
        return graph_ms(kernel, count=count), plain_ms

    rows = []
    props = torch.cuda.get_device_properties(0) if dev.type == "cuda" else None
    sms = props.multi_processor_count if props else 132
    clock_mhz = max_sm_clock_mhz()
    checked = []
    sass = {}
    if dev.type == "cuda":
        for backend, tag_ in (("goldilocks", "GlOps"), ("mont32", "M32Ops")):
            sass[backend] = sass_per_product(str(_build._library_path("modmatmul")), "modmatmul_kernel", tag_,
                                             MM_PRODUCTS_PER_LOOP)
        gmma = gmma_count(str(_build._library_path("modmatmul_tc")), "tc_kernel")
        if not gmma:
            raise AssertionError("the tensor-core kernel's SASS holds no warpgroup MMA instruction")
    else:
        gmma = None

    def contraction_times(field, n_nodes, label, xh, side, extras):
        """Both modular matmuls at an X round's contraction (M = xh, N = K =
        side, views at t = 2 and the dot; B = f2), each held word for word
        against one plain run and timed from CUDA graphs, beside their
        bounds; with ``extras`` also the epilogue probe and torch._int_mm.
        Returns the tensor-core kernel's and B's digit pass's (ms, plain ms,
        bound ms, bound_by)."""
        backend = field.backend
        wb, nd, pairs, fixed = (8 if backend == "goldilocks" else 4, modmatmul.DIGITS[backend], TC_PAIRS[backend],
                                MM_SASS_PER_PRODUCT[backend])
        a = slice_words(gen, field, (2 * xh, side), dev)
        b = slice_words(gen, field, (side, side), dev)
        d = slice_words(gen, field, (2 * xh, side), dev)
        planes = modmatmul.digit_planes(b, field)
        got = {"tc": modmatmul.contract_partials_tc(a, b, d, field, 2, planes),
               "cc": modmatmul.contract_partials_cc(a, b, d, field, 2)}
        out = [None]

        def run_plain():
            out[0] = modmatmul.contract_products_plain(a, b, d, field, 2)

        plain = time_ms(run_plain, 1)
        sync()
        what = f"{n_nodes}-node triangle X phase {label}, at the path's shape"
        note_err(("modmatmul_tc", backend), word_err(got["tc"], modmatmul.tile_sums(out[0], modmatmul.tile(field, True))),
                 what)
        note_err(("modmatmul", backend), word_err(got["cc"], modmatmul.tile_sums(out[0], modmatmul.tile(field, False))),
                 what)
        plain_digits = time_ms(lambda: modmatmul.digit_planes_plain(b, field), 1)
        note_err(("modmatmul_digits", backend), word_err(planes, modmatmul.digit_planes_plain(b, field)), what)
        del got, out
        cc_ms = graph_ms(lambda: modmatmul.contract_partials_cc(a, b, d, field, 2), count=3 if xh > 64 else 10)
        tc_ms = graph_ms(lambda: modmatmul.contract_partials_tc(a, b, d, field, 2, planes), count=10)
        a_digits_ms = graph_ms(lambda: modmatmul.digit_planes(a, field, 2), count=10)
        b_digits_ms = graph_ms(lambda: modmatmul.digit_planes(b, field), count=10)
        # library_ms of B's digit planes: the same planes as one torch call
        # sequence (view as bytes, permute, pad to Kp, copy)
        kp = modmatmul.padded_k(side)
        lib_digits_ms = graph_ms(lambda: torch.nn.functional.pad(
            b.view(torch.uint8).reshape(side, side, nd).permute(2, 0, 1), (0, kp - side)).contiguous(), count=10)
        products = xh * side * side
        # A's and D's halves and B read once, the partials written
        words = 4 * xh * side + side * side
        cc_bytes_ms = (words + modmatmul.tile_count(field, False, xh, side)) * wb / PEAK_BYTES_PER_S * 1e3
        cc_ops_ms = products * max(fixed[0] / 128, fixed[1] / 64) / (sms * clock_mhz * 1e6) * 1e3
        cc_bound = max(cc_bytes_ms, cc_ops_ms)
        tc_bytes_ms = (words + modmatmul.tile_count(field, True, xh, side)) * wb / PEAK_BYTES_PER_S * 1e3
        tc_ops_ms = products * pairs / TC_MACS_PER_S * 1e3
        tc_bound = max(tc_bytes_ms, tc_ops_ms)
        # the pre-pass over B: words read, D bytes per word written
        dig_bound = side * side * (wb + nd) / PEAK_BYTES_PER_S * 1e3
        ts = 3 if label == "round 0" else 2
        checked.append(f"modular matmuls {field.name} {n_nodes} nodes {label} (M = {xh}, N = K = {side})")
        log(f"{field.name} modular matmul, {n_nodes}-node triangle X phase {label} (M = {xh}, N = K = {side}, grid "
            f"2^{products.bit_length() - 1}, views at t = 2 and the dot), from CUDA graphs: tensor cores {tc_ms:.4f} "
            f"ms per launch (its A_t digit pass alone {a_digits_ms:.4f} ms; {products / tc_ms / 1e6:.1f} G "
            f"products/s), operations bound {tc_ops_ms:.4f} ms ({products} products x {pairs} digit pairs, the "
            f"design's own count {nd} x {nd} = {nd * nd}, at 989.5 T int8 multiply-adds/s), bytes bound "
            f"{tc_bytes_ms:.4f} ms: {tc_bound / tc_ms:.1%} of the bound; B's digit planes {b_digits_ms:.4f} ms once "
            f"per round (bytes bound {dig_bound:.4f} ms: {dig_bound / b_digits_ms:.1%}; plain torch "
            f"{plain_digits:.2f} ms; the same planes by view, permute, pad and copy {lib_digits_ms:.4f} ms from a "
            f"CUDA graph); CUDA cores {cc_ms:.4f} ms ({products / cc_ms / 1e6:.1f} G products/s), "
            f"operations bound {cc_ops_ms:.4f} ms ({fixed} SASS instructions (all, IMAD-family) per product, the "
            f"fixed yardstick; this build's K loop: {sass.get(backend)}; at 128 instructions and 64 IMAD per clock "
            f"per SM, {sms} SMs, {clock_mhz} MHz: the maximum SM clock), bytes bound {cc_bytes_ms:.4f} ms: "
            f"{cc_bound / cc_ms:.1%} of the bound; tensor cores {cc_ms / tc_ms:.1f}x faster per launch, per round "
            f"of {ts} launches {b_digits_ms + ts * tc_ms:.4f} ms (B's planes included) against {ts * cc_ms:.4f} ms; "
            f"plain torch {plain:.2f} ms; both == plain; {gmma} warpgroup MMA instructions in the tensor-core "
            f"kernel's SASS {tag}")
        if extras:
            # what the epilogue costs: the same M and N at K = 128, one
            # stage of products (1/(K/128) of them) and the whole epilogue
            kp = 128
            ak, bk = a[:, :kp].contiguous(), b[:, :kp].contiguous()
            bk_planes = modmatmul.digit_planes(bk, field)
            probe_ms = graph_ms(lambda: modmatmul.contract_partials_tc(ak, bk, d, field, 2, bk_planes), count=10)
            log(f"{field.name} {n_nodes}-node round 0, epilogue probe: the tensor-core kernel at M = {xh}, N = "
                f"{side}, K = {kp} (one stage of products, the same D_t reads, recombination and dot): "
                f"{probe_ms:.4f} ms, against {tc_ms:.4f} ms at K = {side} ({tc_ms * kp / side:.4f} ms of it per "
                f"{kp} of K) {tag}")
            del ak, bk, bk_planes
        if extras and dev.type == "cuda":
            # a yardstick, not library_ms: cuBLAS's int8 product over the
            # same digit planes, D^2 pair grids and no recombination
            try:
                x = modmatmul.digit_planes(a, field, 2).view(torch.int8).reshape(nd * xh, -1)
                y = planes.view(torch.int8).reshape(nd * side, -1).t()
                int_mm_ms = graph_ms(lambda: torch._int_mm(x, y), count=3)
                log(f"{field.name} {n_nodes}-node round 0: torch._int_mm over the same digit planes ([{nd * xh}, "
                    f"{x.shape[1]}] x [{x.shape[1]}, {nd * side}] int8 -> int32, the same multiply-adds, no "
                    f"recombination) {int_mm_ms:.4f} ms from a CUDA graph {tag}")
                del x, y
            except (RuntimeError, AttributeError) as exc:
                log(f"{field.name} {n_nodes}-node round 0: torch._int_mm yardstick not measured ({exc})")
        del a, b, d, planes
        return ((tc_ms, plain, tc_bound, "operations" if tc_ops_ms >= tc_bytes_ms else "bytes", None),
                (b_digits_ms, plain_digits, dig_bound, "bytes", lib_digits_ms))

    def mb_bound(plan, backend, wb, skip):
        """MB's least time for one round of ``plan``: the larger of its bytes
        (each table read once, before the fold; each folded entry and
        s(0..D) written once) at 3.35 TB/s and its products (one per folded
        entry written, plus, per summed t and per term of two or more
        factors, one per point of the term's grid) at the IMAD-family count
        per product of MM_SASS_PER_PRODUCT, 64 IMAD per clock per SM.
        Returns (bound ms, bound_by, bytes, products, bytes ms, ops ms)."""
        folded = sum(size for size, f in zip(plan.sizes, plan.folded) if f)
        nbytes = (sum(plan.sizes) + 2 * folded + plan.degree + 1) * wb
        half = [plan.half0] + [1 << lg for lg in plan.log_sizes[1:]]
        products = folded
        for counts in plan.counts:
            if sum(counts) >= 2:
                covered = {b for kk, c in enumerate(counts) if c for b in range(3) if plan.strides[kk][b]}
                products += (plan.degree + 1 - int(skip)) * int(np.prod([half[b] for b in covered]))
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = products * MM_SASS_PER_PRODUCT[backend][1] / (64 * sms * clock_mhz * 1e6) * 1e3
        return (max(bytes_ms, ops_ms), "operations" if ops_ms > bytes_ms else "bytes", nbytes, products, bytes_ms,
                ops_ms)

    def mb_times(field, what, spec, fold, skip):
        """MB at one round of ``spec`` (random words; the round's degree, or
        c_1's without a fold and skip-1), held word for word against one
        plain run and timed from a CUDA graph: (ms, plain ms, bound ms,
        bound_by)."""
        backend, wb = field.backend, 8 if field.backend == "goldilocks" else 4
        post = spec.after_fold() if fold else spec
        plan = multiblock.round_plan(spec, fold, post.terms, post.degree())
        tables = [slice_words(gen, field, (rk._table_size(spec, t),), dev) for t in range(len(spec.table_blocks))]
        r = slice_words(gen, field, (1,), dev) if fold else None
        claim = slice_words(gen, field, (1,), dev) if skip else None
        ms, plain = timed_vs_plain(("multiblock_round", backend), what,
                                   lambda: multiblock.round_sums(plan, tables, r, field, skip, claim),
                                   lambda: multiblock.round_sums_plain(plan, tables, r, field, skip, claim), 2)
        bound, by, nbytes, products, bytes_ms, ops_ms = mb_bound(plan, backend, wb, skip)
        sp, lay = multiblock.split(plan), multiblock.layout(plan, wb)
        checked.append(f"multi-block round {field.name} {what} (grid {plan.grid})")
        log(f"{field.name} multi-block round kernel, {what} (sizes {spec.block_sizes} -> {post.block_sizes}, grid "
            f"{plan.grid} = {sp.rows} rows x {sp.inner}, fold {fold}, skip-1 {skip}; instantiation "
            f"{multiblock.kernel_class(plan)}, {lay.tiles} tiles of {lay.rt} rows x {lay.span}, pipeline "
            f"{lay.pipe_stages} stages of {lay.pipe_k} slots): {ms:.4f} ms per "
            f"launch from a CUDA graph (s(0..D) finished in it), bound {bound:.4f} ms by {by} (bytes {bytes_ms:.4f} "
            f"ms: {nbytes / 1e6:.1f} MB at 3.35 TB/s; operations {ops_ms:.4f} ms: {products} products x "
            f"{MM_SASS_PER_PRODUCT[backend][1]} IMAD at 64 per clock per SM, {sms} SMs, {clock_mhz} MHz), "
            f"{bound / ms:.1%} of the bound; plain torch {plain:.3f} ms; output == plain {tag}")
        del tables
        return ms, plain, bound, by

    # the kernels line's rows: Goldilocks at the main path's 4096 nodes,
    # BabyBear at 1024; Goldilocks at 1024 is checked and logged too
    for backend, field, n_nodes, run, in_line in (
            ("goldilocks", GOLDILOCKS, n_big, big, True),
            ("goldilocks", GOLDILOCKS, n_mid, runs[("mid", "goldilocks")], False),
            ("mont32", BABYBEAR, n_mid, runs[("mid", "mont32")], True)):
        wb = 8 if backend == "goldilocks" else 4
        k = (n_nodes - 1).bit_length()
        tri = rk.PolySpec((k,) * 3, TRI_BLOCKS, ((0, 1, 2),))
        # the multi-block round: the path's largest launch (the first round it
        # takes: the X -> Y transition, or the first X round below the
        # contraction threshold), the second round after it and the middle of
        # the Y phase
        first = next(j for j in range(1, 3 * k) if k - j < 1 or (1 << (k - j - 1 + 2 * k)) <= thr)
        mb_rows = [mb_times(field, f"{n_nodes}-node triangle, {label}", folded_spec(tri, j - 1), True, True)
                   for label, j in (("first multi-block round", first), ("the round after it", first + 1),
                                    ("middle of the Y phase", k + k // 2))]
        ms, plain, bound, by = mb_rows[0]
        if in_line:
            rows.append({"name": f"multiblock_round_{backend}", "route": "cuda",
                         "source": "thaler_study_tpu_torch/csrc/multiblock_round.cu",
                         "replaces": "thaler_study_tpu/ops/round_kernel.py:218",
                         "launches": run["launches"]["multiblock_round"], "ms": ms, "plain_ms": plain,
                         "bound_ms": bound, "bound_by": by, "library_ms": None})
        # the flat fold at the X phase's round 1 (f1 and f3 of 2^(2k), f2 kept)
        tables = [slice_words(gen, field, (1 << (2 * k),), dev) for _ in range(3)]
        halves = [1 << (2 * k - 1), 0, 1 << (2 * k - 1)]
        r = slice_words(gen, field, (1,), dev)
        ms, plain = timed_vs_plain(("multiblock_fold", backend), f"{n_nodes}-node triangle X phase round 1",
                                   lambda: multiblock.fold_tables(tables, halves, r, field),
                                   lambda: multiblock.fold_tables_plain(tables, halves, r, field), 2)
        nbytes = 3 * (1 << (2 * k)) * wb
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        checked.append(f"flat fold {field.name} {n_nodes} nodes (2 x 2^{2 * k})")
        log(f"{field.name} multi-block fold kernel, {n_nodes}-node triangle X phase round 1 (f1, f3 of 2^{2 * k} "
              f"folded): {ms:.4f} ms per launch from a CUDA graph, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), "
              f"{bound / ms:.1%} of the bound; plain torch {plain:.3f} ms; output == plain {tag}")
        if in_line:
            rows.append({"name": f"multiblock_fold_{backend}", "route": "cuda",
                         "source": "thaler_study_tpu_torch/csrc/multiblock_round.cu",
                         "replaces": "thaler_study_tpu/ops/round_kernel.py:110",
                         "launches": run["launches"]["multiblock_fold"], "ms": ms, "plain_ms": plain,
                         "bound_ms": bound, "bound_by": "bytes", "library_ms": None})
        del tables
        # the contraction at the X phase's round 0, middle and last contracted
        # round, with the views and the dot
        last = max(j for j in range(k) if (1 << (k - j - 1 + 2 * k)) > thr)
        got = [contraction_times(field, n_nodes, label, xh, 1 << k, label == "round 0")
               for label, xh in (("round 0", 1 << (k - 1)), ("middle", 1 << (k // 2)),
                                 (f"round {last} (the last contracted)", 1 << (k - last - 1)))]
        if in_line:
            for name, source, replaces, (ms, plain, bound, by, lib), launched in (
                    ("modmatmul_tc", "modmatmul_tc.cu", "modmatmul.py:160", got[0][0], run["launches"]["modmatmul_tc"]),
                    ("modmatmul_digits", "modmatmul_tc.cu", "modmatmul.py:106", got[0][1],
                     run["launches"]["modmatmul_digits"])):
                rows.append({"name": f"{name}_{backend}", "route": "cuda",
                             "source": f"thaler_study_tpu_torch/csrc/{source}",
                             "replaces": f"thaler_study_tpu/ops/{replaces}", "launches": launched, "ms": ms,
                             "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": lib})
                if lib is not None:
                    rows[-1]["library_call"] = ("torch.nn.functional.pad(x.view(torch.uint8).reshape(R, K, D)"
                                                ".permute(2, 0, 1), (0, Kp - K)).contiguous()")
    # dense W's first b round (no fold, degree 2) at the wide circuit's width
    mb_times(GOLDILOCKS, f"dense W {wide_depth} x 2^{wide_log} gates, the first b round",
             rk.PolySpec((wide_log, wide_log), W_BLOCKS, W_TERMS), False, False)
    # the 256-node proof's one contracted round (round 0, grid 2^23), both fields
    k = (tri_nodes_cmp - 1).bit_length()
    for field in (GOLDILOCKS, BABYBEAR):
        contraction_times(field, tri_nodes_cmp, "round 0", 1 << (k - 1), 1 << k, False)
    # C = A B^T (mode 0) on both kernels from 1^3 to 256^3: where the
    # tensor cores' extra launches (two digit passes) would lose
    for field in (GOLDILOCKS, BABYBEAR):
        line = []
        for side in (1, 16, 64, 256):
            fa, fb = (FArray(slice_words(gen, field, (side, side), dev), field) for _ in range(2))
            c_ref = modmatmul.modmatmul_plain(fa, fb).data
            for name, fn in (("modmatmul_tc", modmatmul.modmatmul_tc), ("modmatmul", modmatmul.modmatmul_cc)):
                c = fn(fa, fb).data
                sync()
                note_err((name, field.backend), word_err(c, c_ref),
                         f"C = A B^T at {side}^3")
            line.append(f"{side}^3 tensor cores {graph_ms(lambda: modmatmul.modmatmul_tc(fa, fb)):.5f} ms, CUDA "
                        f"cores {graph_ms(lambda: modmatmul.modmatmul_cc(fa, fb)):.5f} ms")
        checked.append(f"C = A B^T {field.name} 1^3..256^3 (both kernels)")
        log(f"{field.name} C = A B^T (modmatmul, mode 0) from CUDA graphs, the tensor cores with both digit passes: "
            f"{'; '.join(line)}; both == plain {tag}")
    # max_abs_err after every comparison, the path's shapes included
    for row in rows:
        name, backend = row["name"].rsplit("_", 1)
        row["max_abs_err"] = err[(name, backend)]
    log(f"the slice's kernels == plain (exact) at the path's shapes: {'; '.join(checked)}")
    sync()
    return rows


# ---- slice 12: batched proving at any k and DST, the fused FS prover over
# every spec, the PCS and its Merkle build ----------------------------------
#
# Module-level like the multi-block slice: every kernel call, entry point and
# timer goes through ``dev``, ``sync`` and the timers passed in.

# the slice's sizes: the batch cells' n and B (k = 2 with the DST, k = 1 at
# B = 64, k = 4 at B = 16), the Merkle build's leaves, the PCS's field and m
BATCH_N, BATCH_B, BATCH_B4 = 22, 64, 16
MERKLE_LOG, MERKLE_CHECK_LOG = 22, 20
PCS_M = 2
DST16 = b"chip-smoke-dst16"  # a 16-byte domain-separation tag
# H100 SXM: 4 warp schedulers x 32 lanes issue 128 lane-instructions per
# clock per SM, 132 SMs
LANE_INSTRUCTIONS_PER_CLOCK = 128 * 132
# The Merkle build's work, whatever implements it: the SASS instructions one
# thread issues for a leaf hash (one compression) and for a node hash (two),
# counted in the per-level form of csrc/merkle.cu (leaf_kernel, node_kernel:
# one hash a thread, no loop) that the one-launch build replaced
MERKLE_SASS_PER_HASH = {"leaf": 1480, "node": 2764}
# the integer pipe's SASS (16 lanes a clock per sub-partition on sm_90) and
# IMAD's (the FMA pipe's), against the rest
SASS_PIPES = {"IMAD": ("IMAD",), "LOP3/SHF/IADD3/PRMT": ("LOP3", "SHF", "IADD3", "PRMT")}


def sass_pipes(lib: str, kernel: str) -> dict:
    """The SASS instructions (NOPs left out) of the first function in
    ``lib`` whose name holds ``kernel``, counted by :data:`SASS_PIPES`'
    groups and "other"; for a kernel with no loop, what one thread
    issues."""
    import re

    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", sass_functions(lib, kernel)[0])
    out = {name: 0 for name in SASS_PIPES}
    out["other"] = 0
    for op in ops:
        if op.startswith("NOP"):
            continue
        group = next((name for name, heads in SASS_PIPES.items() if op.split(".")[0] in heads), "other")
        out[group] += 1
    return out


def compressions(nbytes, m, draw):
    """SHA-256 compressions on one proof's chain in a round: the absorb's
    full blocks, then b_0's closing blocks and b_1."""
    end = nbytes % 64 + m
    return end // 64 + ((1 if end % 64 + 5 <= 56 else 2) + 1 if draw else 0)


def batch_pcs_slice(seed, tag, dev, sync, graph_ms, time_ms, reset_counts, read_counts, compress_ms, reps=5, n=BATCH_N,
                    batch=BATCH_B, batch4=BATCH_B4, tri_nodes=TRI_NODES, tri_nodes_small=TRI_NODES_SMALL,
                    wide_log=WIDE_LOG, merkle_log=MERKLE_LOG, merkle_check_log=MERKLE_CHECK_LOG):
    """Phases 2-4 of slice 12; returns its rows of the ``kernels`` line.
    ``reset_counts`` / ``read_counts`` set to 0 and read every launch
    counter of the port; the sizes default to the slice's own (a CPU
    rehearsal passes smaller ones)."""
    import json
    import os
    import statistics
    import time

    import numpy as np
    import torch

    from thaler_study_tpu_torch import _build, api, gkr, pcs
    from thaler_study_tpu_torch import fields as tf
    from thaler_study_tpu_torch.fiat_shamir import (
        FiatShamirTranscript,
        SerializationError,
        SumcheckInteractiveProver,
        SumcheckInteractiveVerifier,
        generate_transcript,
        generate_transcript_device,
        verify_transcript,
    )
    from thaler_study_tpu_torch.fields import BABYBEAR, F5, F389, GOLDILOCKS, FArray
    from thaler_study_tpu_torch.fields.farray import word_dtype
    from thaler_study_tpu_torch.mle.dense import DenseMLE
    from thaler_study_tpu_torch.ops import cuda_round, fs_kernel, merkle_kernel, mle_kernel
    from thaler_study_tpu_torch.ops.round_kernel import PolySpec, single_block_spec
    from thaler_study_tpu_torch.ops.sha_chain import DevChain
    from thaler_study_tpu_torch.pcs import pedersen
    from thaler_study_tpu_torch.protocols import BatchedProductPoly, ProductPoly, TriangleG, generate_transcripts_batch
    from thaler_study_tpu_torch.sumcheck import Prover, SeededRng, SumCheckError, Verifier

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 12)
    activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA]
                                                          if dev.type == "cuda" else [])
    fields = [getattr(tf, name) for name in FIELDS5]
    err = {}

    def note_err(key, e, what):
        if e:
            raise AssertionError(f"{key[0]} kernel != plain ({key[1]}): {what}")
        err[key] = max(err.get(key, 0), e)

    def wb_of(field):
        return 8 if field.backend == "goldilocks" else 4

    def median_ms(fn, count=reps):
        out = []
        for _ in range(count):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out), out

    # ---- phase 2: the batch round kernel at k = 1..8 ------------------------
    # both fields' instantiations (Goldilocks; BabyBear and F5 for mont32),
    # every mode, N = 2^2 to 2^16, B = 1, 3, 64, random words with the
    # boundary words and every word at p - 1
    cases = ((4, 1, "random"), (4, 64, "max"), (1 << 10, 3, "random"), (1 << 10, 64, "max"),
             (1 << 16, 1, "max"), (1 << 16, 3, "random"))
    for field in (GOLDILOCKS, BABYBEAR, F5):
        key = ("round_kernel_k", field.backend)
        checks = 0
        for k in range(1, cuda_round.MAX_K + 1):
            for size, b, fill in cases:
                tables = [slice_words(gen, field, (b, size), dev, fill) for _ in range(k)]
                r = slice_words(gen, field, (b,), dev, fill)
                for fold in (False, True):
                    for skip in (False, True):
                        rr = r if fold else None
                        folded, parts = cuda_round.round_partials(tables, rr, skip_t1=skip, field=field)
                        ref_folded, ref = cuda_round.round_partials_plain(tables, rr, skip, parts.shape[1], field)
                        sync()
                        note_err(key, max(word_err(parts, ref), outputs_err(folded, ref_folded)),
                                 f"{field.name} k={k} N={size} B={b} {fill} fold={fold} skip={skip}")
                        checks += 1
        log(f"batch round kernel == plain (exact) over {field.name} in {checks} cases: k = 1..{cuda_round.MAX_K}, "
            f"(N, B, words) in {[(s, b, f) for s, b, f in cases]}, fold and skip-1 on and off")

    # ---- phase 2: the FS tail at round degrees 1 and 4..8 -------------------
    # (2 and 3 in main's phase 2); five fields (F5 to degree 4: the points
    # 0..D must be distinct mod p), every fill 0..63, rounds 0 / middle /
    # last with the round turning with the fill, transcript bytes included
    tb = 8
    tail_rounds = (0, n // 2, n - 1)
    for field in fields:
        key = ("fs_tail_d", field.backend)
        checks = 0
        degrees = [d for d in (1, 4, 5, 6, 7, 8) if d < field.p]
        for degree in degrees:
            vinv = fs_kernel.interp_tensor(field, degree, dev)
            for fill in range(64):
                round_idx = tail_rounds[fill % 3]
                nbytes = 64 * (16 + fill % 5) + fill
                m = fs_kernel._msg_len(round_idx, degree, field.byte_size)
                parts = slice_words(gen, field, (tb, 3, degree + 1), dev)
                parts[3] = 0  # proof 3: all sums zero -> zero coefficients -> flagged
                claim = slice_words(gen, field, (tb,), dev)
                claim[3] = 0

                def state():
                    chain = DevChain.fresh(tb, dev)
                    chain.state.copy_(torch.arange(tb * 8, device=dev, dtype=torch.int32).reshape(tb, 8) * 40503 + fill)
                    chain.buf[:, :fill] = (torch.arange(fill, device=dev) * 7 % 256).to(torch.uint8)
                    chain.nbytes = nbytes
                    w = word_dtype(field)
                    return [chain, claim.clone(), torch.zeros(tb, dtype=w, device=dev), torch.zeros(tb, dtype=w, device=dev),
                            torch.zeros((tb, n * (degree + 1)), dtype=w, device=dev),
                            torch.zeros((tb, nbytes + m), dtype=torch.uint8, device=dev),
                            torch.zeros(tb, dtype=torch.int32, device=dev), vinv]

                kst, pst = state(), state()
                off = (degree + 1) * round_idx
                fs_kernel.fs_tail(parts, *kst, round_idx, off, round_idx < n - 1, field)
                fs_kernel.fs_tail_plain(parts, *pst, round_idx, off, round_idx < n - 1, field)
                sync()
                outs = [(kst[0].state, pst[0].state), (kst[0].buf, pst[0].buf)] + list(zip(kst[1:7], pst[1:7]))
                note_err(key, max(word_err(a.to(torch.int64), b.to(torch.int64)) for a, b in outs),
                         f"{field.name} degree={degree} fill={fill} round={round_idx}")
                if int(kst[6][3]) != 1:
                    raise AssertionError(f"FS tail kernel did not flag proof 3's zero coefficients ({field.name})")
                checks += 1
        log(f"FS tail kernel == plain (exact) over {field.name} in {checks} cases: B = {tb}, degrees {degrees}, "
            "every fill 0..63, round 0 / middle / last, transcript bytes, one proof with zero coefficients")

    # ---- phase 2: the Merkle build ------------------------------------------
    # leaves of 1 (F5), 2 (F389), 3 (F1572869), 4 and 8 (Goldilocks) bytes,
    # every level equal to the hashlib build, at n = 1, 2, one block's 64
    # leaves, twice it (the top takes over), 2^13 (every block of the top),
    # 2^16 (blocks of THREADS threads) and 2^17 (each thread over 2 leaves)
    nrng = np.random.default_rng(seed + 12)
    checks = 0
    for byte_size in (1, 2, 3, 4, 8):
        for size in (1, 2, 64, 128, 1 << 13, 1 << 16, 1 << 17):
            vals = nrng.integers(0, 256, size=(size, byte_size), dtype=np.uint8)
            vals[0] = 255
            got = merkle_kernel.build_tree_device(vals, dev)
            want = merkle_kernel.build_tree_plain(vals)
            if len(got) != len(want) or any(not np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"Merkle kernel != hashlib: {size} leaves of {byte_size} bytes")
            checks += 1
    err[("merkle", "goldilocks")] = err[("merkle", "mont32")] = 0
    log(f"Merkle kernel == hashlib (every level, exact) in {checks} cases: 1, 2, 64, 128, 2^13, 2^16, 2^17 leaves "
        f"(plans {[tuple(merkle_kernel.plan(1 << k)) for k in (6, 7, 13, 16, 17)]}) of 1, 2, 3, 4 and 8 bytes")

    # ---- phase 3: the batched prover with a non-empty DST -------------------
    field = GOLDILOCKS
    spec2 = single_block_spec(2, n)
    tables = [FArray(slice_words(gen, field, (batch, 1 << n), dev), field) for _ in range(2)]
    poly = BatchedProductPoly(tables)
    sync()
    reset_counts()
    ts = generate_transcripts_batch(poly, field, DST16)
    counts = read_counts()
    want = {"round_kernel": n, "fs_tail": 0}
    got = {name: counts[name][field.backend] for name in want}
    if got != want:
        raise AssertionError(f"DST batch: launches {got}, expected {want} (one per round, c_1 from round 0's)")

    def rejects(t, inst, dst):
        v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec2, inst)), field)
        try:
            return not verify_transcript(t, v, field, dst)
        except (SumCheckError, SerializationError):
            return True

    for i in (0, batch - 1):
        inst = [FArray(t.data[i], field) for t in tables]
        single = generate_transcript(SumcheckInteractiveProver(Prover(ProductPoly(spec2, inst))), field, DST16)
        if single.to_bytes() != ts[i].to_bytes():
            raise AssertionError(f"DST batch instance {i} != its single proof with the DST")
        bad = [bytearray(m) for m in ts[i].g]
        bad[1][16] ^= 1
        if rejects(ts[i], inst, DST16) or not rejects(FiatShamirTranscript([bytes(m) for m in bad]), inst, DST16):
            raise AssertionError(f"DST batch instance {i}: honest rejected or tampered accepted")
        if not rejects(ts[i], inst, b""):
            raise AssertionError(f"DST batch instance {i}: accepted without its DST")
    cut = [FArray(t.data[:4, : 1 << 10].contiguous(), field) for t in tables]
    t_card = generate_transcripts_batch(BatchedProductPoly(cut), field, DST16)
    t_cpu = generate_transcripts_batch(BatchedProductPoly([FArray(t.data.cpu(), field) for t in cut]), field, DST16)
    if [t.to_bytes() for t in t_card] != [t.to_bytes() for t in t_cpu]:
        raise AssertionError("DST batch n = 10, B = 4: the card's transcripts != device='cpu'")
    dst_ms, dst_all = median_ms(lambda: generate_transcripts_batch(poly, field, DST16))
    fused_ms, fused_all = median_ms(lambda: generate_transcripts_batch(poly, field))
    log(f"batched prover, non-empty DST ({len(DST16)} bytes), {field.name} n = {n}, B = {batch}, k = 2: the "
        f"per-round path, launches {got} per dispatch; instances 0 and {batch - 1} byte-identical to single "
        f"proofs with the DST on the card, accepted with it, rejected tampered and without it; a cut at n = 10, "
        f"B = 4 byte-identical to device='cpu'; dispatch_ms {dst_ms:.3f} median of {reps} (all "
        f"{[round(x, 3) for x in dst_all]}) against the empty-DST fused dispatch on the same tables "
        f"{fused_ms:.3f} ms ({[round(x, 3) for x in fused_all]}) {tag}")
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        generate_transcripts_batch(poly, field, DST16)
        traced_ms = (time.perf_counter() - t0) * 1e3
    spans, busy_us = device_spans(prof)
    if spans:
        log(f"DST dispatch traced: device busy {busy_us / 1e3:.3f} ms of {traced_ms:.3f} ms -> device idle share "
            f"{1 - busy_us / 1e3 / traced_ms:.1%} ({len(spans)} device records) {tag}")
    elif dev.type == "cuda":
        raise AssertionError("DST dispatch traced: the trace holds no device records")
    else:
        log("DST dispatch traced: no device records, device idle share not measured")
    del ts, poly, tables, cut
    sync()
    torch.cuda.empty_cache() if dev.type == "cuda" else None

    # ---- phase 3: the fused batch at k = 1 and k = 4 ------------------------
    timing = {}
    dispatch = {}
    for field in (GOLDILOCKS, BABYBEAR):
        for k, b in ((1, batch), (4, batch4)):
            spec = single_block_spec(k, n)
            tables = [FArray(slice_words(gen, field, (b, 1 << n), dev), field) for _ in range(k)]
            poly = BatchedProductPoly(tables)
            sync()
            reset_counts()
            fused = fs_kernel.fs_prove_device_batch(spec, tables)
            counts = read_counts()
            got = {name: counts[name][field.backend] for name in ("round_kernel", "fs_tail", "multiblock_round")}
            if got != {"round_kernel": n, "fs_tail": n, "multiblock_round": 0}:
                raise AssertionError(f"fused batch k = {k} {field.name}: launches {got}, expected {n} and {n}")
            if any(m is None for m in fused):
                raise AssertionError(f"fused batch k = {k} {field.name}: an instance fell back")
            ts = generate_transcripts_batch(poly, field)
            for i in (0, b - 1):
                inst = [FArray(t.data[i], field) for t in tables]
                host = generate_transcript(SumcheckInteractiveProver(Prover(ProductPoly(spec, inst))), field)
                if host.g != fused[i] or ts[i].g != fused[i]:
                    raise AssertionError(f"fused batch k = {k} {field.name} instance {i} != the host loop on the card")
                v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, inst)), field)
                if not verify_transcript(ts[i], v, field):
                    raise AssertionError(f"fused batch k = {k} {field.name} instance {i} rejected")
            ms, all_ms = median_ms(lambda: generate_transcripts_batch(poly, field))
            dispatch[(k, field.backend)] = (got, ms)
            log(f"fused batch, k = {k}, {field.name}, n = {n}, B = {b} ({sum(t.data.numel() for t in tables) * wb_of(field) / 1e9:.2f} "
                f"GB of tables): launches {got} per dispatch, every instance fused; instances 0 and {b - 1} "
                f"byte-identical to the host loop on the card (round_step: MB), accepted; dispatch_ms {ms:.3f} "
                f"median of {reps} ({[round(x, 3) for x in all_ms]}) {tag}")

            # the round kernel at the round-1 shape and the FS tail of this degree
            wb = wb_of(field)
            data = [t.data for t in tables]
            r1 = slice_words(gen, field, (b,), dev)
            outs = [torch.empty((b, 1 << (n - 1)), dtype=word_dtype(field), device=dev) for _ in data]
            blocks = cuda_round.blocks_for(b, 1 << (n - 2))
            got_k = cuda_round.round_partials(data, r1, True, outs, field)
            ref = [None]

            def plain_round():
                ref[0] = cuda_round.round_partials_plain(data, r1, True, blocks, field)

            plain_ms = time_ms(plain_round, 2)
            note_err((f"round_kernel_k{k}", field.backend), outputs_err(got_k, ref[0]), "at the path's round-1 shape")
            ms_k = graph_ms(lambda: cuda_round.round_partials(data, r1, True, outs, field))
            nbytes = b * (k * (1 << n) * wb + k * (1 << (n - 1)) * wb + wb) + b * blocks * (k + 1) * wb
            timing[(f"round_kernel_k{k}", field.backend)] = (ms_k, plain_ms, nbytes / PEAK_BYTES_PER_S * 1e3)
            log(f"{field.name} batch round kernel k = {k}, round-1 shape (B = {b}, N = 2^{n}, fold + claim): "
                f"{ms_k:.4f} ms from a CUDA graph, bound {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms "
                f"({nbytes / 1e9:.3f} GB), {nbytes / PEAK_BYTES_PER_S * 1e3 / ms_k:.1%} of the bound; plain torch "
                f"{plain_ms:.3f} ms {tag}")
            del outs, got_k, ref
            parts = slice_words(gen, field, (b, blocks, k + 1), dev)
            vinv = fs_kernel.interp_tensor(field, k, dev)
            m = fs_kernel._msg_len(5, k, field.byte_size)
            w = word_dtype(field)
            claim0 = slice_words(gen, field, (b,), dev)

            def tail_state():
                return [DevChain.fresh(b, dev), claim0.clone(), torch.zeros(b, dtype=w, device=dev),
                        torch.zeros(b, dtype=w, device=dev), torch.zeros((b, n * (k + 1)), dtype=w, device=dev),
                        torch.zeros((b, 1000 + m), dtype=torch.uint8, device=dev),
                        torch.zeros(b, dtype=torch.int32, device=dev), vinv]

            def tail(fn, st):
                st[0].nbytes = 1000  # the same fill (40) for every launch
                fn(parts, *st, 5, 5 * (k + 1), True, field)

            # the kernel and its plain version at the timed shape, each on its own state
            kst, pst = tail_state(), tail_state()
            tail(fs_kernel.fs_tail, kst)
            tail(fs_kernel.fs_tail_plain, pst)
            sync()
            outs = [(kst[0].state, pst[0].state), (kst[0].buf, pst[0].buf)] + list(zip(kst[1:7], pst[1:7]))
            note_err((f"fs_tail_d{k}", field.backend), max(word_err(x.to(torch.int64), y.to(torch.int64)) for x, y in outs),
                     f"B = {b}, {blocks} partials per proof, round 5, fill 40")
            ms_t = graph_ms(lambda: tail(fs_kernel.fs_tail, kst))
            plain_t = time_ms(lambda: tail(fs_kernel.fs_tail_plain, pst), 2)
            tbytes = parts.numel() * wb + b * (2 * 32 + 2 * 64 + 2 * wb + wb + (k + 1) * wb + 2 * 4 + m) + (k + 1) ** 2 * wb
            comp = compressions(1000, m, True)
            floor_ms = comp * compress_ms
            timing[(f"fs_tail_d{k}", field.backend)] = (ms_t, plain_t, tbytes / PEAK_BYTES_PER_S * 1e3, floor_ms)
            log(f"{field.name} FS tail, degree {k} (B = {b}, {blocks} partials per proof, {m}-byte message at fill "
                f"40): == plain (exact) at this shape; {ms_t * 1e3:.2f} us per launch from a CUDA graph, bound "
                f"{tbytes / PEAK_BYTES_PER_S * 1e3:.6f} ms ({tbytes} B), latency floor {floor_ms * 1e3:.2f} us ({comp} "
                f"compressions); plain (Python ints) {plain_t:.3f} ms {tag}")
            del tables, poly, ts, data, parts, kst, pst
            sync()
            torch.cuda.empty_cache() if dev.type == "cuda" else None

    # ---- phase 3: the device transcript over multi-block specs --------------
    def fs_tail_starts(prof):
        spans, _ = device_spans(prof)
        tails = [s0 for s0, s1, name in spans if "fs_tail_kernel" in name]
        reads = [s0 for s0, s1, name in spans if "DtoH" in name]
        return tails, reads

    tri = {}
    for n_nodes, field, s in ((tri_nodes, GOLDILOCKS, seed), (tri_nodes_small, BABYBEAR, seed + 1)):
        k = (n_nodes - 1).bit_length()
        adj = triangle_graph(n_nodes, s)
        claim, t_api = api.prove_triangle_count(adj, n_nodes, field, device=dev)

        def device_proof():
            g = TriangleG.new_adj_matrix(2 * k, adj, field, device=dev)
            return generate_transcript_device(g, field)

        g = TriangleG.new_adj_matrix(2 * k, adj, field, device=dev)
        sync()
        reset_counts()
        t_dev = generate_transcript_device(g, field)
        counts = read_counts()
        if t_dev.to_bytes() != t_api.to_bytes():
            raise AssertionError(f"triangle {n_nodes} {field.name}: the device transcript != prove_triangle_count's")
        if counts["fs_tail"][field.backend] != 3 * k:
            raise AssertionError(f"triangle {n_nodes} {field.name}: {counts['fs_tail']} FS tail launches, expected "
                                 f"one per round ({3 * k}; a fallback to the host loop launches none)")
        if not api.verify_triangle_count(adj, n_nodes, t_dev, field, device=dev):
            raise AssertionError(f"triangle {n_nodes} {field.name}: the device transcript was rejected")
        launches = {name: v[field.backend] for name, v in counts.items() if field.backend in v and v[field.backend]}
        g = TriangleG.new_adj_matrix(2 * k, adj, field, device=dev)
        sync()
        with torch.profiler.profile(activities=activities) as prof:
            generate_transcript_device(g, field)
            sync()
        tails, reads = fs_tail_starts(prof)
        if tails:
            inside = [x for x in reads if tails[0] <= x <= tails[-1]]
            if inside:
                raise AssertionError(f"triangle {n_nodes} {field.name}: {len(inside)} device-to-host reads inside the "
                                     "round loop")
            reads_note = (f"{len(tails)} FS tail records, device-to-host reads inside the round loop: 0, after it: "
                          f"{sum(x > tails[-1] for x in reads)}")
        elif dev.type == "cuda":
            raise AssertionError(f"triangle {n_nodes} {field.name}: the trace of one proof holds no FS tail records")
        else:
            reads_note = "device-to-host reads: not measured (no device records in the trace)"
        # the two entry points in turns: prove_triangle_count (the host loop)
        # and TriangleG + generate_transcript_device, input building included
        host_all, dev_all = [], []
        for _ in range(reps):
            host_all.append(median_ms(lambda: api.prove_triangle_count(adj, n_nodes, field, device=dev), 1)[0])
            dev_all.append(median_ms(device_proof, 1)[0])
        tri[(n_nodes, field.backend)] = (statistics.median(dev_all), statistics.median(host_all))
        log(f"triangle IP {n_nodes} nodes over {field.name} through generate_transcript_device: byte-identical to "
            f"api.prove_triangle_count's transcript, accepted; one FS tail launch per round ({3 * k}); launches "
            f"{launches}; {reads_note}; proof (input building included) median of {reps} "
            f"{statistics.median(dev_all):.2f} ms ({[round(x, 2) for x in dev_all]}) against prove_triangle_count "
            f"{statistics.median(host_all):.2f} ms ({[round(x, 2) for x in host_all]}), in turns {tag}")

    # the mixed-degree 2-block spec (JAX tests/test_fs_kernel.py:237) and
    # dense W's spec on the first layer of the 8 x 2^wide_log circuit
    field = GOLDILOCKS
    mixed = PolySpec(block_sizes=(2, 3), table_blocks=((0,), (0, 1)), terms=((0, 1),))
    tabs = [FArray(slice_words(gen, field, (1 << s,), dev), field) for s in (2, 5)]
    t_dev = generate_transcript_device(ProductPoly(mixed, tabs), field)
    t_host = generate_transcript(SumcheckInteractiveProver(Prover(ProductPoly(mixed, tabs))), field)
    fused = fs_kernel.fs_prove_device(mixed, tabs)
    if t_dev.to_bytes() != t_host.to_bytes() or fused != t_dev.g:
        raise AssertionError("mixed-degree spec: the device transcript != the host loop, or it fell back")
    srng = np.random.default_rng(seed + 2)
    widths = [1 << wide_log] * 9
    circuit = gate_circuit(gkr, widths, srng)
    inputs = field.felts([field.p - 1] + srng.integers(0, 1 << 62, widths[-1] - 1).tolist())
    prover = gkr.Prover(circuit, inputs, field, use_linear=False, device=dev)
    prover.start_protocol()
    prover.start_round(0, [field.felt(int(x)) for x in srng.integers(0, 1 << 62, circuit.num_vars_at(0))])
    w_poly = prover.prover.g
    sync()
    reset_counts()
    t_dev = generate_transcript_device(w_poly, field)
    counts = read_counts()
    t_host = generate_transcript(SumcheckInteractiveProver(Prover(w_poly)), field)
    if t_dev.to_bytes() != t_host.to_bytes():
        raise AssertionError("dense W spec: the device transcript != the host loop")
    fused_w = counts["fs_tail"][field.backend] == w_poly.num_vars()
    log(f"generate_transcript_device, mixed-degree 2-block spec (degrees {mixed.round_degrees()}) and dense W's spec "
        f"on the first layer of the 8 x 2^{wide_log} circuit (blocks {w_poly.spec.block_sizes}): byte-identical to "
        f"the host loop; dense W {'fused, one FS tail launch per round' if fused_w else 'fell back to the host loop (a zero coefficient)'} "
        f"(launches {({k_: v[field.backend] for k_, v in counts.items() if field.backend in v and v[field.backend]})}) {tag}")
    del prover, w_poly, circuit

    # ---- phase 3: the PCS -----------------------------------------------------
    field = F389
    m = PCS_M
    evals = [field.felt(int(x)) for x in nrng.integers(0, field.p, 1 << m)]
    poly = DenseMLE.from_evals_lsb(evals, m, field, device=dev)
    sync()
    reset_counts()
    t0 = time.perf_counter()
    prover = pcs.Prover(poly)
    commit_s = time.perf_counter() - t0
    counts = read_counts()
    if counts["merkle"] != {"leaf": 1, "node": merkle_kernel.node_launches(len(prover.values))}:
        raise AssertionError(f"PCS commit: Merkle launches {counts['merkle']}")
    if counts["mle_eval_many"]["mont32"] != 1:
        raise AssertionError(f"PCS commit: evaluation launches {counts['mle_eval_many']}, expected one")
    cpu_tree = pcs.MerkleTree(prover.values, device="cpu")
    if cpu_tree.root() != prover.merkle_root() or cpu_tree.digests != prover.tree.digests:
        raise AssertionError("PCS commit: the card's tree != device='cpu'")

    def pcs_round(rng_seed, cheat=None, many=0):
        v = pcs.Verifier(m, 1, prover.merkle_root())
        rng = SeededRng(rng_seed)
        b_, c_ = v.random_line(rng, field)
        q = prover.poly_restriction_to_line(b_, c_)
        if cheat == "degree":
            q = q + pcs.relaxed.UniPoly([(m + 1, field.one())], field)
        try:
            v.commited_univariate(q)
            if many:
                points = v.challenge_prover_many(rng, field, many)
                multi, leaves = prover.challenge_many(points)
                if cheat == "leaf":
                    leaves = [leaves[0] + field.one()] + leaves[1:]
                v.verify_prover_reply_many(multi, leaves)
            else:
                point = v.challenge_prover(rng, field)
                path, leaf = prover.challenge(point)
                if cheat == "leaf":
                    leaf = leaf + field.one()
                v.verify_prover_reply(path, leaf)
        except pcs.PCSError as e:
            return type(e).__name__
        return None

    rng_seed = next(s for s in range(64) if prover.poly_restriction_to_line(
        *pcs.Verifier(m, 1, prover.merkle_root()).random_line(SeededRng(s), field)).degree() == m)
    outcome = {c: pcs_round(rng_seed, c) for c in (None, "leaf", "degree")}
    outcome.update({f"{c} x16": pcs_round(rng_seed, c, 16) for c in (None, "leaf")})
    if outcome != {None: None, "leaf": "PCSError", "degree": "DegreeMismatch", "None x16": None, "leaf x16": "PCSError"}:
        raise AssertionError(f"relaxed PCS: decisions {outcome}")
    # the commit split: evaluate_many, leaf bytes, the tree's kernels, the
    # whole MerkleTree (leaf bytes, the copy in, the kernels, the one read,
    # the digest string)
    points = pcs.all_multidimensional_values(field, m)
    t_eval, _ = median_ms(lambda: poly.evaluate_many([list(pt) for pt in points]), 1)
    # evaluate_many by step: the points' Felt lists to one upload (host),
    # the kernel (device), the values back as Felts (host)
    pts = [list(pt) for pt in points]
    ev = {}

    def ev_in():
        ev["rs"] = FArray.from_ints([f.v for pt in pts for f in pt], field, device=dev).reshape(len(pts), m)

    def ev_kernel():
        ev["out"] = mle_kernel.eval_many(poly.evals, ev["rs"])

    t_ev_in, _ = median_ms(ev_in, 1)
    t_ev_kernel, _ = median_ms(ev_kernel, 3)
    t_ev_out, _ = median_ms(lambda: ev["out"].to_felts(), 1)
    values = prover.values
    t_bytes, _ = median_ms(lambda: pcs.merkle.leaf_bytes(values), reps)
    vals_t = torch.from_numpy(pcs.merkle.leaf_bytes(values)).to(dev)
    t_tree, _ = median_ms(lambda: merkle_kernel.build_tree(vals_t), reps)
    t_all, _ = median_ms(lambda: pcs.MerkleTree(values, device=dev), reps)
    log(f"relaxed PCS over {field.name}, m = {m}: {field.p ** m} points padded to {len(values)} leaves; commit "
        f"(pcs.Prover) {commit_s:.3f} s, Merkle launches {counts['merkle']}; every digest == device='cpu'; "
        f"decisions {outcome} (line seed {rng_seed}); split: evaluate_many {t_eval:.1f} ms (the points' Felt lists "
        f"to one upload {t_ev_in:.1f} ms on the host, the kernel {t_ev_kernel:.3f} ms synced, the values back as "
        f"Felts {t_ev_out:.1f} ms on the host), leaf bytes {t_bytes:.1f} "
        f"ms, the tree's kernels {t_tree:.3f} ms, the whole MerkleTree (leaf bytes, copy in, kernels, one read, "
        f"the digest string) {t_all:.1f} ms {tag}")
    del prover, cpu_tree, vals_t

    # the Pedersen family (host integers): the golden tree and the PCS over F5
    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "pedersen_golden.json")
    golden = json.load(open(golden_path))
    t0 = time.perf_counter()
    ptree = pedersen.PedersenMerkleTree([F5.felt(v) for v in (3, 1, 4, 1)])
    if (ptree.root().hex() != golden["tree_f5_3141_root"]
            or [pedersen.te_serialize_compressed(p).hex() for p in ptree.levels[1]] != golden["tree_f5_3141_level1"]):
        raise AssertionError("Pedersen tree != tests/data/pedersen_golden.json")
    golden_s = time.perf_counter() - t0
    # evaluations (3, 1, 4, 1): an x1 x2 term, so the restriction to a line
    # with both slopes nonzero has the full degree 2
    f5_poly = DenseMLE.from_evals_lsb(F5.felts([3, 1, 4, 1]), 2, F5, device=dev)
    t0 = time.perf_counter()
    pprover = pcs.Prover(f5_poly, hash_family="pedersen")
    ped_s = time.perf_counter() - t0
    s_ = next(s for s in range(64) if pprover.poly_restriction_to_line(
        *pcs.Verifier(2, 1, pprover.merkle_root()).random_line(SeededRng(s), F5)).degree() == 2)
    v = pcs.Verifier(2, 1, pprover.merkle_root())
    rng = SeededRng(s_)
    v.commited_univariate(pprover.poly_restriction_to_line(*v.random_line(rng, F5)))
    path, leaf = pprover.challenge(v.challenge_prover(rng, F5))
    v.verify_prover_reply(path, leaf)
    log(f"Pedersen family (host integers): the F5 (3, 1, 4, 1) tree == the golden root and level 1 ({golden_s:.2f} s, "
        f"parameters included); relaxed PCS over F5, m = 2 ({len(pprover.values)} leaves): commit {ped_s:.2f} s, accepted")

    # ---- phase 4: the Merkle build at 2^merkle_log leaves ---------------------
    # its work is the pinned SASS per hash (MERKLE_SASS_PER_HASH), whatever
    # implements it; its depth floor one leaf hash and log2(n) node hashes in
    # series, compress_ms each compression
    rows = []
    lib = str(_build._library_path("merkle")) if dev.type == "cuda" else None
    try:
        pipes = sass_pipes(lib, "build_kernel") if lib else None
        clock_mhz = max_sm_clock_mhz()
    except (OSError, subprocess.CalledProcessError, AssertionError) as e:
        raise AssertionError(f"cannot count the Merkle kernel's SASS or read the clock: {e}")
    for field, log_n in ((GOLDILOCKS, merkle_log), (F389, 18)):
        bs = field.byte_size
        size = 1 << log_n
        vals = torch.randint(0, 256, (size, bs), generator=gen, device=dev, dtype=torch.int64).to(torch.uint8)
        vals_np = vals.cpu().numpy()
        reset_counts()
        tree = merkle_kernel.build_tree(vals)
        sync()
        counts = read_counts()
        if counts["merkle"] != {"leaf": 1, "node": merkle_kernel.node_launches(size)}:
            raise AssertionError(f"Merkle build: launches {counts['merkle']}")
        count = 1 + merkle_kernel.node_launches(size)
        check_log = min(log_n, merkle_check_log)
        small = merkle_kernel.build_tree(vals[: 1 << check_log].contiguous())
        got = merkle_kernel.split_levels(small.cpu().numpy())
        want = merkle_kernel.build_tree_plain(vals_np[: 1 << check_log])
        if any(not np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"Merkle build at 2^{check_log} leaves: a level != hashlib")
        t0 = time.perf_counter()
        plain = merkle_kernel.build_tree_plain(vals_np)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(merkle_kernel.split_levels(tree.cpu().numpy())[-1], plain[-1]):
            raise AssertionError(f"Merkle build at 2^{log_n} leaves: the root != hashlib")
        ms = graph_ms(lambda: merkle_kernel.build_tree(vals), 5)
        n_comp = size + 2 * (size - 1)
        nbytes = size * bs + (2 * size - 1) * 32 + (2 * size - 2) * 32
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ins = size * MERKLE_SASS_PER_HASH["leaf"] + (size - 1) * MERKLE_SASS_PER_HASH["node"]
        ops_ms = ins / (LANE_INSTRUCTIONS_PER_CLOCK * clock_mhz * 1e6) * 1e3
        floor_ms = compress_ms * (1 + 2 * log_n)
        bound, by, src = max((ops_ms, "operations", "operations rate"), (floor_ms, "operations", "depth floor"),
                             (bytes_ms, "bytes", "bytes"))
        per_sm = ins / (ms * 1e-3 * clock_mhz * 1e6 * 132)
        name = "merkle_goldilocks" if field is GOLDILOCKS else "merkle_mont32"
        timing[("merkle", field.backend)] = (ms, plain_ms, bound, by, count, floor_ms, src)
        log(f"Merkle build, 2^{log_n} leaves of {bs} bytes ({field.name}; {n_comp} compressions; plan "
            f"{tuple(merkle_kernel.plan(size))}): {ms:.4f} ms from a CUDA graph, launches per build {count}, "
            f"{per_sm:.1f} lane-instructions per clock per SM achieved; operations bound {ops_ms:.4f} ms ({ins} "
            f"lane-instructions: pinned SASS per hash {MERKLE_SASS_PER_HASH} at {LANE_INSTRUCTIONS_PER_CLOCK} per "
            f"clock, {clock_mhz:.0f} MHz; build_kernel's own SASS by pipe {pipes}), depth floor {floor_ms:.4f} ms "
            f"({1 + 2 * log_n} compressions of {compress_ms * 1e6:.1f} ns), bytes bound {bytes_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB); {bound / ms:.1%} of the {src} bound; every level == hashlib at 2^{check_log}, "
            f"the root at 2^{log_n}; plain (hashlib) {plain_ms:.1f} ms {tag}")
        del vals, tree, small, plain
    sync()

    # the kernels line's rows
    launches = {
        ("round_kernel_k1", "goldilocks"): dispatch[(1, "goldilocks")][0]["round_kernel"],
        ("round_kernel_k1", "mont32"): dispatch[(1, "mont32")][0]["round_kernel"],
        ("round_kernel_k4", "goldilocks"): dispatch[(4, "goldilocks")][0]["round_kernel"],
        ("round_kernel_k4", "mont32"): dispatch[(4, "mont32")][0]["round_kernel"],
        ("fs_tail_d1", "goldilocks"): dispatch[(1, "goldilocks")][0]["fs_tail"],
        ("fs_tail_d1", "mont32"): dispatch[(1, "mont32")][0]["fs_tail"],
        ("fs_tail_d4", "goldilocks"): dispatch[(4, "goldilocks")][0]["fs_tail"],
        ("fs_tail_d4", "mont32"): dispatch[(4, "mont32")][0]["fs_tail"],
    }
    sources = {"round_kernel": ("thaler_study_tpu_torch/csrc/round_kernel.cu", "thaler_study_tpu/ops/pallas_round.py:341"),
               "fs_tail": ("thaler_study_tpu_torch/csrc/fs_tail.cu", "thaler_study_tpu/ops/fs_kernel.py:220")}
    for (name, backend), count in launches.items():
        ms, plain_ms, bound_ms, *floor = timing[(name, backend)]
        base = "round_kernel" if name.startswith("round") else "fs_tail"
        e = max(err.get((name, backend), 0), err.get((base + ("_k" if base == "round_kernel" else "_d"), backend), 0))
        row = {"name": f"{name}_{backend}", "route": "cuda", "source": sources[base][0],
               "replaces": sources[base][1], "launches": count, "max_abs_err": e, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
        if floor:
            row["latency_floor_ms"] = floor[0]
        rows.append(row)
    for backend in ("goldilocks", "mont32"):
        ms, plain_ms, bound_ms, by, count, floor_ms, src = timing[("merkle", backend)]
        rows.append({"name": f"merkle_{backend}", "route": "cuda", "source": "thaler_study_tpu_torch/csrc/merkle.cu",
                     "replaces": "thaler_study_tpu/ops/merkle_kernel.py:107", "launches": count,
                     "max_abs_err": err[("merkle", backend)], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": by, "bound_from": src, "latency_floor_ms": floor_ms, "library_ms": None})
    return rows


# ---- slice 13: the sharded prover on a mesh of 8 shards on one card -------
#
# Module-level like the slices above (a rehearsal passes dev = cpu and small
# sizes). The mesh is parallel.make_mesh([dev] * SHARD_COUNT): 8 shards on
# one device, the port's counterpart of the JAX tests' virtual 8-device mesh,
# so every device's shards run in one launch of a kernel's batch form.

SHARD_COUNT, SHARD_VARS = 8, 3


def _shard_mesh(dev):
    from thaler_study_tpu_torch.parallel import make_mesh

    return make_mesh([dev] * SHARD_COUNT)


def _collectives(reset=False) -> dict:
    from thaler_study_tpu_torch.parallel import sharded

    out = dict(sharded.collectives)
    if reset:
        for key in sharded.collectives:
            sharded.collectives[key] = 0
    return out


def in_turns(runs: dict, reps: int, sync) -> dict:
    """Host-clock ms of each named run, ``reps`` times each, in turns (the
    order reversed every other pass): name -> (median, all)."""
    out = {name: [] for name in runs}
    names = list(runs)
    for i in range(reps):
        for name in names if i % 2 == 0 else names[::-1]:
            sync()
            t0 = time.perf_counter()
            runs[name]()
            sync()
            out[name].append((time.perf_counter() - t0) * 1e3)
    return {name: (statistics.median(v), v) for name, v in out.items()}


def sharded_gkr(cases, dev, sync, reset_counts, tag, reps=2) -> dict:
    """Slice 13's per-layer GKR prover with ``mesh=`` (8 shards on one card,
    n_shard 3) on the flagship circuit: for each (field, circuit, inputs,
    unsharded transcript) of ``cases`` the sharded transcript byte-identical
    to the unsharded one, K1's launches and the collectives of one proof;
    both proofs timed in turns; ``api.run_gkr(mesh=, n_shard=)`` accepts
    (first case). Returns per field backend (K1 TOTAL launches,
    collectives)."""
    from thaler_study_tpu_torch import api, gkr
    from thaler_study_tpu_torch.ops import cuda_round

    mesh = _shard_mesh(dev)
    out = {}
    for i, (field, circuit, inputs, transcript) in enumerate(cases):
        sync()
        reset_counts()
        _collectives(reset=True)
        t0 = time.perf_counter()
        t = gkr.generate_gkr_transcript(gkr.Prover(circuit, inputs, field, mesh=mesh, n_shard=SHARD_VARS), field)
        first_s = time.perf_counter() - t0
        launches, coll = cuda_round.total_launches[field.backend], _collectives()
        if t.to_bytes() != transcript.to_bytes():
            raise AssertionError(f"sharded per-layer GKR ({field.name}) != the unsharded transcript")
        depth = len(circuit.layers)
        rounds = sum(2 * circuit.num_vars_at(j + 1) for j in range(depth))
        times = in_turns({
            "unsharded": lambda: gkr.generate_gkr_transcript(gkr.Prover(circuit, inputs, field), field),
            "sharded": lambda: gkr.generate_gkr_transcript(
                gkr.Prover(circuit, inputs, field, mesh=mesh, n_shard=SHARD_VARS), field),
        }, reps, sync)
        log(f"sharded per-layer GKR {field.name} ({depth} layers, mesh of {SHARD_COUNT} shards on {dev}, n_shard "
            f"{SHARD_VARS}): byte-identical to the unsharded transcript ({len(t.g)} messages); prove "
            f"{times['sharded'][0] / 1e3:.3f} s (runs {[round(x / 1e3, 3) for x in times['sharded'][1]]}; first "
            f"{first_s:.3f} s) beside the unsharded {times['unsharded'][0] / 1e3:.3f} s (runs "
            f"{[round(x / 1e3, 3) for x in times['unsharded'][1]]}), in turns; K1 TOTAL launches {launches} ({rounds} "
            f"rounds); collectives {coll} {tag}")
        if i == 0:
            outs, ok = api.run_gkr(circuit, inputs, field, seed=13, mesh=mesh, n_shard=SHARD_VARS)
            want = gkr.deserialize_gkr_message(transcript.g[0], field).circuit_outputs
            if not ok or [f.v for f in outs] != [int(v) for v in want.ints]:
                raise AssertionError(f"api.run_gkr(mesh=, n_shard=) on the flagship ({field.name}): accepted {ok}")
            log(f"api.run_gkr(mesh=, n_shard={SHARD_VARS}) on the flagship ({field.name}): accepted, the same "
                f"outputs {tag}")
        out[field.backend] = (launches, coll)
    return out


def sharded_slice(seed, tag, dev, sync, graph_ms, reset_counts, compress_ms, gkr_info, reps=5, n=28, gkr_log=20,
                  tri_nodes=TRI_NODES, tri_nodes_small=TRI_NODES_SMALL):
    """Phases 2, 3 and 5 of slice 13; returns its rows of the ``kernels``
    line. ``gkr_info``: :func:`sharded_gkr`'s result; ``n``: the sharded FS
    proofs' variables (main passes the batch cell's bytes: 2 x 2^28 words);
    ``gkr_log``: the flagship's width, whose shards K1 is checked at."""
    import dataclasses
    import os
    import tempfile

    import torch

    from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray
    from thaler_study_tpu_torch.fields.farray import word_dtype
    from thaler_study_tpu_torch.fiat_shamir import (
        SumcheckInteractiveProver,
        generate_transcript,
        generate_transcript_device,
    )
    from thaler_study_tpu_torch.ops import cuda_round, fs_kernel, modmatmul, multiblock, row_sums, shard_layout
    from thaler_study_tpu_torch.ops.round_kernel import PolySpec, single_block_spec
    from thaler_study_tpu_torch.ops.sha_chain import DevChain
    from thaler_study_tpu_torch.parallel import ShardedBlockPoly, init_distributed, make_mesh_2d
    from thaler_study_tpu_torch.protocols import TriangleG
    from thaler_study_tpu_torch.sumcheck import Prover

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)
    mesh = _shard_mesh(dev)
    S = SHARD_COUNT
    err, timing, library, extra = {}, {}, {}, {}

    def wb_of(field):
        return 8 if field.backend == "goldilocks" else 4

    def note_err(key, e, what):
        if e:
            raise AssertionError(f"{key[0]} kernel != plain ({key[1]}): {what}")
        err[key] = max(err.get(key, 0), e)

    def plain_ms(fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    # ---- phase 2: the tensor-core matmul at the sharded triangle's
    # per-shard shapes: X round 0 (M = 2^(k-1) of A_t, N = 2^k rows of f2_s,
    # K = 2^(k - 3) of Z per shard) and the middle of the X phase, the shard
    # rows as one contraction (the dot form), f1 (D) shared by the shards;
    # its batched digit pre-pass; the batched C = A B^T at ragged shapes
    k_tri = (tri_nodes - 1).bit_length()
    zl = k_tri - SHARD_VARS
    for field in (GOLDILOCKS, BABYBEAR):
        wb, nd = wb_of(field), modmatmul.DIGITS[field.backend]
        for label, m in (("X round 0", 1 << (k_tri - 1)), ("middle of the X phase", 1 << (k_tri // 2 - 1))):
            a = slice_words(gen, field, (S, 2 * m, 1 << zl), dev)
            b = slice_words(gen, field, (S, 1 << k_tri, 1 << zl), dev)
            d = slice_words(gen, field, (2 * m, 1 << k_tri), dev)
            planes = modmatmul.digit_planes(a, field, 2)
            want_planes = torch.cat([modmatmul.digit_planes_plain(a[s], field, 2) for s in range(S)], dim=1)
            note_err(("modmatmul_digits_batched", field.backend), word_err(planes, want_planes), f"{label} A_t")
            b_planes = modmatmul.digit_planes(b, field)
            tw = modmatmul._t_word(field, 2)
            kp = modmatmul.padded_k(1 << zl)
            products = S * m * (1 << k_tri) * (1 << zl)
            ops_ms = products * TC_PAIRS[field.backend] / TC_MACS_PER_S * 1e3
            bytes_ms = (nd * kp * S * (m + (1 << k_tri)) + 2 * m * (1 << k_tri) * wb) / PEAK_BYTES_PER_S * 1e3
            d_ms = graph_ms(lambda: modmatmul.digit_planes(a, field, 2))
            d_plain = plain_ms(lambda: [modmatmul.digit_planes_plain(a[s], field, 2) for s in range(S)])
            # library_ms: the byte planes of the same words as one torch call
            # sequence (view as bytes, permute, pad to Kp, copy) over A_t's
            # S x M words, the view at t made before it (not in its time)
            a_t = torch.cat([FArray.fold(FArray(a[s, :m], field), FArray(a[s, m:], field),
                                         FArray.scalar(field.felt(2), device=dev)).data for s in range(S)])
            d_lib = graph_ms(lambda: torch.nn.functional.pad(
                a_t.view(torch.uint8).reshape(S * m, 1 << zl, nd).permute(2, 0, 1), (0, kp - (1 << zl))).contiguous())
            d_bytes = (2 * S * m * (1 << zl) * wb + nd * S * m * kp) / PEAK_BYTES_PER_S * 1e3
            log(f"{field.name} tensor-core digit pre-pass over the {S} shards' A_t, {tri_nodes}-node sharded "
                f"triangle {label} ({S} shards x 2M = {2 * m}, K = {1 << zl}) == plain (exact): {d_ms:.4f} ms from a "
                f"CUDA graph, bytes bound {d_bytes:.4f} ms {tag}")
            # the dot form (the sharded path's): the S shard rows as one
            # contraction over K_dev = S K, summed in the launch into the row
            row = torch.full((3,), 7, dtype=word_dtype(field), device=dev)
            modmatmul.contract_total(a, b, d, field, [0, 2], row)
            t0 = time.perf_counter()
            want_row = [modmatmul.contract_total_plain(a, b, d, field, t, digits=True) for t in (0, 2)]
            sync()
            r_plain = (time.perf_counter() - t0) * 1e3 / 2
            note_err(("modmatmul_tc_total", field.backend),
                     max(word_err(row[c].reshape(1), w.reshape(1)) for c, w in zip((0, 2), want_row))
                     + (int(row[1]) != 0), f"{label}, {S} shard rows as one contraction")
            splits = modmatmul.splits_for(dev, field, m, 1 << k_tri, 1 << zl, S) if dev.type == "cuda" else 1
            r_partials = torch.empty(splits * modmatmul.tile_count(field, True, m, 1 << k_tri),
                                     dtype=word_dtype(field), device=dev)

            def dot_launch():
                modmatmul._launch_dot(field, 2, planes, b_planes, d, tw, r_partials, row, -1, S, m, 1 << k_tri,
                                      1 << zl, splits)

            r_ms = graph_ms(dot_launch)
            log(f"{field.name} tensor-core matmul dot form over shard rows (K_dev = {S} x {1 << zl}), {tri_nodes}-node "
                f"sharded triangle {label} ({S} shards x M = {m}, N = {1 << k_tri}; f1 shared), mode 2 at t = 0, 2 == "
                f"plain (exact): {r_ms:.4f} ms per launch from a CUDA graph ({splits} K ranges per tile); operations "
                f"bound {ops_ms:.4f} ms ({products} products x {TC_PAIRS[field.backend]} digit pairs at "
                f"{TC_MACS_PER_S / 1e12} T multiply-adds/s; bytes {bytes_ms:.4f} ms): "
                f"{100 * max(ops_ms, bytes_ms) / r_ms:.1f} %; plain {r_plain:.1f} ms per t {tag}")
            if label == "X round 0":
                timing[("modmatmul_tc_total", field.backend)] = (r_ms, r_plain, max(ops_ms, bytes_ms),
                                                                 "operations" if ops_ms >= bytes_ms else "bytes")
                timing[("modmatmul_digits_batched", field.backend)] = (d_ms, d_plain, d_bytes, "bytes")
                library[("modmatmul_digits_batched", field.backend)] = (
                    d_lib, "torch.nn.functional.pad(x.view(torch.uint8).reshape(R, K, D).permute(2, 0, 1), "
                           "(0, Kp - K)).contiguous() over A_t's words (the view at t not in it)")
                log(f"{field.name} batched digit pre-pass library yardstick (the byte planes of A_t's {S * m} x "
                    f"{1 << zl} words by view, permute, pad and copy): {d_lib:.4f} ms from a CUDA graph, the kernel "
                    f"{d_ms:.4f} ms {tag}")
            del a, b, d, planes, want_planes, b_planes
        for (bs, m_, n_, k_) in ((3, 33, 65, 100), (2, 64, 64, 16), (1, 1, 7, 3)):
            a = FArray(slice_words(gen, field, (bs, m_, k_), dev), field)
            b = FArray(slice_words(gen, field, (bs, n_, k_), dev), field)
            got = modmatmul.modmatmul_batched(a, b)
            want = torch.stack([modmatmul.modmatmul_plain(a[s], b[s]).data for s in range(bs)])
            note_err(("modmatmul_tc_batched", field.backend), word_err(got.data, want), f"C = A B^T {bs}x{m_}x{n_}x{k_}")
        log(f"{field.name} batched C = A B^T (mode 0) == the plain product at S x M x N x K = 3x33x65x100, "
            f"2x64x64x16, 1x1x7x3 {tag}")
    sync()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- phase 2: the shard layout (ops/shard_layout.py: a group's shard
    # rows cut out of a table and transposed) against its plain version
    # (.T.contiguous() of the [L, S] view), exact: the n-variable proof's
    # tables (S = 8, the whole group; words at p - 1 too), then small odd
    # shapes (S = 2, S = 64, a 4-row group at row0 = 4, a 3-row group, one
    # row); at n timed from CUDA graphs beside .T.contiguous() itself (the
    # library call) and its bytes bound (each word read once, written once)
    layout_cases = ((n, SHARD_VARS, 0, S, "random"), (n - 2, SHARD_VARS, 0, S, "max"), (12, 1, 0, 2, "random"),
                    (12, 1, 1, 1, "random"), (14, 6, 0, 64, "random"), (13, 6, 32, 32, "random"),
                    (13, 3, 4, 4, "random"), (11, 3, 1, 3, "random"), (9, 3, 7, 1, "random"))
    for field in (GOLDILOCKS, BABYBEAR):
        wb = wb_of(field)
        for n_, n_shard, row0, rows, fill in layout_cases:
            x = slice_words(gen, field, (1 << n_,), dev, fill)
            got = shard_layout.shard_rows(x, n_shard, row0, rows)
            want = shard_layout.shard_rows_plain(x, n_shard, row0, rows)
            note_err(("shard_layout", field.backend), word_err(got, want),
                     f"2^{n_} words, S = {1 << n_shard}, rows [{row0}, {row0 + rows}), {fill}")
            del got, want
            if (n_, n_shard, row0, rows, fill) != layout_cases[0]:
                del x
                continue
            cols = 1 << (n - SHARD_VARS)
            ms = graph_ms(lambda: shard_layout.shard_rows(x, SHARD_VARS, 0, S), count=5)
            lib_ms = graph_ms(lambda: x.reshape(cols, S).T.contiguous(), count=5)
            t_plain = plain_ms(lambda: shard_layout.shard_rows_plain(x, SHARD_VARS, 0, S))
            bound = 2 * (1 << n) * wb / PEAK_BYTES_PER_S * 1e3
            timing[("shard_layout", field.backend)] = (ms, t_plain, bound, "bytes")
            library[("shard_layout", field.backend)] = (lib_ms, "x.reshape(L, S).T.contiguous()")
            tc, tl = shard_layout.tile(S, cols, wb)
            log(f"{field.name} shard layout kernel, 2^{n} words ({(1 << n) * wb / 1e9:.2f} GB) to {S} shard rows of "
                f"2^{n - SHARD_VARS} (tiles of {tl} source rows x {tc} columns) == plain (exact), and at "
                f"{len(layout_cases) - 1} more shapes (S = 2, 8, 64; whole, partial and one-row groups; words at "
                f"p - 1): {ms:.4f} ms from a CUDA graph, bytes bound {bound:.4f} ms ({2 * (1 << n) * wb / 1e9:.2f} GB "
                f"at 3.35 TB/s): {100 * bound / ms:.1f} %; .T.contiguous() {lib_ms:.4f} ms ({100 * bound / lib_ms:.1f} "
                f"%) from a CUDA graph, {lib_ms / ms:.2f}x the kernel; plain {t_plain:.2f} ms {tag}")
            del x
    sync()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- phase 2: the no-claim round sums at the sharded paths' shapes: the
    # batch round kernel over the S shard rows of the n-variable proof
    # (round 1: fold and skip-1, s(1) left 0), K1 over the flagship's S
    # shards of 2^17 (both LibraW phases), MB over one shard row of the
    # sharded triangle's Y phase with the replicated f1 folded before it;
    # then the FS tail over the S x blocks partial rows
    local = n - SHARD_VARS
    for field in (GOLDILOCKS, BABYBEAR):
        wb = wb_of(field)
        tabs = [slice_words(gen, field, (S, 1 << local), dev) for _ in range(2)]
        r = slice_words(gen, field, (1,), dev)  # every row folds at the proof's one challenge
        outs = [torch.empty((S, 1 << (local - 1)), dtype=word_dtype(field), device=dev) for _ in range(2)]
        folded, partials = cuda_round.round_partials(tabs, r, True, out=outs, field=field)
        blocks = cuda_round.blocks_for(S, 1 << (local - 2))
        t0 = time.perf_counter()
        pf, pp = cuda_round.round_partials_plain(tabs, r.expand(S).contiguous(), True, blocks, field)
        sync()
        t_plain = (time.perf_counter() - t0) * 1e3
        note_err(("round_kernel_sharded", field.backend),
                 max([word_err(partials, pp)] + [word_err(x, y) for x, y in zip(folded, pf)]),
                 f"{S} shard rows of 2^{local}, fold, skip-1")
        if int(partials[:, :, 1].abs().sum()):
            raise AssertionError("the round kernel spliced s(1) into a shard's partials")
        ms = graph_ms(lambda: cuda_round.round_partials(tabs, r, True, out=outs, field=field))
        bound = (2 * S * (1 << local) + 2 * S * (1 << (local - 1))) * wb / PEAK_BYTES_PER_S * 1e3
        timing[("round_kernel_sharded", field.backend)] = (ms, t_plain, bound, "bytes")
        log(f"{field.name} batch round kernel over {S} shard rows of 2^{local} (the n = {n} proof's round 1: fold, "
            f"s(1) left 0) == plain (exact): {ms:.4f} ms from a CUDA graph, bytes bound {bound:.4f} ms: "
            f"{100 * bound / ms:.1f} %; plain {t_plain:.1f} ms {tag}")
        # the FS tail over these S x blocks rows (degree 2, round 1)
        rows = partials.reshape(1, -1, 3).contiguous()
        vinv = fs_kernel.interp_tensor(field, 2, dev)
        nbytes = 64 * 7 + 40
        m_len = fs_kernel._msg_len(1, 2, field.byte_size)
        claim = slice_words(gen, field, (1,), dev)

        def state():
            chain = DevChain.fresh(1, dev)
            chain.state.copy_(torch.arange(8, device=dev, dtype=torch.int32).reshape(1, 8) * 40503 + 7)
            chain.buf[:, :40] = (torch.arange(40, device=dev) * 7 % 256).to(torch.uint8)
            chain.nbytes = nbytes
            w = word_dtype(field)
            return [chain, claim.clone(), torch.zeros(1, dtype=w, device=dev),
                    torch.zeros(1, dtype=w, device=dev), torch.zeros((1, 3 * n), dtype=w, device=dev),
                    torch.zeros((1, nbytes + m_len), dtype=torch.uint8, device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev), vinv]

        kst, pst = state(), state()
        fs_kernel.fs_tail(rows, *kst, 1, 3, True, field)
        t0 = time.perf_counter()
        fs_kernel.fs_tail_plain(rows, *pst, 1, 3, True, field)
        t_plain = (time.perf_counter() - t0) * 1e3
        sync()
        pairs = [(kst[0].state, pst[0].state), (kst[0].buf, pst[0].buf)] + list(zip(kst[1:7], pst[1:7]))
        note_err(("fs_tail_sharded", field.backend), max(word_err(x.to(torch.int64), y.to(torch.int64))
                                                         for x, y in pairs), f"{rows.shape[1]} shard partial rows")
        tst = state()

        def tail():
            tst[0].nbytes = nbytes
            fs_kernel.fs_tail(rows, *tst, 1, 3, True, field)

        # the form fs_kernel.tail_warps picks (the wide form at these rows),
        # in turns with the one-warp form forced on the same rows (the
        # earlier design; checked against the plain version too) and with
        # the one-warp tail over the batch dispatch's 32 rows per proof
        wide_warps = fs_kernel.tail_warps(rows.shape[1])
        rows32 = rows[:, : cuda_round.blocks_for(64, 1 << 20)].contiguous()
        ost, picks = state(), fs_kernel.tail_warps

        def tail32():
            tst[0].nbytes = nbytes
            fs_kernel.fs_tail(rows32, *tst, 1, 3, True, field)

        per_form = {"wide": [], "one": [], "32": []}
        try:
            fs_kernel.tail_warps = lambda blocks: 1
            fs_kernel.fs_tail(rows, *ost, 1, 3, True, field)
            sync()
            pairs = [(ost[0].state, pst[0].state), (ost[0].buf, pst[0].buf)] + list(zip(ost[1:7], pst[1:7]))
            note_err(("fs_tail_sharded", field.backend), max(word_err(x.to(torch.int64), y.to(torch.int64))
                                                             for x, y in pairs), "the one-warp form")
            for _ in range(2):
                fs_kernel.tail_warps = picks
                per_form["wide"].append(graph_ms(tail))
                fs_kernel.tail_warps = lambda blocks: 1
                per_form["one"].append(graph_ms(tail))
                fs_kernel.tail_warps = picks
                per_form["32"].append(graph_ms(tail32))
        finally:
            fs_kernel.tail_warps = picks
        ms = min(per_form["wide"])
        t_bytes = rows.numel() * wb + 2 * (32 + 64 + 4) + m_len + 4 * wb
        floor = compressions(nbytes, m_len, True) * compress_ms
        timing[("fs_tail_sharded", field.backend)] = (ms, t_plain, t_bytes / PEAK_BYTES_PER_S * 1e3, "bytes", floor)
        extra[("fs_tail_sharded", field.backend)] = {
            "warps": wide_warps, "one_warp_ms": min(per_form["one"]), "rows32_ms": min(per_form["32"])}
        fmt = {k_: " / ".join(f"{x * 1e3:.2f}" for x in v) for k_, v in per_form.items()}
        log(f"{field.name} FS tail over {rows.shape[1]} shard partial rows (degree 2, round 1, fill 40) == plain "
            f"(exact), {wide_warps} warps per proof (fs_kernel.tail_warps): {fmt['wide']} us per launch from CUDA "
            f"graphs, in turns with the one-warp form on the same rows {fmt['one']} us (== plain too) and the "
            f"one-warp tail over {rows32.shape[1]} rows (the batch dispatch's per proof) "
            f"{fmt['32']} us; latency floor {floor * 1e3:.2f} us ({compressions(nbytes, m_len, True)} "
            f"compressions); plain {t_plain:.2f} ms {tag}")
        del tabs, outs, folded, partials, pf, pp
        # K1 over the flagship's shards: 2^20 entries, n_shard 3
        kl = gkr_log - SHARD_VARS
        k1_tabs = [slice_words(gen, field, (S, 1 << kl), dev) for _ in range(3)]
        k1_max = [slice_words(gen, field, (S, 1 << kl), dev, "max") for _ in range(3)]
        k1_out = [torch.empty((S, 1 << (kl - 1)), dtype=word_dtype(field), device=dev) for _ in range(3)]
        scalar = [slice_words(gen, field, (1,), dev)]
        rs, scs = r.expand(S).contiguous(), [scalar[0].expand(S).contiguous()]
        total = torch.empty((3,), dtype=word_dtype(field), device=dev)
        for phase, terms, n_sc in ((1, cuda_round.LIBRA_PHASE1, 0), (2, cuda_round.LIBRA_PHASE2, 1)):
            f, s = cuda_round.libra_round_sums(k1_tabs, rs, True, k1_out, field, terms, scs[:n_sc])
            pf, ps = cuda_round.libra_round_sums_plain(k1_tabs, rs, True, field, terms, scs[:n_sc])
            note_err(("libra_round_sharded", field.backend),
                     max([word_err(s, ps)] + [word_err(x, y) for x, y in zip(f, pf)]), f"phase {phase}, {S} shards")
            if int(s[:, 1].abs().sum()):
                raise AssertionError("K1 spliced s(1) into a shard's sums")
            # the TOTAL form (the sharded path's): the rows summed in the launch
            for tabs_, fold_ in ((k1_tabs, True), (k1_tabs, False), (k1_max, True)):
                rr = r if fold_ else None
                f, s = cuda_round.libra_round_total(tabs_, rr, True, field, terms, scalar[:n_sc])
                pf, ps = cuda_round.libra_round_total_plain(tabs_, rr, True, field, terms, scalar[:n_sc])
                note_err(("libra_round_total", field.backend),
                         max([word_err(s, ps)] + [word_err(x, y) for x, y in zip(f or [], pf or [])]),
                         f"TOTAL phase {phase}, {S} shard rows, fold {fold_}")
                if int(s[1]):
                    raise AssertionError("K1 TOTAL wrote an s(1) where the round leaves it out")
        ms = graph_ms(lambda: cuda_round.libra_round_sums(k1_tabs, rs, True, k1_out, field, cuda_round.LIBRA_PHASE1))
        t_ms = graph_ms(lambda: cuda_round.libra_round_total(k1_tabs, r, True, field, cuda_round.LIBRA_PHASE1,
                                                             out=k1_out, total=total))
        t2_ms = graph_ms(lambda: cuda_round.libra_round_total(k1_tabs, r, True, field, cuda_round.LIBRA_PHASE2,
                                                              scalar, out=k1_out, total=total))
        one = [t.reshape(1, -1) for t in k1_tabs]
        one_out = [o.reshape(1, -1) for o in k1_out]
        u_ms = graph_ms(lambda: cuda_round.libra_round_sums(one, r, True, one_out, field, cuda_round.LIBRA_PHASE1))
        t_plain = plain_ms(lambda: cuda_round.libra_round_total_plain(k1_tabs, r, True, field,
                                                                      cuda_round.LIBRA_PHASE1))
        bound = (3 * S * (1 << kl) + 3 * S * (1 << (kl - 1))) * wb / PEAK_BYTES_PER_S * 1e3
        timing[("libra_round_total", field.backend)] = (t_ms, t_plain, bound, "bytes")
        log(f"{field.name} K1 (LibraW phases 1 and 2) over {S} shard rows of 2^{kl} (the flagship's layers at "
            f"n_shard {SHARD_VARS}: fold, s(1) left 0), the per-row form and the TOTAL form (the rows summed in the "
            f"launch; random words and words at p - 1) == plain (exact): phase 1 TOTAL {t_ms:.5f} ms from a CUDA "
            f"graph (phase 2 {t2_ms:.5f} ms), the per-row form {ms:.5f} ms, the unsharded K1 over the same 2^{gkr_log} "
            f"entries {u_ms:.5f} ms; bytes bound {bound:.5f} ms: TOTAL {100 * bound / t_ms:.1f} %, per-row "
            f"{100 * bound / ms:.1f} %; plain {t_plain:.1f} ms {tag}")
        del k1_tabs, k1_max, k1_out, one, one_out
        # MB over the sharded triangle's Y phase, one shard row and the rows
        # form (the S shard rows of the card in one launch, the rows' sums
        # added): the X -> Y round (f1(X,Y) replicated, folded before; f3(X,
        # Z_s) folded in the launch) and the middle of the Y phase (f1(Y)
        # folded before, f2 folded in the launch); the fold's rows form over
        # the S rows of the sharded tables
        spec_x = PolySpec((1, k_tri, zl), TRI_BLOCKS, ((0, 1, 2),))
        spec_y = PolySpec((k_tri // 2, zl), ((0,), (0, 1), (1,)), ((0, 1, 2),))
        for label, spec in (("X -> Y round", spec_x), ("middle of the Y phase", spec_y)):
            post = spec.after_fold()
            plan = multiblock.round_plan(spec, True, spec.terms, post.degree())
            plan = dataclasses.replace(plan, folded=tuple(f and k != 0 for k, f in enumerate(plan.folded)))
            sizes = [plan.sizes[k] * (2 if plan.folded[k] else 1) for k in range(3)]
            mb_rows = [slice_words(gen, field, (sizes[0],), dev)] + [slice_words(gen, field, (S, sizes[k]), dev)
                                                                       for k in (1, 2)]
            mb_tabs = [mb_rows[0], mb_rows[1][0], mb_rows[2][0]]
            got_f, got_s = multiblock.round_sums(plan, mb_tabs, r[:1], field, True, None)
            want_f, want_s = multiblock.round_sums_plain(plan, mb_tabs, r[:1], field, True, None)
            note_err(("multiblock_round_sharded", field.backend),
                     max([word_err(got_s, want_s)] + [word_err(x, y) for x, y in zip(got_f, want_f) if x is not None]),
                     label)
            if int(got_s[1]):
                raise AssertionError("MB spliced s(1) into a shard's sums")
            # the rows form: every shard row in one launch, summed into a
            # row of the round's buffer; scaled by 2^n_shard (a replicated-
            # only term's form), with the claim, and without skip-1
            buf = torch.zeros((3, plan.degree + 1), dtype=word_dtype(field), device=dev)
            claim = slice_words(gen, field, (1,), dev)
            for skip, cl, scale in ((True, None, None), (True, None, 1 << SHARD_VARS), (True, claim, None),
                                    (False, None, None)):
                got_f, row_s = multiblock.round_sums(plan, mb_rows, r[:1], field, skip, cl, sums=buf[1], scale=scale)
                want_f, want_sc = multiblock.round_sums_plain(plan, mb_rows, r[:1], field, skip, cl, scale)
                note_err(("multiblock_round_sharded", field.backend),
                         max([word_err(row_s, want_sc), int(row_s.data_ptr() != buf[1].data_ptr()),
                              int(bool(buf[0].any()))] + [word_err(x, y) for x, y in zip(got_f, want_f)
                                                          if x is not None]),
                         f"{label}, the rows form over {S} shard rows, skip-1 {skip}, claim {cl is not None}, "
                         f"scale {scale}")
                if skip and cl is None and int(row_s[1]):
                    raise AssertionError("MB's rows form spliced s(1) into the device's sums")
            # the fold's rows form: the S rows of both sharded tables
            halves = [sizes[k] // 2 if plan.folded[k] else 0 for k in (1, 2)]
            got = multiblock.fold_tables(mb_rows[1:], halves, r[:1], field)
            want = multiblock.fold_tables_plain(mb_rows[1:], halves, r[:1], field)
            note_err(("multiblock_fold_rows", field.backend), max(word_err(x, y) for x, y in zip(got, want)),
                     f"{label}, the fold's rows form over {S} shard rows")
            if label == "X -> Y round":
                rows_ms = graph_ms(lambda: multiblock.round_sums(plan, mb_rows, r[:1], field, True, None))
                mb_ms = graph_ms(lambda: [multiblock.round_sums(plan, [mb_rows[0], mb_rows[1][i], mb_rows[2][i]], r[:1],
                                                                field, True, None) for i in range(S)])
                t_plain = plain_ms(lambda: multiblock.round_sums_plain(plan, mb_rows, r[:1], field, True, None))
                moved = sum(t.numel() for t in mb_rows) + S * sum(n_ for n_, f in zip(plan.sizes, plan.folded) if f)
                bound = moved * wb / PEAK_BYTES_PER_S * 1e3
                timing[("multiblock_round_sharded", field.backend)] = (rows_ms, t_plain, bound, "bytes")
                log(f"{field.name} MB over the {S} shard rows of the {tri_nodes}-node sharded triangle, {label} (f1 "
                    f"folded before, s(1) left 0; {multiblock.kernel_class(plan)}, tiles "
                    f"{multiblock.layout(plan, wb, shards=S).tiles} a row) == plain (exact), the rows form with its "
                    f"scale, claim and no skip-1 too: the rows form {rows_ms:.4f} ms per launch from a CUDA graph, "
                    f"{S} per-row launches {mb_ms:.4f} ms ({mb_ms / S:.4f} ms each); bytes bound over the rows "
                    f"{bound:.4f} ms: rows form {100 * bound / rows_ms:.1f} %, per-row {100 * bound / mb_ms:.1f} %; "
                    f"plain {t_plain:.1f} ms {tag}")
            del mb_rows, mb_tabs
        log(f"{field.name} MB over one shard row, its rows form and the fold's rows form == plain (exact) at the "
            f"middle of the Y phase too {tag}")
        # the fold's rows form where the sharded rounds fold most: f3(X, Z_s)
        # of every shard row at the X phase's round 1 (the contracted rounds
        # fold before their sums), against one launch per row
        f3 = slice_words(gen, field, (S, 1 << (k_tri + zl)), dev)
        half = [1 << (k_tri + zl - 1)]
        got, want = multiblock.fold_tables([f3], half, r[:1], field), multiblock.fold_tables_plain([f3], half, r[:1], field)
        note_err(("multiblock_fold_rows", field.backend), word_err(got[0], want[0]),
                 f"f3 of {S} shard rows of 2^{k_tri + zl}, the X phase's round 1")
        fold_ms = graph_ms(lambda: multiblock.fold_tables([f3], half, r[:1], field))
        fold_rows_ms = graph_ms(lambda: [multiblock.fold_tables([f3[i]], half, r[:1], field) for i in range(S)])
        f_plain = plain_ms(lambda: multiblock.fold_tables_plain([f3], half, r[:1], field))
        f_bound = (f3.numel() + S * half[0]) * wb / PEAK_BYTES_PER_S * 1e3
        timing[("multiblock_fold_rows", field.backend)] = (fold_ms, f_plain, f_bound, "bytes")
        log(f"{field.name} MB's fold, rows form: f3 of the {S} shard rows of 2^{k_tri + zl} at the {tri_nodes}-node "
            f"sharded triangle's X round 1 == plain (exact): {fold_ms:.4f} ms per launch from a CUDA graph, {S} "
            f"per-row launches {fold_rows_ms:.4f} ms; bytes bound {f_bound:.4f} ms: {100 * f_bound / fold_ms:.1f} % "
            f"(per-row {100 * f_bound / fold_rows_ms:.1f} %); plain {f_plain:.1f} ms {tag}")
        del f3, got, want
    sync()

    # ---- phase 2: the reduction's row sums (ops/row_sums.py): a device's
    # rows to one row (the n-variable proof's S x blocks partial rows, words
    # at p - 1 too), to 32-bit lanes and, summed over 7 "processes", back
    for field in (GOLDILOCKS, BABYBEAR):
        wb = wb_of(field)
        nrows = S * cuda_round.blocks_for(S, 1 << (n - SHARD_VARS - 2))
        for rows_n, d1, fill in ((nrows, 3, "random"), (nrows, 3, "max"), (1, 9, "random"), (5, 5, "random")):
            x = slice_words(gen, field, (rows_n, d1), dev, fill)
            lanes = row_sums.row_sums(x, field, out_lanes=True)
            want_l = row_sums.row_sums_plain(x, field, out_lanes=True)
            e = max(word_err(row_sums.row_sums(x, field), row_sums.row_sums_plain(x, field)), word_err(lanes, want_l),
                    word_err(row_sums.row_sums(lanes * 7, field, in_lanes=True),
                             row_sums.row_sums_plain(want_l * 7, field, in_lanes=True)))
            note_err(("row_sums", field.backend), e, f"{rows_n} rows of {d1}, {fill}")
        x = slice_words(gen, field, (nrows, 3), dev)
        ms = graph_ms(lambda: row_sums.row_sums(x, field))
        t_plain = plain_ms(lambda: row_sums.row_sums_plain(x, field))
        bound = (x.numel() + 3) * wb / PEAK_BYTES_PER_S * 1e3
        # the latency floor: one empty one-block launch, timed the same way
        floor = graph_ms(lambda: row_sums.empty_launch(dev))
        timing[("row_sums", field.backend)] = (ms, t_plain, bound, "bytes", floor)
        log(f"{field.name} row sums (one block) == plain (exact): {nrows} rows of 3 to one row, its lanes, lanes "
            f"back to words; {ms * 1e3:.2f} us per launch from a CUDA graph at {nrows} rows, bytes bound "
            f"{bound * 1e3:.3f} us, latency floor (one empty one-block launch from a CUDA graph) {floor * 1e3:.2f} "
            f"us: {ms / floor:.2f}x the floor; plain {t_plain:.2f} ms {tag}")
        del x
    sync()

    # ---- phase 3: the sharded fused FS prover, a 2-factor product at n
    # variables, n_shard 3, over Goldilocks and BabyBear: the bytes equal
    # fs_prove_device's on the same tables; both timed in turns
    fs_rows = {}
    keep = None
    for field in (GOLDILOCKS, BABYBEAR):
        spec = single_block_spec(2, n)
        tables = [FArray(slice_words(gen, field, (1 << n,), dev), field) for _ in range(2)]
        ref = fs_kernel.fs_prove_device(spec, tables)
        sync()
        reset_counts()
        _collectives(reset=True)
        got = fs_kernel.fs_prove_device_sharded(spec, tables, mesh, n_shard=SHARD_VARS)
        sync()
        launches = {"round_kernel": cuda_round.launches[field.backend], "fs_tail": fs_kernel.launches[field.backend],
                    "multiblock_fold": multiblock.fold_launches[field.backend],
                    "shard_layout": shard_layout.launches[field.backend]}
        coll = _collectives()
        if ref is None or got is None or [m.hex() for m in got] != [m.hex() for m in ref]:
            raise AssertionError(f"sharded FS proof ({field.name}, n = {n}) != fs_prove_device")
        # every shard is on the one card: a reduction sends no words off it;
        # the layout: one launch per factor table and group (one group)
        want_coll = {"reduce": n - SHARD_VARS, "reduce_words": 0, "gather": 2, "gather_words": 2 * (1 << SHARD_VARS)}
        if (coll != want_coll or launches["fs_tail"] != n or launches["round_kernel"] != n
                or dev.type == "cuda" and launches["shard_layout"] != 2):
            raise AssertionError(f"sharded FS proof ({field.name}): collectives {coll} (want {want_coll}), launches "
                                 f"{launches}")
        times = in_turns({"fs_prove_device": lambda: fs_kernel.fs_prove_device(spec, tables),
                          "fs_prove_device_sharded": lambda: fs_kernel.fs_prove_device_sharded(
                              spec, tables, mesh, n_shard=SHARD_VARS),
                          "layout": lambda: ShardedBlockPoly.from_internal_tables(spec, tables, mesh,
                                                                                  n_shard=SHARD_VARS)}, reps, sync)
        fs_rows[field.backend] = launches
        log(f"sharded fused FS prover {field.name}, 2 x 2^{n} words ({2 * (1 << n) * wb_of(field) / 1e9:.2f} GB), "
            f"mesh of {S} shards on {dev}, n_shard {SHARD_VARS}: byte-identical to fs_prove_device ({len(got)} "
            f"messages); median of {reps} in turns {times['fs_prove_device_sharded'][0]:.3f} ms (runs "
            f"{[round(x, 3) for x in times['fs_prove_device_sharded'][1]]}) beside the unsharded "
            f"{times['fs_prove_device'][0]:.3f} ms ({[round(x, 3) for x in times['fs_prove_device'][1]]}); of the "
            f"sharded proof, the layout (ShardedBlockPoly.from_internal_tables: the [L, S] -> [S, L] kernel) alone "
            f"{times['layout'][0]:.3f} ms ({[round(x, 3) for x in times['layout'][1]]}); "
            f"collectives {coll}: one reduction per sharded round (no word leaves the card), {coll['gather']} "
            f"gathers of 2^{SHARD_VARS} at the transition; launches {launches} {tag}")
        if field is GOLDILOCKS:
            keep = (spec, tables, got)
            if dev.type == "cuda":
                traced = ranged_trace(lambda: fs_kernel.fs_prove_device_sharded(spec, tables, mesh, n_shard=SHARD_VARS),
                                      [(ShardedBlockPoly, "_round", lambda self, *a: ("FS", 1))])
                check_ranged(f"sharded fused FS prover {field.name}, n = {n}", traced, ["FS"], tag)
        else:
            del tables
    sync()

    # ---- phase 3: the triangle IP sharded over Z (n_shard 3): the
    # per-round loop over ShardedBlockPoly and generate_transcript_device(
    # mesh=) byte-identical to the unsharded generate_transcript_device;
    # 4096 nodes over Goldilocks (timed in turns), 1024 over BabyBear
    tri_rows = {}
    for field, nodes in ((GOLDILOCKS, tri_nodes), (BABYBEAR, tri_nodes_small)):
        k = (nodes - 1).bit_length()
        adj = triangle_graph(nodes, seed)
        g = TriangleG.new_adj_matrix(2 * k, adj, field, device=dev)
        ref = generate_transcript_device(g, field)

        def per_round():
            poly = ShardedBlockPoly.from_internal_tables(g.spec, g.tables, mesh, n_shard=SHARD_VARS)
            return generate_transcript(SumcheckInteractiveProver(Prover(poly)), field)

        t_round = per_round()
        sync()
        reset_counts()
        multiblock.rows_launches[field.backend] = multiblock.fold_rows_launches[field.backend] = 0
        _collectives(reset=True)
        # MB's and the fold's launches per sharded round (ShardedBlockPoly.
        # _block_rows: each round's and c_1's sums): one of each form per
        # device, whatever its shard rows
        per_round_mb = []
        block_rows = ShardedBlockPoly._block_rows

        def counted_block_rows(self, *a, **kw):
            before = multiblock.launches[field.backend], multiblock.fold_launches[field.backend]
            got = block_rows(self, *a, **kw)
            per_round_mb.append((multiblock.launches[field.backend] - before[0],
                                 multiblock.fold_launches[field.backend] - before[1]))
            return got

        ShardedBlockPoly._block_rows = counted_block_rows
        try:
            t_dev = generate_transcript_device(g, field, mesh=mesh, n_shard=SHARD_VARS)
        finally:
            ShardedBlockPoly._block_rows = block_rows
        sync()
        launches = {"tc_total": modmatmul.total_launches[field.backend],
                    "digits_batched": modmatmul.digit_launches[field.backend],
                    "multiblock_round": multiblock.launches[field.backend],
                    "multiblock_fold": multiblock.fold_launches[field.backend],
                    "multiblock_round_rows": multiblock.rows_launches[field.backend],
                    "multiblock_fold_rows": multiblock.fold_rows_launches[field.backend],
                    "fs_tail": fs_kernel.launches[field.backend],
                    "tc_batched": modmatmul.tc_launches[field.backend],
                    "shard_layout": shard_layout.launches[field.backend]}
        coll = _collectives()
        if t_round.to_bytes() != ref.to_bytes() or t_dev.to_bytes() != ref.to_bytes():
            raise AssertionError(f"sharded triangle ({nodes} nodes, {field.name}) != the unsharded device transcript")
        if not launches["tc_total"] or not launches["multiblock_round"] or launches["tc_batched"]:
            raise AssertionError(f"sharded triangle ({nodes} nodes): launches {launches}")
        mb_rounds = sum(1 for m_, _ in per_round_mb if m_)
        if (max(m_ for m_, _ in per_round_mb) > 1 or max(f_ for _, f_ in per_round_mb) > 2
                or dev.type == "cuda" and (launches["shard_layout"] != 2
                                           or launches["multiblock_round_rows"] != mb_rounds)):
            raise AssertionError(f"sharded triangle ({nodes} nodes): MB and fold launches per sharded round "
                                 f"{per_round_mb} (at most one MB launch, in the rows form, and two folds per round "
                                 f"on one card), rows-form launches {launches['multiblock_round_rows']}, layout "
                                 f"launches {launches['shard_layout']} (one per sharded table)")
        log(f"sharded triangle IP {nodes} nodes {field.name}: MB's rows form in {mb_rounds} of "
            f"{len(per_round_mb)} sharded rounds (c_1 included), one launch each on the card ({launches['multiblock_round']} "
            f"MB launches in the proof, the replicated rounds' included); fold launches per round "
            f"{sorted({f_ for _, f_ in per_round_mb})}, {launches['multiblock_fold_rows']} of them in the rows "
            f"form {tag}")
        if dev.type == "cuda":
            def phase_of(self, r, *_):
                post = self.spec.after_fold() if r is not None else self.spec
                return "XYZ"[3 - len(post.block_sizes)], 1

            traced = ranged_trace(lambda: generate_transcript_device(g, field, mesh=mesh, n_shard=SHARD_VARS),
                                  [(ShardedBlockPoly, "_round", phase_of)])
            check_ranged(f"sharded triangle IP {nodes} nodes {field.name} (generate_transcript_device(mesh=))",
                         traced, "XYZ", tag)
        tri_rows[field.backend] = launches
        line = (f"sharded triangle IP {nodes} nodes {field.name} ({3 * k} variables, Z sharded over {S} shards, "
                f"n_shard {SHARD_VARS}): the per-round loop over ShardedBlockPoly and generate_transcript_device("
                f"mesh=) byte-identical to the unsharded generate_transcript_device; launches of the device proof "
                f"{launches}; collectives {coll}")
        if nodes == tri_nodes:
            times = in_turns({"unsharded device": lambda: generate_transcript_device(g, field),
                              "sharded per-round": per_round,
                              "sharded device": lambda: generate_transcript_device(g, field, mesh=mesh,
                                                                                   n_shard=SHARD_VARS)}, reps, sync)
            line += "; median of {} in turns: {}".format(reps, ", ".join(
                f"{name} {v[0]:.1f} ms ({[round(x, 1) for x in v[1]]})" for name, v in times.items()))
        log(line + f" {tag}")
        del g
    sync()

    # ---- phase 5: a one-rank process group (NCCL on the card, gloo on the
    # CPU) behind make_mesh_2d(dcn_size=1): the DCN all-reduce of every
    # sharded round runs through torch.distributed; the bytes of phase 3
    import torch.distributed as dist

    spec, tables, want = keep
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(f"file://{os.path.join(tmp, 'store')}", 1, 0)
        try:
            mesh2 = make_mesh_2d([dev] * S, dcn_size=1)
            if mesh2.group is None:
                raise AssertionError("make_mesh_2d(dcn_size=1) in a process group made no DCN group")
            _collectives(reset=True)
            reset_counts()
            t0 = time.perf_counter()
            got = fs_kernel.fs_prove_device_sharded(spec, tables, mesh2, n_shard=SHARD_VARS)
            sync()
            dcn_ms = (time.perf_counter() - t0) * 1e3
            coll = _collectives()
            dcn_row_sums = row_sums.launches["goldilocks"]
            if got is None or [m.hex() for m in got] != [m.hex() for m in want]:
                raise AssertionError("the sharded FS proof over a one-rank process group != phase 3's bytes")
            if coll["reduce"] != n - SHARD_VARS or coll["reduce_words"] != 3 * coll["reduce"]:
                raise AssertionError(f"one-rank process group: collectives {coll} (one all_reduce of 3 words per "
                                     "sharded round)")
            if dev.type == "cuda" and dcn_row_sums != 2 * coll["reduce"]:
                raise AssertionError(f"one-rank process group: {dcn_row_sums} row-sum launches, not two per "
                                     "reduction (the lanes out, the lanes back)")
            log(f"one-rank {dist.get_backend()} process group (a FileStore) behind make_mesh_2d(dcn_size=1), mesh "
                f"{mesh2}: the sharded FS proof over Goldilocks (n = {n}) byte-identical to phase 3's; "
                f"{coll['reduce']} all_reduce calls through torch.distributed (one per sharded round, 32-bit lanes "
                f"split and recombined by {dcn_row_sums} row-sum launches); {dcn_ms:.1f} ms (first run) {tag}")
        finally:
            dist.destroy_process_group()
    del keep, tables

    # the kernels line's rows
    src = "thaler_study_tpu_torch/csrc/"
    forms = {
        "modmatmul_tc_total": (src + "modmatmul_tc.cu", "thaler_study_tpu/ops/modmatmul.py:267",
                               {b: tri_rows[b]["tc_total"] for b in tri_rows}),
        "modmatmul_digits_batched": (src + "modmatmul_tc.cu", "thaler_study_tpu/ops/modmatmul.py:106",
                                     {b: tri_rows[b]["digits_batched"] for b in tri_rows}),
        "round_kernel_sharded": (src + "round_kernel.cu", "thaler_study_tpu/parallel/sharded.py:101",
                                 {b: fs_rows[b]["round_kernel"] for b in fs_rows}),
        "fs_tail_sharded": (src + "fs_tail.cu", "thaler_study_tpu/ops/fs_kernel.py:418",
                            {b: fs_rows[b]["fs_tail"] for b in fs_rows}),
        "libra_round_total": (src + "round_kernel.cu", "thaler_study_tpu/parallel/sharded.py:101",
                              {b: gkr_info[b][0] for b in gkr_info}),
        "multiblock_round_sharded": (src + "multiblock_round.cu", "thaler_study_tpu/parallel/sharded.py:493",
                                     {b: tri_rows[b]["multiblock_round_rows"] for b in tri_rows}),
        "multiblock_fold_rows": (src + "multiblock_round.cu", "thaler_study_tpu/parallel/sharded.py:417",
                                 {b: tri_rows[b]["multiblock_fold_rows"] for b in tri_rows}),
        "shard_layout": (src + "shard_layout.cu", "thaler_study_tpu/parallel/sharded.py:79",
                         {b: fs_rows[b]["shard_layout"] for b in fs_rows}),
    }
    rows = []
    for name, (source, replaces, launches) in forms.items():
        for backend in ("goldilocks", "mont32"):
            ms, plain, bound_ms, by, *floor = timing[(name, backend)]
            lib_ms, lib_call = library.get((name, backend), (None, None))
            row = {"name": f"{name}_{backend}", "route": "cuda", "source": source, "replaces": replaces,
                   "launches": launches.get(backend, 0), "max_abs_err": err[(name, backend)], "ms": ms,
                   "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms}
            if lib_call:
                row["library_call"] = lib_call
            else:
                row["library_ms_reason"] = "no PyTorch call computes this function mod p"
            if floor:
                row["latency_floor_ms"] = floor[0]
            row.update(extra.get((name, backend), {}))
            if not row["launches"]:
                raise AssertionError(f"{name} ({backend}) was not launched on its sharded path")
            rows.append(row)
    # the reduction's row sums: launched on the path across processes (the
    # one-rank group above: the lanes out and back, Goldilocks)
    ms, plain, bound_ms, by, floor = timing[("row_sums", "goldilocks")]
    rows.append({"name": "row_sums_goldilocks", "route": "cuda", "source": src + "row_sums.cu",
                 "replaces": "thaler_study_tpu/parallel/sharded.py:101", "launches": dcn_row_sums,
                 "max_abs_err": err[("row_sums", "goldilocks")], "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                 "bound_by": by, "latency_floor_ms": floor, "library_ms": None,
                 "library_ms_reason": "no PyTorch call computes this function mod p"})
    if not rows[-1]["launches"]:
        raise AssertionError("row_sums (goldilocks) was not launched on its sharded path")
    return rows


# ---- slice 14: the sharded fused GKR prover (generate_gkr_transcript_fused
# with mesh=) on the flagship, 8 shards of the card, n_shard 3; K2 over
# shard rows and the round tail over a sharded round's reduced rows


def sharded_fused_counts(circuit, n_shard: int, line_launches) -> dict:
    """The launches and cross-device moves of one sharded fused proof on one
    card (``line_launches(k)``: the line restriction's launches at k): the
    prover's forward pass (one launch per layer); per
    sharded layer (k >= n_shard, L = k - n_shard) 2 K2 launches over shard
    rows, 2L round tails over rows and 2L launches of K1's TOTAL form (one
    per sharded round: the card's rows are one group), 2 n_shard - 1
    launches of K1 with the tail (the replicated rounds but the final one),
    2 n_shard of K1 per proof in all, 2L reductions, 6 gathers of 2 x
    2^n_shard words (2^n_shard when L = 0), 2 + 2 max(L - 1, 0) sends; a
    replicated layer runs the unsharded fused layer's launches (with its
    bit reversal of W)."""
    want = {"phase_tables_rows": 0, "gkr_round_tail": 0, "libra_round_tail": 0, "libra_round": 0,
            "libra_round_total": 0, "phase_tables": 0, "eq_table": 0, "eq_table_dot": 0, "line_restrict": 0,
            "gkr_final_tail": 0, "forward": len(circuit.layers), "mle_bitrev": 0}
    coll = {"reduce": 0, "reduce_words": 0, "gather": 0, "gather_words": 0}
    sends = {"send": 0, "send_words": 0}
    for i in range(len(circuit.layers)):
        k = circuit.num_vars_at(i + 1)
        want["libra_round"] += 2 * min(k, n_shard)
        want["eq_table"] += 1
        want["eq_table_dot"] += 1
        want["line_restrict"] += line_launches(k)
        want["gkr_final_tail"] += 1
        if k >= n_shard:
            local = k - n_shard
            want["phase_tables_rows"] += 2
            want["gkr_round_tail"] += 2 * local
            want["libra_round_total"] += 2 * local
            want["libra_round_tail"] += 2 * (k - local) - 1
            coll["reduce"] += 2 * local
            coll["gather"] += 6
            coll["gather_words"] += 6 * (2 if local else 1) << n_shard
            sends["send"] += 2 + 2 * max(local - 1, 0)
        else:
            want["phase_tables"] += 2
            want["libra_round_tail"] += 2 * k - 1
            want["mle_bitrev"] += 1
    return {"launches": want, "collectives": coll, "sends": sends}


def sharded_fused_slice(circuit, inputs, want_bytes, dev, sync, graph_ms, time_ms, reset_counts, read_counts,
                        compress_ms, tag, reps=5) -> list:
    """Slice 14 on the flagship (phases 2-4; its rows of the ``kernels``
    line returned): ``gkr.generate_gkr_transcript_fused(mesh=)`` on 8
    shards of ``dev`` byte-identical to ``want_bytes`` (the unsharded
    proof), accepted, rejected when tampered, its launches and
    cross-device moves against :func:`sharded_fused_counts`; the median of
    ``reps`` proofs in turns with the unsharded fused proof; a traced proof
    (no device-to-host read after the first eq table but the proof's one
    read); K2 over the flagship's 8 shard rows (layer 0's wiring) and the
    round tail over 8 reduced rows against their plain versions, timed from
    CUDA graphs beside their bounds. ``time_ms(fn, reps)``: ms per call."""
    import numpy as np
    import torch

    from thaler_study_tpu_torch import gkr
    from thaler_study_tpu_torch.fiat_shamir import SerializationError
    from thaler_study_tpu_torch.fields import BABYBEAR, FArray
    from thaler_study_tpu_torch.fields import GOLDILOCKS as F
    from thaler_study_tpu_torch.gkr import device_tables
    from thaler_study_tpu_torch.gkr import fused as gkr_fused
    from thaler_study_tpu_torch.sumcheck import SumCheckError
    from thaler_study_tpu_torch.ops import gkr_tail
    from thaler_study_tpu_torch.parallel import sharded

    mesh = _shard_mesh(dev)
    depth = len(circuit.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)

    def reset_moves():
        _collectives(reset=True)
        for key in sharded.sends:
            sharded.sends[key] = 0

    def fused_proof(m=None):
        return gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, F), F, mesh=m)

    def line_launches(k):
        return len(device_tables.line_launches_of(device_tables.line_plan(k, 8)))

    # ---- phase 3: the path ----
    sync()
    reset_counts()
    reset_moves()
    f0 = gkr_fused.fallbacks
    t0 = time.perf_counter()
    t = fused_proof(mesh)
    sync()
    first_s = time.perf_counter() - t0
    by_backend = read_counts()
    counts = {name: sum(v.values()) for name, v in by_backend.items()}
    moves = {"collectives": _collectives(), "sends": dict(sharded.sends)}
    want = sharded_fused_counts(circuit, SHARD_VARS, line_launches)
    got = {name: counts.get(name, 0) for name in want["launches"]}
    if gkr_fused.fallbacks != f0 or t.to_bytes() != want_bytes:
        raise AssertionError(f"sharded fused GKR: fallbacks {gkr_fused.fallbacks - f0}; bytes equal "
                             f"{t.to_bytes() == want_bytes}")
    if got != want["launches"] or sum(counts.values()) != sum(got.values()) or moves != {
            "collectives": want["collectives"], "sends": want["sends"]}:
        raise AssertionError(f"sharded fused GKR: launches {counts}, moves {moves}; predicted {want}")
    t0 = time.perf_counter()
    if not gkr.verify_gkr_transcript(t, gkr.Verifier(circuit, F), inputs, F):
        raise AssertionError("sharded fused GKR: the verifier rejected the transcript")
    verify_s = time.perf_counter() - t0
    bad = list(t.g)
    flip = len(bad) // 2
    bad[flip] = bad[flip][:-1] + bytes([bad[flip][-1] ^ 1])
    try:
        accepted = gkr.verify_gkr_transcript(gkr.GKRTranscript(bad), gkr.Verifier(circuit, F), inputs, F)
    except (gkr.GKRError, SumCheckError, SerializationError, ValueError):  # a rejection can raise
        accepted = False
    if accepted:
        raise AssertionError("sharded fused GKR: a tampered transcript was accepted")
    log(f"sharded fused GKR flagship ({depth} x 2^{circuit.num_vars_at(1)}, mesh of {SHARD_COUNT} shards on {dev}, "
        f"n_shard {SHARD_VARS}): generate_gkr_transcript_fused(mesh=) byte-identical to the unsharded proof "
        f"({len(t.g)} messages), no fallback; verify_gkr_transcript accepted in {verify_s:.3f} s, rejected with one "
        f"byte flipped in message {flip}; launches per proof {got} (as predicted); collectives "
        f"{moves['collectives']}, sends {moves['sends']} (as predicted: one reduction per sharded round); first "
        f"run {first_s:.3f} s {tag}")

    # ---- phase 4: the proof in turns with the unsharded fused proof ----
    times = in_turns({"unsharded": fused_proof, "sharded": lambda: fused_proof(mesh)}, max(3, reps), sync)
    log(f"sharded fused GKR flagship: median of {max(3, reps)} in turns {times['sharded'][0] / 1e3:.4f} s (runs "
        f"{[round(x / 1e3, 4) for x in times['sharded'][1]]}) beside the unsharded fused "
        f"{times['unsharded'][0] / 1e3:.4f} s ({[round(x / 1e3, 4) for x in times['unsharded'][1]]}); host clock "
        f"around Prover (the forward pass) and the proof, ending in its host read {tag}")
    timings = []
    gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, F), F, timings=timings, mesh=mesh)
    parts = {name: sum(sec for n_, _, sec in timings if n_ == name)
             for name in ("prelude", "phase1", "phase2", "pull", "assemble")}
    log("sharded fused GKR flagship breakdown (a sync after every step, s): "
        + ", ".join(f"{name} {sec:.4f}" for name, sec in parts.items()) + f" {tag}")

    # a traced proof: device records by kernel, idle share, the copies
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        prover = gkr.Prover(circuit, inputs, F)
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gkr.generate_gkr_transcript_fused(prover, F, mesh=mesh)
            traced_ms = (time.perf_counter() - t0) * 1e3
        spans, busy_us = device_spans(prof)
        by_kernel = {}
        for s0, s1, name in spans:
            label = next((k_ for k_ in FUSED_KERNELS + ("gkr_round_tail_kernel", "libra_total_kernel") if k_ in name),
                         "other")
            if label == "libra_round_kernel" and template_flag(name, label):
                label += " TAIL"
            ms_, n_ = by_kernel.get(label, (0.0, 0))
            by_kernel[label] = (ms_ + (s1 - s0) / 1e3, n_ + 1)
        layer_start = min((s0 for s0, _, name in spans if "eq_table_kernel" in name), default=None)
        reads = [name for s0, _, name in spans if "Memcpy DtoH" in name and layer_start is not None and s0 > layer_start]
        if not spans or layer_start is None:
            reads_note = "device-to-host copies: not measured (no device records)"
        elif len(reads) != 1:
            raise AssertionError(f"sharded fused GKR: {len(reads)} device-to-host reads after the first eq table")
        else:
            reads_note = "one device-to-host read after the first eq table (the proof's pull), none inside the layers"
        idle = f"{1 - busy_us / 1e3 / traced_ms:.1%}" if spans else "not measured"
        log(f"sharded fused GKR flagship, traced proof: {traced_ms:.3f} ms wall (profiler on), device busy "
            f"{busy_us / 1e3:.3f} ms, idle share {idle}; {reads_note}; "
            f"{split_line(by_kernel, aten_split(prof))} {tag}")
        # the sharded rounds alone, each phase's synced: no plain-torch kernel
        traced = ranged_trace(lambda: fused_proof(mesh),
                              [(gkr_fused._ShardedLayer, "_sharded_rounds", lambda self, *a: ("GKR", self.local))])
        check_ranged("sharded fused GKR flagship", traced, ["GKR"], tag)
    else:
        log("sharded fused GKR flagship trace: not measured (no card)")

    # ---- phase 2 / 4: the two kernels at the flagship's shapes ----
    rows_out = []
    k = circuit.num_vars_at(1)
    g = len(circuit.layers[0])
    wiring = circuit.device_wiring(0, dev)
    N, S = 1 << k, SHARD_COUNT

    def words(n):
        lo = torch.randint(0, 1 << 32, (n,), generator=gen, device=dev, dtype=torch.int64)
        hi = torch.randint(0, (1 << 32) - 1, (n,), generator=gen, device=dev, dtype=torch.int64)
        return (hi << 32) | lo

    # K2 over the card's 8 shard rows (the rows form: the plan of the
    # group, in the layout's order) and over partial groups (row0 > 0), per
    # field (the rows form runs on the path over Goldilocks: the fused
    # prover's field; its mont32 instantiation is the unsharded K2's,
    # checked and timed here over BabyBear words on the same wiring)
    for field in (F, BABYBEAR):
        wb = 8 if field is F else 4
        if field is F:
            eq_r, table = FArray(words(g), F), FArray(words(N), F)
        else:
            eq_r, table = (FArray(torch.randint(0, field.p, (n,), generator=gen, device=dev, dtype=torch.int64)
                                  .to(torch.int32), field) for n in (g, N))
        err = 0
        for phase, key_t, gidx in ((1, wiring.b, wiring.c), (2, wiring.c, wiring.b)):
            for row0, rows in ((0, S), (3, 1), (6, 2), (1, 5)):
                got_t = device_tables.phase_tables_rows(phase, wiring, eq_r, table, k, SHARD_VARS, row0, rows)
                want_t = device_tables.phase_tables_rows_plain(phase, key_t, gidx, wiring.is_mul, eq_r, table, k,
                                                               SHARD_VARS, row0, rows)
                e = max(word_err(a.data, b.data) for a, b in zip(got_t, want_t))
                if e:
                    raise AssertionError(f"K2 over shard rows != plain: {field.name} phase {phase}, rows "
                                         f"{row0}..{row0 + rows - 1}")
                err = max(err, e)
        # in turns: all rows in one launch, the unsharded K2 at the same
        # shape, twice each
        k2_ms, k2_whole = [], []
        for _ in range(2):
            k2_ms.append(graph_ms(lambda: device_tables.phase_tables_rows(1, wiring, eq_r, table, k, SHARD_VARS, 0,
                                                                          S)))
            k2_whole.append(graph_ms(lambda: device_tables.phase_tables(1, wiring, eq_r, table, k)))
        k2_plain = time_ms(lambda: device_tables.phase_tables_rows_plain(1, wiring.b, wiring.c, wiring.is_mul, eq_r,
                                                                         table, k, SHARD_VARS, 0, S), 3)
        plan = wiring.plan(1, SHARD_VARS, 0, S)
        plan_mb = sum(t.numel() * t.element_size() for t in (plan.order, plan.starts, plan.packed)) / 1e6
        # the plan (order, packed) and eq_r per gate, starts and the
        # gathered table per cell read once; two tables written
        k2_bytes = g * (4 + 4 + wb) + (N + 1) * 4 + N * wb + 2 * N * wb
        k2_bound = k2_bytes / PEAK_BYTES_PER_S * 1e3
        fmt = lambda xs: " / ".join(f"{x:.4f}" for x in xs)  # noqa: E731
        log(f"{field.name} K2 over shard rows == plain (exact) on the flagship's layer 0 wiring ({g} gates, 2^{k} "
            f"cells, n_shard {SHARD_VARS}), both phases, rows 0-7, 3, 6-7 and 1-5; all {S} rows in one launch "
            f"{fmt(k2_ms)} ms from CUDA graphs, in turns with the unsharded K2 at the same shape {fmt(k2_whole)} ms; "
            f"bytes bound {k2_bound:.4f} ms ({k2_bytes / 1e6:.1f} MB at 3.35 TB/s): {k2_bound / min(k2_ms):.1%}; "
            f"the group's plan {plan_mb:.2f} MB per phase; plain {k2_plain:.3f} ms {tag}")
        row = {"name": f"phase_tables_rows_{field.backend}", "route": "cuda",
               "source": "thaler_study_tpu_torch/csrc/phase_tables.cu",
               "replaces": "thaler_study_tpu/gkr/device_tables.py:192",
               "launches": by_backend["phase_tables_rows"][field.backend], "max_abs_err": err, "ms": min(k2_ms),
               "plain_ms": k2_plain, "bound_ms": k2_bound, "bound_by": "bytes", "library_ms": None,
               "unsharded_ms": min(k2_whole), "plan_mb": plan_mb}
        rows_out.append(row)
        del eq_r, table

    # the round tail over the reduced rows: one on a one-card mesh (K1's
    # TOTAL form sums the card's shard rows), 8 in the checks' odd fills
    # (one per device of an 8-card mesh), every fill x (StartSumCheck, one
    # draw, two draws)
    trng = np.random.default_rng(14)
    err = 0

    def tail_state(prefix, claim, k_):
        chain = gkr_tail.prefix_chain(prefix, dev)
        return gkr_tail.LayerTail(chain, torch.zeros(128, dtype=torch.uint8, device=dev),
                                  torch.zeros(1, dtype=torch.int32, device=dev), claim.clone(),
                                  torch.zeros(2 * k_, dtype=torch.int64, device=dev),
                                  torch.zeros(1, dtype=torch.int32, device=dev))

    for fill in range(64):
        for kind in ("start", "one", "two"):
            k_ = 2 + fill % 19
            prefix = trng.integers(0, 256, 64 * (2 + fill % 5) + fill, dtype=np.uint8).tobytes()
            claim = words(1)
            nred = S if fill % 2 else 1
            red = words(3 * nred).reshape(1, nred, 3)
            if fill == 3 and kind == "one":
                red.zero_()
                claim.zero_()
            draws = 2 if kind == "two" else 1
            idx = 2 * k_ - 3 if draws == 2 else fill % k_
            start = (fill, k_) if kind == "start" else None
            a, b = tail_state(prefix, claim, k_), tail_state(prefix, claim, k_)
            gkr_tail.round_tail(red, gkr_tail.RoundTail(a, 7, idx, draws, start))
            gkr_tail.round_tail_plain(red, b.chain, b.msgs, 7, b.zero, b.claim, b.chal, idx, draws, start)
            sync()
            pairs = [(a.chain.state, b.chain.state), (a.chain.buf, b.chain.buf), (a.msgs, b.msgs), (a.zero, b.zero),
                     (a.claim, b.claim), (a.chal, b.chal)]
            e = max(word_err(x.to(torch.int64), y.to(torch.int64)) for x, y in pairs)
            if e or (fill == 3 and kind == "one" and int(a.zero[0]) != 1):
                raise AssertionError(f"round tail over rows != plain: fill {fill}, {kind}")
            err = max(err, e)
    nbytes = 64 * 131072 + 40
    red = words(3).reshape(1, 1, 3)
    lt = tail_state(bytes(64 * 131072 + 40), words(1), k)

    def tail_launch(fn):
        lt.chain.nbytes = nbytes
        if fn is gkr_tail.round_tail:
            fn(red, gkr_tail.RoundTail(lt, 7, 5, 1))
        else:
            fn(red, lt.chain, lt.msgs, 7, lt.zero, lt.claim, lt.chal, 5, 1)

    tail_ms = graph_ms(lambda: tail_launch(gkr_tail.round_tail))
    tail_plain = time_ms(lambda: tail_launch(gkr_tail.round_tail_plain), 3)
    m_ = gkr_tail.ROUND_LEN
    floor = compressions(nbytes, m_, True) * compress_ms
    # the rows, the chain's state and block and the zero flag read and
    # written, the message written, the claim read and written, r written
    t_bytes = 3 * 8 + 2 * (32 + 64 + 4) + m_ + 3 * 8
    log(f"round tail over 1 and {S} reduced rows == plain (exact) in 192 cases (every fill x StartSumCheck / one / "
        f"two draws; one flagged zero): one row {tail_ms * 1e3:.2f} us per launch from a CUDA graph at fill 40, "
        f"latency floor "
        f"{floor * 1e3:.2f} us ({compressions(nbytes, m_, True)} compressions), bytes bound "
        f"{t_bytes / PEAK_BYTES_PER_S * 1e3:.7f} ms; plain (Python ints) {tail_plain:.3f} ms {tag}")
    rows_out.append({"name": "gkr_round_tail_goldilocks", "route": "cuda",
                     "source": "thaler_study_tpu_torch/csrc/gkr_tail.cu",
                     "replaces": "thaler_study_tpu/gkr/fused.py:161", "launches": got["gkr_round_tail"],
                     "max_abs_err": err, "ms": tail_ms, "plain_ms": tail_plain,
                     "bound_ms": t_bytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
                     "latency_floor_ms": floor})
    # every row launched on the path, but the mont32 rows form: the fused
    # GKR prover takes Goldilocks only, as the JAX package's, so its
    # measured count on the path is 0
    for row in rows_out:
        if not row["launches"] and row["name"] != "phase_tables_rows_mont32":
            raise AssertionError(f"{row['name']} was not launched on the sharded fused path")
    return rows_out


# ---- slice 20: B6's device programs (csrc/mle.cu, csrc/forward.cu): the
# bit reversal, the fold chain, the evaluation at many points, the GKR
# forward pass


def mle_slice(seed, tag, dev, sync, graph_ms, path_launches, reps=3, wide_log=26, gkr_log=20,
              pcs_points=151321) -> list:
    """Slice 20 (phases 2 and 4; its rows of the ``kernels`` line returned):
    each kernel against its plain version on the card, exactly, at the
    paths' shapes and at edge words (p - 1; Goldilocks words >= 2^63), over
    Goldilocks and the mont32 fields: the bit reversal at 2^0..2^26; the
    fold chain at n = 26 for every k = 1..13 and k = 26 (the matmul entry,
    ``DenseMLE.evaluate``) and at n = 20; the evaluation at P = 1, 5, 13 and
    21 points over 2^20 (GKR's restriction) and the PCS's 151,321 points
    over 2 variables; the forward pass at 2^20 gates and at mixed widths.
    Then each timed from CUDA graphs (``graph_ms(fn, count)``) beside its
    bound, its plain version and, for the bit reversal, ``index_select``
    with a prebuilt index (its library column). ``path_launches[(name,
    backend)]``: the launches counted on the main paths. The sizes default
    to the paths' (a CPU rehearsal passes smaller ones): ``wide_log`` the
    matmul entry's 2L variables (its fold fixes half), ``gkr_log`` the
    flagship's width, ``pcs_points`` the PCS commit's points."""
    import dataclasses

    import torch

    from thaler_study_tpu_torch.fields import BABYBEAR, F5, F389, F1572869, GOLDILOCKS, FArray
    from thaler_study_tpu_torch.ops import forward_kernel as fk
    from thaler_study_tpu_torch.ops import mle_kernel as mk

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 20)
    err = {}

    def words(field, size, fill="random"):
        return FArray(slice_words(gen, field, (size,), dev, fill), field)

    def check(key, got, want, what):
        sync()
        e = word_err(got.data, want.data)
        if e:
            raise AssertionError(f"{key[0]} kernel != plain ({key[1]}): {what}")
        err[key] = max(err.get(key, 0), e)

    def plain_ms(fn, count=reps):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        sync()
        return (time.perf_counter() - t0) / count * 1e3

    # ---- phase 2: each kernel against its plain version ----
    fields = (GOLDILOCKS, BABYBEAR, F389, F5, F1572869)
    for field in fields:
        wide = field in (GOLDILOCKS, F5)  # the matmul entry's fields, n = 26
        be = field.backend
        for n in (0, 1, 5, 9, 10, 11, gkr_log) + ((wide_log - 2, wide_log) if wide else ()):
            for fill in ("random", "max"):
                t = words(field, 1 << n, fill)
                check(("mle_bitrev", be), mk.bitrev(t, n), mk.bitrev_plain(t, n), f"{field.name} n = {n} {fill}")
        for n, ks in ((3, (1, 2, 3)), (10, (1, 2, 5, 10)), (gkr_log, (1, gkr_log // 3, 2 * gkr_log // 3, gkr_log))) + (
                ((wide_log, tuple(range(1, wide_log // 2 + 1)) + (wide_log,)),) if wide else ()):
            t = words(field, 1 << n)
            for k in ks:
                r = words(field, k)
                check(("mle_fold", be), mk.fold(t, r, k), mk.fold_plain(t, r, k), f"{field.name} n = {n}, k = {k}")
            tmax, rmax = words(field, 1 << n, "max"), words(field, ks[-1], "max")
            check(("mle_fold", be), mk.fold(tmax, rmax, ks[-1]), mk.fold_plain(tmax, rmax, ks[-1]),
                  f"{field.name} n = {n}, k = {ks[-1]}, every word p - 1")
            del t, tmax
        for n, ps in ((1, (1, 3)), (2, (1, 5) + ((pcs_points,) if field is F389 else ())), (7, (1, 4, 5)),
                      (12, (1, 13, 21)), (gkr_log, (1, 5, 13, gkr_log + 1))):
            for fill in ("random", "max"):
                t = words(field, 1 << n, fill)
                for P in ps:
                    rs = FArray(words(field, P * n, fill).data.reshape(P, n), field)
                    check(("mle_eval_many", be), mk.eval_many(t, rs), mk.eval_many_plain(t, rs),
                          f"{field.name} n = {n}, P = {P}, {fill}")
        for g, nxt in ((1, 1), (7, 4), (1 << 12, 1 << 10), (1 << 10, 1 << 12), (1 << gkr_log, 1 << gkr_log)):
            for fill in ("random", "max"):
                cur = words(field, nxt, fill)
                b = torch.randint(0, nxt, (g,), generator=gen, device=dev, dtype=torch.int32)
                c = torch.randint(0, nxt, (g,), generator=gen, device=dev, dtype=torch.int32)
                m = torch.rand((g,), generator=gen, device=dev) < 0.5
                check(("forward", be), fk.forward_layer(cur, b, c, m), fk.forward_layer_plain(cur, b, c, m),
                      f"{field.name} {g} gates over {nxt} values, {fill}")
        torch.cuda.empty_cache()
        log(f"slice 20 over {field.name}: the bit reversal (2^0..2^{wide_log if wide else gkr_log}), the fold (n = 3, "
            f"10, {gkr_log}{f', {wide_log} at every k = 1..{wide_log // 2} and {wide_log}' if wide else ''}), the "
            f"evaluation at P points (n = 1..{gkr_log}, P = 1, 3, 4, 5, 13, 21, {gkr_log + 1}"
            f"{f', {pcs_points} at n = 2' if field is F389 else ''}) and the forward pass (1 to 2^{gkr_log} gates) == "
            f"their plain versions (exact), random words and every word p - 1")

    # ---- phase 4: times from CUDA graphs, at the paths' shapes ----
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = max_sm_clock_mhz()
    rows = []
    src = "thaler_study_tpu_torch/csrc/"
    for field in (GOLDILOCKS, BABYBEAR):
        be, wb = field.backend, (8 if field.backend == "goldilocks" else 4)
        imad = MM_SASS_PER_PRODUCT[be][1]
        wide = GOLDILOCKS if be == "goldilocks" else F5  # the matmul entry's field of this family
        timing = {}
        # the bit reversal: the matmul entry's 2^wide_log words (library:
        # index_select, its index prebuilt)
        t = words(wide, 1 << wide_log)
        idx = mk.bitrev_index(wide_log, dev)
        ms = graph_ms(lambda: mk.bitrev(t, wide_log), 5)
        lib = graph_ms(lambda: torch.index_select(t.data, 0, idx), 5)
        plain = plain_ms(lambda: mk.bitrev_plain(t, wide_log))
        bound = 2 * (1 << wide_log) * wb / PEAK_BYTES_PER_S * 1e3
        t20 = words(field, 1 << gkr_log)
        idx20 = mk.bitrev_index(gkr_log, dev)
        ms20 = graph_ms(lambda: mk.bitrev(t20, gkr_log))
        lib20 = graph_ms(lambda: torch.index_select(t20.data, 0, idx20))
        timing["mle_bitrev"] = (ms, plain, bound, "bytes", lib, {"ms_gkr_layer": ms20, "library_ms_gkr_layer": lib20,
                                                                 "shape": f"2^{wide_log} {wide.name} words"})
        log(f"{wide.name} bit reversal of 2^{wide_log} words: {ms:.4f} ms from a CUDA graph, bytes bound {bound:.4f} "
            f"ms ({bound / ms:.1%}); index_select with a prebuilt index {lib:.4f} ms; plain {plain:.2f} ms; at "
            f"2^{gkr_log} ({field.name}, a GKR layer) {ms20 * 1e3:.2f} us (index_select {lib20 * 1e3:.2f} us) {tag}")
        del idx
        # the fold chain: the matmul entry's first half of its variables
        kf = wide_log // 2
        r = words(wide, kf)
        ms = graph_ms(lambda: mk.fold(t, r, kf), 5)
        plain = plain_ms(lambda: mk.fold_plain(t, r, kf))
        bytes_ms = ((1 << wide_log) + (1 << (wide_log - kf))) * wb / PEAK_BYTES_PER_S * 1e3
        ops_ms = (1 << wide_log) * imad / (64 * sms * clock_mhz * 1e6) * 1e3
        pl = mk.plan(wide_log, kf, 1, 1)
        timing["mle_fold"] = (ms, plain, max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
                              None, {"shape": f"2^{wide_log} {wide.name} words, k = {kf}", "plan": dataclasses.asdict(pl)})
        log(f"{wide.name} fold chain of {kf} of {wide_log} variables (the matmul entry's fix_variables; plan {pl}): "
            f"{ms:.4f} ms from a CUDA graph, bytes bound {bytes_ms:.4f} ms ({bytes_ms / ms:.1%}; products "
            f"{ops_ms:.4f} ms); plain {plain:.2f} ms {tag}")
        del t, r
        torch.cuda.empty_cache()
        # the evaluation: GKR's restriction, gkr_log + 1 points over 2^gkr_log words
        P, gw = gkr_log + 1, 1 << gkr_log
        rs = FArray(words(field, P * gkr_log).data.reshape(P, gkr_log), field)
        ms = graph_ms(lambda: mk.eval_many(t20, rs))
        plain = plain_ms(lambda: mk.eval_many_plain(t20, rs))
        bytes_ms = (gw + P * (gkr_log + 1)) * wb / PEAK_BYTES_PER_S * 1e3
        ops_ms = P * gw * imad / (64 * sms * clock_mhz * 1e6) * 1e3
        pl = mk.plan(gkr_log, gkr_log, P, mk.EVAL_POINTS)
        extra = {"shape": f"{P} points x 2^{gkr_log} {field.name} words", "plan": dataclasses.asdict(pl)}
        if field is BABYBEAR:  # the PCS's evaluations (F389, m = 2)
            tp = words(F389, 4)
            rp = FArray(words(F389, pcs_points * 2).data.reshape(pcs_points, 2), F389)
            extra["pcs_ms"] = graph_ms(lambda: mk.eval_many(tp, rp), 3)
            log(f"F389 evaluation at the PCS's {pcs_points} points over 2 variables: {extra['pcs_ms']:.4f} ms from a "
                f"CUDA graph {tag}")
        timing["mle_eval_many"] = (ms, plain, max(bytes_ms, ops_ms), "operations" if ops_ms > bytes_ms else "bytes",
                                   None, extra)
        log(f"{field.name} evaluation at {P} points over 2^{gkr_log} words (GKR's restrict_poly; plan {pl}): {ms:.4f} "
            f"ms from a CUDA graph, products bound {ops_ms:.4f} ms ({ops_ms / ms:.1%}; {imad} IMAD per product at 64 "
            f"per clock per SM, {sms} SMs, {clock_mhz} MHz; bytes {bytes_ms:.4f} ms); plain {plain:.2f} ms {tag}")
        # the forward pass: one layer of 2^gkr_log gates over 2^gkr_log values
        cur = words(field, gw)
        b = torch.randint(0, gw, (gw,), generator=gen, device=dev, dtype=torch.int32)
        c = torch.randint(0, gw, (gw,), generator=gen, device=dev, dtype=torch.int32)
        m = torch.rand((gw,), generator=gen, device=dev) < 0.5
        ms = graph_ms(lambda: fk.forward_layer(cur, b, c, m))
        plain = graph_ms(lambda: fk.forward_layer_plain(cur, b, c, m), 5)
        bound = gw * (4 + 4 + 1 + 2 * wb) / PEAK_BYTES_PER_S * 1e3
        timing["forward"] = (ms, plain, bound, "bytes", None,
                             {"shape": f"2^{gkr_log} {field.name} gates over 2^{gkr_log} values"})
        log(f"{field.name} forward layer of 2^{gkr_log} gates: {ms:.4f} ms from a CUDA graph, bytes bound {bound:.4f} ms "
            f"({bound / ms:.1%}); plain (two gathers, the product, the add, a where) {plain:.4f} ms from a CUDA graph "
            f"{tag}")
        del t20, rs, cur, b, c, m
        torch.cuda.empty_cache()
        replaces = {"forward": "thaler_study_tpu/gkr/circuit.py:155", "mle_bitrev": "thaler_study_tpu/mle/dense.py:44",
                    "mle_fold": "thaler_study_tpu/mle/dense.py:176", "mle_eval_many": "thaler_study_tpu/mle/dense.py:185"}
        for name, (ms, plain, bound, by, lib, extra) in timing.items():
            launches = path_launches.get((name, be), 0)
            if not launches:
                raise AssertionError(f"{name} ({be}) was not launched on its main path")
            row = {"name": f"{name}_{be}", "route": "cuda",
                   "source": src + ("forward.cu" if name == "forward" else "mle.cu"), "replaces": replaces[name],
                   "launches": launches, "max_abs_err": err[(name, be)], "ms": ms, "plain_ms": plain,
                   "bound_ms": bound, "bound_by": by, "library_ms": lib}
            if lib is not None:
                row["library_call"] = "torch.index_select with a prebuilt index (the index not timed)"
            else:
                row["library_ms_reason"] = "no PyTorch call computes this function mod p"
            row.update(extra)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42, help="numpy seed of the tables")
    ap.add_argument("--n", type=int, default=22, help="variables per proof")
    ap.add_argument("--batch", type=int, default=64, help="proofs per dispatch")
    ap.add_argument("--reps", type=int, default=5, help="timed dispatches")
    ap.add_argument("--mm-log", type=int, default=13, help="log2 of the matmul entry's matrix side")
    ap.add_argument("--gkr-depth", type=int, default=16, help="layers of the flagship GKR circuit")
    ap.add_argument("--gkr-log", type=int, default=20, help="log2 of the flagship GKR circuit's width")
    ap.add_argument("--fused-trace-only", action="store_true",
                    help="trace one fused flagship proof, print its split by kernel and aten op, and stop")
    args = ap.parse_args(argv)
    jax_preloaded = "jax" in sys.modules

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result", file=sys.stderr)
        return 1

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from thaler_study_tpu_torch import _build, api, gkr
    from thaler_study_tpu_torch.fiat_shamir import (
        FiatShamirTranscript,
        SerializationError,
        SumcheckInteractiveProver,
        SumcheckInteractiveVerifier,
        XmdChain,
        generate_transcript,
        verify_transcript,
    )
    from thaler_study_tpu_torch.fields import BABYBEAR, F5, F389, F1572869, GOLDILOCKS, FArray, FeltVector
    from thaler_study_tpu_torch.fields import goldilocks as gl
    from thaler_study_tpu_torch.fields.farray import tensor_u64, word_dtype
    from thaler_study_tpu_torch.gkr import device_tables
    from thaler_study_tpu_torch.gkr import fused as gkr_fused
    from thaler_study_tpu_torch.gkr.circuit import layer_wiring
    from thaler_study_tpu_torch.mle import DenseMLE
    from thaler_study_tpu_torch.ops import (cuda_round, forward_kernel, fs_kernel, gkr_tail, merkle_kernel, mle_kernel,
                                            modmatmul, multiblock, row_sums, sha_chain, shard_layout)
    from thaler_study_tpu_torch.ops.round_kernel import single_block_spec
    from thaler_study_tpu_torch.ops.sha_chain import DevChain
    from thaler_study_tpu_torch.protocols import (
        BatchedProductPoly,
        MatMulG,
        ProductPoly,
        generate_transcripts_batch,
    )
    from thaler_study_tpu_torch.sumcheck import Prover, SumCheckError, Verifier
    from thaler_study_tpu_torch.utils.counters import COUNTS, count_round

    dev = torch.device("cuda")
    n, B = args.n, args.batch

    # ---- phase 1: device and build -----------------------------------
    card = card_line()
    log(card)
    tag = f"[{card}]"
    count = torch.cuda.device_count()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (count {count}), torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.fused_trace_only:
        return fused_trace_only(args, card)
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"built {sorted(_build.SOURCES)} in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one process per "
        f"source, all started together); each source's end: "
        f"{', '.join(f'{_build.SOURCES[n]} {sec:.1f} s' for n, sec in sorted(_build.build_seconds.items()))}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Function properties for" in line or "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    t0 = time.perf_counter()
    _build.load_host("native")
    log(f"built the host runtime (runtime/native.cpp, g++) in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()

    # ---- phase 2: kernels against their plain versions ---------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    gl_boundary = torch.tensor(
        [gl.to_i64(v) for v in (0, 1, gl.P - 1, gl.P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
                                1 << 63, (1 << 63) - 1, (1 << 64) - (1 << 32))],
        dtype=torch.int64, device=dev,
    )

    def words(field, *shape):
        """Random words of ``field`` (canonical Goldilocks, Montgomery mont32),
        boundary words first: for mont32 0, 1, p - 1, p - 2 and their
        Montgomery images."""
        if field.backend == "goldilocks":
            lo = torch.randint(0, 1 << 32, shape, generator=gen, device=dev, dtype=torch.int64)
            hi = torch.randint(0, (1 << 32) - 1, shape, generator=gen, device=dev, dtype=torch.int64)
            x, edge = (hi << 32) | lo, gl_boundary
        else:
            p = field.p
            x = torch.randint(0, p, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)
            e = [v % p for v in (0, 1, p - 1, p - 2)]
            edge = torch.tensor(e + [v * field.mont_r % p for v in e], dtype=torch.int32, device=dev)
        m = min(x.numel(), edge.numel())
        x.view(-1)[:m] = edge[:m]
        return x

    def max_abs_err(a, b) -> int:
        if torch.equal(a, b):
            return 0
        diff = (a != b).nonzero()[:64]
        ua, ub = tensor_u64(a[tuple(diff.T)]), tensor_u64(b[tuple(diff.T)])
        return max(abs(int(x) - int(y)) for x, y in zip(ua, ub))

    err = {}
    modes = ((False, False), (False, True), (True, False), (True, True))
    for field in (GOLDILOCKS, BABYBEAR, F1572869, F389, F5):
        key = ("round_kernel", field.backend)
        checks = 0
        for k in (2, 3):
            for size in (4, 8, 1 << 12, 1 << n):
                tables = [words(field, B, size) for _ in range(k)]
                r = words(field, B)
                for fold, skip in modes:
                    rr = r if fold else None
                    folded, parts = cuda_round.round_partials(tables, rr, skip_t1=skip, field=field)
                    ref_folded, ref = cuda_round.round_partials_plain(tables, rr, skip, parts.shape[1], field)
                    torch.cuda.synchronize()
                    e = max_abs_err(parts, ref)
                    if fold:
                        e = max([e] + [max_abs_err(a, b) for a, b in zip(folded, ref_folded)])
                    if e:
                        raise AssertionError(
                            f"round kernel != plain: {field.name} k={k} N={size} fold={fold} skip={skip}")
                    err[key] = max(err.get(key, 0), e)
                    checks += 1
                del tables, folded, ref_folded, parts, ref
        torch.cuda.empty_cache()
        log(f"round kernel == plain (exact) over {field.name} in {checks} cases: k in (2, 3), "
            f"N in (4, 8, 2^12, 2^{n}), B = {B}, all four modes, boundary words")

    def tail_case(field, degree, round_idx, nbytes):
        blocks = cuda_round.blocks_for(B, 1 << (n - 2))
        parts = words(field, B, blocks, degree + 1)
        claim = words(field, B)
        parts[3] = 0  # proof 3: all sums zero -> zero coefficients -> flagged
        claim[3] = 0
        chain = DevChain.fresh(B, dev)
        chain.state.copy_(torch.randint(-(1 << 31), 1 << 31, (B, 8), generator=gen, device=dev,
                                        dtype=torch.int64).to(torch.int32))
        fill = nbytes % 64
        chain.buf[:, :fill] = torch.randint(0, 256, (B, fill), generator=gen, device=dev,
                                            dtype=torch.int64).to(torch.uint8)
        chain.nbytes = nbytes
        vinv = fs_kernel.interp_tensor(field, degree, dev)
        m = fs_kernel._msg_len(round_idx, degree, field.byte_size)
        msgs = torch.randint(0, 256, (B, nbytes + m), generator=gen, device=dev, dtype=torch.int64).to(torch.uint8)
        state = [chain, claim, words(field, B), words(field, B), words(field, B, n * (degree + 1)), msgs,
                 torch.zeros(B, dtype=torch.int32, device=dev), vinv]
        return parts, state

    def clone_state(state):
        chain, *rest = state
        return [DevChain(chain.state.clone(), chain.buf.clone(), chain.nbytes)] + [t.clone() for t in rest]

    # the FS tail at every fill of the chain's partial block; the round
    # (0, middle, last: no draw) turns with the fill
    tail_rounds = (0, n // 2, n - 1)
    for field in (GOLDILOCKS, BABYBEAR, F1572869, F389, F5):
        key = ("fs_tail", field.backend)
        checks = 0
        for degree in (2, 3):
            for fill in range(64):
                round_idx = tail_rounds[fill % 3]
                draw = round_idx < n - 1
                parts, kstate = tail_case(field, degree, round_idx, 64 * (16 + fill % 5) + fill)
                pstate = clone_state(kstate)
                off = (degree + 1) * round_idx
                fs_kernel.fs_tail(parts, *kstate, round_idx, off, draw, field)
                fs_kernel.fs_tail_plain(parts, *pstate, round_idx, off, draw, field)
                torch.cuda.synchronize()
                kc, pc = kstate[0], pstate[0]
                outs = [(kc.state, pc.state), (kc.buf, pc.buf)] + list(zip(kstate[1:7], pstate[1:7]))
                e = max(max_abs_err(a.to(torch.int64), b.to(torch.int64)) for a, b in outs)
                if e:
                    raise AssertionError(
                        f"FS tail kernel != plain: {field.name} degree={degree} fill={fill} round={round_idx}")
                err[key] = max(err.get(key, 0), e)
                if int(kstate[6][3]) != 1:
                    raise AssertionError(f"FS tail kernel did not flag proof 3's zero coefficients ({field.name})")
                checks += 1
        log(f"FS tail kernel == plain (exact) over {field.name} in {checks} cases: B = {B}, every fill 0..63, "
            "degree 2 and 3, round 0 / middle / last, transcript bytes, one proof with zero coefficients")

    chain_out = torch.empty(8, dtype=torch.int32, device=dev)
    fs_kernel.sha_chain(5, chain_out)
    torch.cuda.synchronize()
    if chain_out.cpu().numpy().view(np.uint32).tolist() != fs_kernel.sha_chain_plain(5):
        raise AssertionError("SHA-256 chain helper != its plain version")
    log("SHA-256 chain helper (the latency floor's kernel) == plain over 5 compressions")

    # K1: the round kernel's LibraW shapes (phase 1: 3 tables; phase 2: 3
    # tables and the scalar w_u), batch 1 as GKR runs them and a batch of 4
    gw = args.gkr_log
    libra = ((1, cuda_round.LIBRA_PHASE1, 0), (2, cuda_round.LIBRA_PHASE2, 1))
    for field in (GOLDILOCKS, BABYBEAR, F1572869, F389, F5):
        key = ("libra_round", field.backend)
        checks = 0
        for phase, terms, n_scalars in libra:
            for batch, size in ((1, 4), (1, 8), (4, 1 << 12), (1, 1 << gw)):
                tables = [words(field, batch, size) for _ in range(3)]
                scalars = [words(field, batch) for _ in range(n_scalars)]
                r = words(field, batch)
                for fold, skip in modes:
                    rr = r if fold else None
                    folded, parts = cuda_round.round_partials(
                        tables, rr, skip_t1=skip, field=field, terms=terms, scalars=scalars)
                    ref_folded, ref = cuda_round.round_partials_plain(
                        tables, rr, skip, parts.shape[1], field, terms, scalars)
                    torch.cuda.synchronize()
                    e = max_abs_err(parts, ref)
                    if fold:
                        e = max([e] + [max_abs_err(a, b) for a, b in zip(folded, ref_folded)])
                    if e:
                        raise AssertionError(f"LibraW round kernel != plain: {field.name} phase={phase} "
                                             f"B={batch} N={size} fold={fold} skip={skip}")
                    err[key] = max(err.get(key, 0), e)
                    checks += 1
                del tables, folded, ref_folded, parts, ref
        log(f"round kernel, LibraW shapes (K1) == plain (exact) over {field.name} in {checks} cases: phases 1 "
            f"and 2, (B, N) in (1, 4), (1, 8), (4, 2^12), (1, 2^{gw}), all four modes, boundary words")

    # K1's round finished in its launch (libra_round_sums: the last block
    # sums every block's partials and writes s(0..2), s(1) = claim - s(0)
    # where a claim is given) against its plain version: every table of
    # words at p - 1 (Goldilocks p - 1 = 2^64 - 2^32) or random with the
    # boundary words; tables one word off 16 bytes (the scalar path
    # throughout) and halves below one 16-byte group (N = 2^2); the ticket
    # counter back at 0 after every launch
    sums_modes = ((False, False, False), (False, True, False), (False, True, True), (True, False, False),
                  (True, True, False), (True, True, True))
    sums_sizes = ((1, 1 << 2, "random"), (1, 1 << 10, "random"), (3, 1 << 11, "p - 1"), (1, 1 << 13, "random"),
                  (2, 1 << 13, "offset"), (1, 1 << gw, "random"), (1, 1 << gw, "p - 1"))
    for field in (GOLDILOCKS, BABYBEAR, F1572869, F389, F5):
        key = ("libra_round", field.backend)
        top = gl.to_i64(gl.P - 1) if field is GOLDILOCKS else (field.p - 1) * field.mont_r % field.p
        checks = 0
        for phase, terms, n_scalars in libra:
            for batch, size, fill in sums_sizes:
                if fill == "offset":  # a contiguous view one word past a 16-byte boundary
                    tables = [words(field, batch * size + 1)[1:].view(batch, size) for _ in range(3)]
                else:
                    tables = [words(field, batch, size) for _ in range(3)]
                scalars = [words(field, batch) for _ in range(n_scalars)]
                r, claim = words(field, batch), words(field, batch)
                if fill == "p - 1":
                    for t_ in tables + scalars + [r, claim]:
                        t_.fill_(top)
                for fold, skip, with_claim in sums_modes:
                    rr, cl = (r if fold else None), (claim if with_claim else None)
                    folded, s = cuda_round.libra_round_sums(tables, rr, skip, None, field, terms, scalars, cl)
                    ref_folded, ref = cuda_round.libra_round_sums_plain(tables, rr, skip, field, terms, scalars, cl)
                    torch.cuda.synchronize()
                    e = max_abs_err(s, ref)
                    if fold:
                        e = max([e] + [max_abs_err(a, b) for a, b in zip(folded, ref_folded)])
                    if e or int(_build.ticket_counter(dev)) != 0:
                        raise AssertionError(f"K1 round sums != plain: {field.name} phase={phase} B={batch} N={size} "
                                             f"{fill} fold={fold} skip={skip} claim={with_claim}; ticket counter "
                                             f"{int(_build.ticket_counter(dev))}")
                    err[key] = max(err.get(key, 0), e)
                    checks += 1
                del tables, scalars
        log(f"K1 round sums in the launch (libra_round_sums) == plain (exact) over {field.name} in {checks} cases: "
            f"phases 1 and 2, (B, N, words) in {[(b_, f'2^{s_.bit_length() - 1}', f_) for b_, s_, f_ in sums_sizes]}, "
            "fold / no fold x skip-1 with the claim, without it, and off; ticket counter back at 0")

    # K2: the phase-table scatter-add over its static plan: random wirings
    # at every k = 4..gw (the flagship's wiring law), skewed and sparse ones
    wrng = np.random.default_rng(args.seed + 1)
    big, hot = 1 << 16, np.full(1 << 16, 3)
    wirings = [
        ("random, 2^16 gates on 2^16 cells", 16, wrng.integers(0, big, big), wrng.integers(0, big, big)),
        ("every gate on one cell, 2^16 gates", 4, hot, hot + 8),
        ("fan-in 64, 2^16 gates on 2^10 cells", 10, wrng.integers(0, 1 << 10, big), wrng.integers(0, 1 << 10, big)),
        ("empty cells, 2^10 gates on even cells below 2^12 of 2^14", 14,
         2 * wrng.integers(0, 1 << 11, 1 << 10), 2 * wrng.integers(0, 1 << 11, 1 << 10)),
    ]
    uniform = [(f"random, 2^{k_} gates on 2^{k_} cells", k_, wrng.integers(0, 1 << k_, 1 << k_),
                wrng.integers(0, 1 << k_, 1 << k_)) for k_ in range(4, gw + 1)]

    def device_wirings(ws):
        out = []
        for name, k_, b, c in ws:
            bt, ct = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (b, c))
            out.append((name, k_, layer_wiring(bt, ct, torch.from_numpy(wrng.random(len(b)) < 0.5).to(dev), k_)))
        return out

    wirings, uniform = device_wirings(wirings), device_wirings(uniform)
    for field in (GOLDILOCKS, BABYBEAR, F1572869, F389, F5):
        key = ("phase_tables", field.backend)
        checks = 0
        cases = wirings + (uniform if field in (GOLDILOCKS, BABYBEAR) else uniform[:1])
        for name, k, w in cases:
            g = w.b.shape[0]
            top = np.full(max(g, 1 << k), field.p - 1, dtype=np.uint64)
            for values in ("random words", "every value p - 1"):
                if values == "random words":
                    eq_r, table = FArray(words(field, g), field), FArray(words(field, 1 << k), field)
                else:
                    eq_r = FArray.from_ints(top[:g], field, device=dev)
                    table = FArray.from_ints(top[: 1 << k], field, device=dev)
                for phase, key_t, gidx in ((1, w.b, w.c), (2, w.c, w.b)):
                    out = device_tables.phase_tables(phase, w, eq_r, table, k)
                    ref = device_tables.phase_tables_plain(phase, key_t, gidx, w.is_mul, eq_r, table, k)
                    torch.cuda.synchronize()
                    e = max(max_abs_err(a.data, b.data) for a, b in zip(out, ref))
                    if e:
                        raise AssertionError(f"phase-table kernel != plain: {field.name} {name} {values} phase={phase}")
                    err[key] = max(err.get(key, 0), e)
                    checks += 1
        log(f"phase-table kernel (K2) == plain (exact) over {field.name} in {checks} cases: "
            f"{'; '.join(c[0] for c in cases[:len(wirings)])}; random wirings at k = "
            f"{cases[len(wirings)][1]}..{cases[-1][1]}; random words and every value p - 1; phases 1 and 2")
    del wirings, uniform

    # the GKR paths' table kernels: the eq table, alone and with the dot
    # W~(u) in the same pass (every field the GKR prover runs: Goldilocks,
    # BabyBear); the line restriction's tiles (Goldilocks, the fused path's
    # field, and BabyBear); then the two GKR tails (Goldilocks)
    for field in (GOLDILOCKS, BABYBEAR):
        checks = 0
        top = field.p - 1
        for n_ in range(0, gw + 1):
            for values in ("random words", "0", "1", "p - 1"):
                if values == "random words":
                    r = FArray(words(field, max(n_, 1))[:n_], field)
                else:
                    r = FArray.from_ints([{"0": 0, "1": 1, "p - 1": top}[values]] * n_, field, device=dev)
                ref = device_tables.eq_table_plain(r, n_)
                out = device_tables.eq_table_dev(r, n_)
                torch.cuda.synchronize()
                e = max_abs_err(out.data, ref.data)
                if e:
                    raise AssertionError(f"eq-table kernel != plain: {field.name} n={n_} r={values}")
                err[("eq_table", field.backend)] = max(err.get(("eq_table", field.backend), 0), e)
                for w_values in ("random words", "every value p - 1"):
                    if w_values == "random words":
                        w_ = FArray(words(field, 1 << n_), field)
                    else:
                        w_ = FArray.from_ints(np.full(1 << n_, top, dtype=np.uint64), field, device=dev)
                    eq_u, w_u = device_tables.eq_table_dot(r, w_, n_)
                    want = device_tables.dot_mod(w_, ref)
                    torch.cuda.synchronize()
                    e = max(max_abs_err(eq_u.data, ref.data), max_abs_err(w_u.data, want.data))
                    if e or w_u.shape != (1,):
                        raise AssertionError(f"eq-with-dot kernel != plain: {field.name} n={n_} r={values} W={w_values}")
                    err[("eq_table_dot", field.backend)] = max(err.get(("eq_table_dot", field.backend), 0), e)
                checks += 1
        log(f"eq-table kernel and eq with the dot == eq_table_plain (+ dot_mod) (exact) over {field.name} in "
            f"{checks} x (1 + 2) cases: n = 0..{gw}, r random (boundary words first), all 0, all 1, all p - 1; "
            "W random and every value p - 1; eq table and W~(u)")
    for field in (GOLDILOCKS, BABYBEAR):
        checks = 0
        for k_ in range(2, gw + 1):
            for values in ("random words", "every value p - 1"):
                if values == "random words":
                    w_, chal = FArray(words(field, 1 << k_), field), FArray(words(field, 2 * k_), field)
                else:
                    w_, chal = (FArray.from_ints(np.full(n_, field.p - 1, dtype=np.uint64), field, device=dev)
                                for n_ in (1 << k_, 2 * k_))
                u_, c_ = chal[:k_], chal[k_:]
                ref = device_tables.line_restrict_coeffs_plain(w_, u_, c_ - u_, k_)
                out = device_tables.line_restrict_chal(w_, chal, k_)
                forms = [out]
                if k_ % 6 == 2:  # the JAX signature (delta given) on the same tiles
                    forms.append(device_tables.line_restrict_coeffs(w_, u_, c_ - u_, k_))
                torch.cuda.synchronize()
                e = max(max_abs_err(q_.data, ref.data) for q_ in forms)
                if e or out.shape != (k_ + 1,):
                    raise AssertionError(f"line-restriction kernel != plain: {field.name} k={k_} {values} "
                                         f"tiles {device_tables.line_plan(k_, w_.data.element_size())}")
                err[("line_restrict", field.backend)] = max(err.get(("line_restrict", field.backend), 0), e)
                checks += 1
        plans = sorted({tuple(device_tables.line_plan(k_, 8 if field is GOLDILOCKS else 4)) for k_ in (2, 10, 11, gw)})
        log(f"line-restriction kernel == plain (exact) over {field.name} in {checks} cases: k = 2..{gw} through the "
            f"fused path's form (u and c from one challenge vector), the delta form at k = "
            f"{[k_ for k_ in range(2, gw + 1) if k_ % 6 == 2]}; random words "
            f"and every value p - 1; tiles per restriction e.g. {plans}")

    tail_blocks = cuda_round.blocks_for(1, 1 << (gw - 2))
    trng = np.random.default_rng(args.seed + 5)

    def gkr_tail_case(fill, m, k_):
        """A chain after a random prefix with the given fill, K1-shaped
        partials, a claim, the layer's challenge vector, a byte buffer with
        room for the message at offset 7, a zero flag; and a copy of the
        mutable state for the plain version."""
        prefix = trng.integers(0, 256, 64 * (2 + fill % 5) + fill, dtype=np.uint8).tobytes()
        chain = gkr_tail.prefix_chain(prefix, dev)
        state = {
            "partials": words(GOLDILOCKS, 1, tail_blocks, 3),
            "claim": words(GOLDILOCKS, 1),
            "chal": words(GOLDILOCKS, 2 * k_),
            "msgs": torch.randint(0, 256, (m + 16,), generator=gen, device=dev, dtype=torch.int64).to(torch.uint8),
            "zero": torch.zeros(1, dtype=torch.int32, device=dev),
        }
        copy = {name: t.clone() for name, t in state.items()}
        return (chain, state), (gkr_tail.GKRChain(chain.state.clone(), chain.buf.clone(), chain.nbytes), copy)

    def tail_err(a, b):
        (ca, sa), (cb, sb) = a, b
        outs = [(ca.state, cb.state), (ca.buf, cb.buf)] + [(sa[n_], sb[n_]) for n_ in sa]
        return max(max_abs_err(x.to(torch.int64), y.to(torch.int64)) for x, y in outs)

    # K1 with the round tail as its epilogue (TAIL) against K1's plain
    # version over the same split followed by the tail's plain version, at
    # every fill x (StartSumCheck, one draw, two draws), over tables of 2^4,
    # 2^10 and 2^gw entries (one block to a wave of blocks taking tickets),
    # both LibraW phases, with and without a fold
    key = ("libra_round_tail", "goldilocks")
    checks = 0
    F = GOLDILOCKS
    for fill in range(64):
        for msg_kind in ("StartSumCheck", "one draw", "two draws"):
            k_ = 2 + fill % 19
            start = (fill, k_) if msg_kind == "StartSumCheck" else None
            draws = 2 if msg_kind == "two draws" else 1
            idx = 2 * k_ - 3 if draws == 2 else fill % k_
            size = (1 << 4, 1 << 10, 1 << gw)[(fill + len(msg_kind)) % 3]
            phase = 1 if start else 1 + fill % 2
            fold = start is None and fill % 4 != 0
            _, terms, n_scalars = libra[phase - 1]
            tables = [words(F, 1, size) for _ in range(3)]
            scalars = [words(F, 1) for _ in range(n_scalars)]
            rr = words(F, 1) if fold else None
            m = gkr_tail.ROUND_LEN + (gkr_tail.START_LEN if start else 0)
            a, b = gkr_tail_case(fill, m, k_)
            if fill == 3 and msg_kind == "one draw":
                for t_ in tables:  # all sums zero with a zero claim: zero coefficients, flagged
                    t_.zero_()
                a[1]["claim"].zero_()
                b[1]["claim"].zero_()
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            layer_tail = gkr_tail.LayerTail(a[0], a[1]["msgs"], a[1]["zero"], a[1]["claim"], a[1]["chal"], counter)
            tail = gkr_tail.RoundTail(layer_tail, 7, idx, draws, start)
            folded, parts = gkr_tail.libra_round_tail(tables, rr, start is None, phase, scalars, tail)
            # the plain K1 over the kernel's split (one wave of blocks), then the plain tail
            ref_folded, ref_parts = cuda_round.round_partials_plain(tables, rr, start is None, parts.shape[1], F,
                                                                    terms, scalars)
            gkr_tail.round_tail_plain(ref_parts, b[0], b[1]["msgs"], 7, b[1]["zero"], b[1]["claim"], b[1]["chal"],
                                      idx, draws, start)
            torch.cuda.synchronize()
            e = max(tail_err(a, b), max_abs_err(parts, ref_parts))
            if fold:
                e = max([e] + [max_abs_err(x, y) for x, y in zip(folded, ref_folded)])
            if e or int(counter) != 0:
                raise AssertionError(f"K1 with TAIL != plain K1 then the plain tail: fill={fill} {msg_kind} N={size} "
                                     f"phase={phase} fold={fold}; ticket counter {int(counter)}")
            if fill == 3 and msg_kind == "one draw" and int(a[1]["zero"]) != 1:
                raise AssertionError("K1 with TAIL did not flag zero coefficients")
            err[key] = max(err.get(key, 0), e)
            checks += 1
        del tables, ref_folded, ref_parts, folded, parts
    log(f"round kernel with the GKR round tail (K1, TAIL) == K1's plain version then the plain round tail "
        f"(exact) in {checks} "
        f"cases: every fill 0..63 x (StartSumCheck, one draw, two draws), N in (2^4, 2^10, 2^{gw}), both LibraW "
        "phases, with and without a fold; partials, folded tables, transcript bytes, chain, challenges, claim; "
        "ticket counter back at 0; one case flagged zero")

    key = ("gkr_final_tail", "goldilocks")
    checks = 0
    for k_ in (2, 3, 10, gw):
        for fill in range(64):
            m = gkr_tail.final_len(k_)
            a, b = gkr_tail_case(fill, m, k_)
            q_ = words(GOLDILOCKS, k_ + 1)
            q_[q_ == 0] = 1  # words() puts a 0 first
            if fill == 9:
                q_[k_] = 0  # a zero coefficient of q: flagged
            r_a = torch.zeros(k_, dtype=torch.int64, device=dev)
            r_b = r_a.clone()
            gkr_tail.final_tail(a[1]["partials"], a[1]["claim"], q_, a[1]["chal"], k_, a[0], a[1]["msgs"], 7,
                                a[1]["zero"], r_a)
            gkr_tail.final_tail_plain(b[1]["partials"], b[1]["claim"], q_, b[1]["chal"], k_, b[0], b[1]["msgs"], 7,
                                      b[1]["zero"], r_b)
            torch.cuda.synchronize()
            e = max(tail_err(a, b), max_abs_err(r_a, r_b))
            if e:
                raise AssertionError(f"GKR final tail kernel != plain: k={k_} fill={fill}")
            if fill == 9 and int(a[1]["zero"]) != 1:
                raise AssertionError(f"GKR final tail kernel did not flag a zero coefficient of q at k={k_}")
            err[key] = max(err.get(key, 0), e)
            checks += 1
    log(f"GKR final tail kernel == plain (exact) in {checks} cases: k in (2, 3, 10, {gw}) x every fill 0..63, "
        "transcript bytes, chain, r_next; a zero coefficient of q flagged")

    # ---- phase 3: the paths at full size -----------------------------
    counters = {"round_kernel": cuda_round.launches, "fs_tail": fs_kernel.launches,
                "libra_round": cuda_round.libra_launches, "phase_tables": device_tables.launches,
                "eq_table": device_tables.eq_launches, "eq_table_dot": device_tables.eq_dot_launches,
                "line_restrict": device_tables.line_launches,
                "libra_round_tail": gkr_tail.tail_launches, "gkr_final_tail": gkr_tail.final_launches,
                "phase_tables_rows": device_tables.rows_launches, "gkr_round_tail": gkr_tail.round_launches,
                "multiblock_round": multiblock.launches, "multiblock_fold": multiblock.fold_launches,
                "modmatmul": modmatmul.launches, "modmatmul_tc": modmatmul.tc_launches,
                "modmatmul_digits": modmatmul.digit_launches, "merkle": merkle_kernel.launches,
                "libra_round_total": cuda_round.total_launches, "modmatmul_tc_total": modmatmul.total_launches,
                "row_sums": row_sums.launches, "shard_layout": shard_layout.launches,
                "forward": forward_kernel.launches, "mle_bitrev": mle_kernel.bitrev_launches,
                "mle_fold": mle_kernel.fold_launches, "mle_eval_many": mle_kernel.eval_launches}
    # slice 20's kernels: launches counted on their main paths (the matmul
    # entry's bit reversals and folds, the per-layer flagship's forward
    # passes and restrictions), per field family
    b6_launches = {}

    def reset_counts():
        for counts in counters.values():
            for key in counts:
                counts[key] = 0

    def read_counts():
        return {name: dict(counts) for name, counts in counters.items()}

    spec = single_block_spec(2, n)
    rng = np.random.default_rng(args.seed)

    def make_tables(field):
        out = []
        for _ in range(2):
            if field.backend == "goldilocks":
                lo = rng.integers(0, 1 << 32, size=(B, 1 << n), dtype=np.uint32)
                hi = rng.integers(0, 1 << 31, size=(B, 1 << n), dtype=np.uint32)
                out.append(FArray.from_jax_limbs(lo, hi, device=dev))
                del lo, hi
            else:
                mont = rng.integers(0, field.p, size=(B, 1 << n), dtype=np.uint32)
                out.append(FArray.from_jax_limbs(mont, field=field, device=dev))
                del mont
        return out

    def batch_path(field):
        """The batched prover at full size: launches, byte identity with the
        plain path on CPU copies, verifier, tamper, per-instance fallback."""
        tables = make_tables(field)
        poly = BatchedProductPoly(tables)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the first dispatch of (k, n, field, B, card) runs every round
        # eagerly, then captures rounds 2..n-1; the counted one replays them
        reset_counts()
        t0 = time.perf_counter()
        ts_first = generate_transcripts_batch(poly, field)
        first_s = time.perf_counter() - t0
        first_counts = read_counts()
        prog = fs_kernel.programs[(2, n, field.name, B, tables[0].data.device)]
        if prog.graph is None:
            raise AssertionError(f"{field.name}: the batch program was not captured")
        replays = prog.graph.replays
        reset_counts()
        ts = generate_transcripts_batch(poly, field)
        counts = read_counts()
        launches = {k: v.get(field.backend, sum(v.values())) for k, v in counts.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = dict.fromkeys(counters, 0)
        want.update(round_kernel=n, fs_tail=n)
        if launches != want or sum(sum(v.values()) for v in counts.values()) != 2 * n or counts != first_counts:
            raise AssertionError(f"{field.name}: expected {n} launches of each kernel per dispatch, eager and "
                                 f"replayed alike, got {counts} (eager {first_counts})")
        if prog.graph.replays != replays + 1:
            raise AssertionError(f"{field.name}: the counted dispatch did not replay the batch program")
        launches["fs_batch_program"] = prog.graph.replays - replays
        if any(a.to_bytes() != b.to_bytes() for a, b in zip(ts, ts_first)):
            raise AssertionError(f"{field.name}: the replayed dispatch != the first (eager) dispatch")
        log(f"{field.name} batch program: first dispatch (every round eager, then the capture of rounds 2..{n - 1}) "
            f"{first_s:.3f} s; the replayed dispatch byte-identical to it, with the same launch counts; the "
            f"program holds {prog.held_bytes() / 1e9:.3f} GB (its graph's pool {prog.graph.pool_bytes / 1e6:.1f} MB) "
            f"{tag}")
        bs = field.byte_size
        if len(ts) != B or any(len(t.g) != n for t in ts):
            raise AssertionError("wrong transcript shape")
        if any(len(t.g[0]) != bs + 8 + 3 * (8 + bs) or any(len(m) != 8 + 3 * (8 + bs) for m in t.g[1:])
               for t in ts):
            raise AssertionError("a transcript has a message of the wrong length")
        log(f"main path {field.name}: {B} proofs x n = {n}: launches {launches} per dispatch; "
            f"peak device memory {peak_gb:.3f} GB {tag}")

        idx = [0, B - 1]
        cpu_tables = [FArray(t.data[idx].cpu(), field) for t in tables]
        t0 = time.perf_counter()
        ts_cpu = generate_transcripts_batch(BatchedProductPoly(cpu_tables), field)
        cpu_s = time.perf_counter() - t0
        for j, i in enumerate(idx):
            if ts_cpu[j].to_bytes() != ts[i].to_bytes():
                raise AssertionError(f"{field.name} instance {i}: card transcript != plain CPU path")
            inst = [FArray(t.data[j], field) for t in cpu_tables]
            v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, inst)), field)
            if not verify_transcript(ts[i], v, field):
                raise AssertionError(f"{field.name} instance {i}: the verifier rejected an honest transcript")
            bad = [bytearray(m) for m in ts[i].g]
            bad[1][16] ^= 1  # lowest byte of round 1's first coefficient
            v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, inst)), field)
            try:
                accepted = verify_transcript(FiatShamirTranscript([bytes(m) for m in bad]), v, field)
            except (SumCheckError, SerializationError):
                accepted = False
            if accepted:
                raise AssertionError(f"{field.name} instance {i}: a tampered transcript was accepted")
        log(f"{field.name} instances {idx}: byte-identical to the plain path on CPU copies ({cpu_s:.2f} s on "
            "the host), accepted by verify_transcript with a CPU oracle, rejected with one byte flipped")

        z = 5
        zdata = tables[0].data.clone()
        zdata[z] = 0
        ztables = [FArray(zdata, field), tables[1]]
        out = fs_kernel.fs_prove_device_batch(spec, ztables)
        if out[z] is not None or any(out[i] != ts[i].g for i in range(B) if i != z):
            raise AssertionError(f"{field.name} zero batch: wrong per-instance fallback decision or results")
        ts_z = generate_transcripts_batch(BatchedProductPoly(ztables), field)
        zcpu = [FArray(t.data[z].cpu(), field) for t in ztables]
        host = generate_transcript(SumcheckInteractiveProver(Prover(ProductPoly(spec, zcpu))), field)
        if ts_z[z].to_bytes() != host.to_bytes():
            raise AssertionError(f"{field.name} zero batch: fallback transcript != CPU host loop")
        if any(ts_z[i].to_bytes() != ts[i].to_bytes() for i in range(B) if i != z):
            raise AssertionError(f"{field.name} zero batch: the other instances lost their fused result")
        v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, zcpu)), field)
        if not verify_transcript(ts_z[z], v, field):
            raise AssertionError(f"{field.name} zero batch: the fallback transcript was rejected")
        del zdata, ztables, out, ts_z
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"{field.name} zero batch: instance {z} took the host fallback (== CPU host loop, accepted); "
            f"the other {B - 1} kept the fused result")
        return tables, poly, ts, launches

    def batch_program_inputs(field, tables, ts):
        """The batch program over two inputs: the main path's tables and
        the same tables with every row rolled by one word. Each replayed
        dispatch byte-identical to the eager route (the same launches issued
        from Python, no graph); the second's instances 0 and B - 1 to the
        plain path on CPU copies, accepted, rejected when tampered; a replay
        makes the eager route's launches."""
        def eager(t):
            return fs_kernel._prove_batch(spec, t, b"", graph=False)

        if eager(tables) != [t.g for t in ts]:
            raise AssertionError(f"{field.name} batch program: the eager route != the replayed dispatch")
        tables2 = [FArray(t.data.roll(1, 1), field) for t in tables]
        reset_counts()
        got = fs_kernel.fs_prove_device_batch(spec, tables2)
        counts = read_counts()
        if counts["round_kernel"][field.backend] != n or counts["fs_tail"][field.backend] != n:
            raise AssertionError(f"{field.name} batch program, second input: launches {counts}")
        if got != eager(tables2) or any(m is None for m in got) or got[0] == ts[0].g:
            raise AssertionError(f"{field.name} batch program, second input: the replay != the eager route, an "
                                 "instance fell back, or the input did not change the transcript")
        idx = [0, B - 1]
        cpu_tables = [FArray(t.data[idx].cpu(), field) for t in tables2]
        ts_cpu = generate_transcripts_batch(BatchedProductPoly(cpu_tables), field)
        if [t.g for t in ts_cpu] != [got[i] for i in idx]:
            raise AssertionError(f"{field.name} batch program, second input, instances {idx}: != the CPU plain path")
        for j, i in enumerate(idx[:1]):
            inst = [FArray(t.data[j], field) for t in cpu_tables]
            v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, inst)), field)
            if not verify_transcript(FiatShamirTranscript(got[i]), v, field):
                raise AssertionError(f"{field.name} batch program, second input, instance {i}: rejected")
            bad = [bytearray(m) for m in got[i]]
            bad[n // 2][16] ^= 1
            v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, inst)), field)
            try:
                accepted = verify_transcript(FiatShamirTranscript([bytes(m) for m in bad]), v, field)
            except (SumCheckError, SerializationError):
                accepted = False
            if accepted:
                raise AssertionError(f"{field.name} batch program, second input, instance {i}: tampered, accepted")
        del tables2
        log(f"{field.name} batch program, two inputs (the main tables; every row rolled by one word): each replayed "
            f"dispatch byte-identical to the eager route; the second's instances {idx} byte-identical to the plain "
            f"path on CPU copies, instance 0 accepted, rejected with one byte flipped; {n} + {n} launches per replay "
            f"{tag}")

    # ---- phase 4: timing ---------------------------------------------
    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def time_launches(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0, e1 = events()
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    def time_batch_path(field, tables, poly, ts, label):
        """dispatch_ms, field-ops/s, each kernel against its bound, the
        device idle share from a trace of one dispatch."""
        wb = 8 if field.backend == "goldilocks" else 4  # bytes per word
        COUNTS.reset()
        s = spec
        for j in range(n):
            count_round(s, fold=j > 0)
            s = s.after_fold()
        ops_per_proof = COUNTS.field_muls + COUNTS.field_adds
        COUNTS.reset()
        s = spec
        for j in range(n):
            count_round(s, fold=j > 0, claim_known=j > 0)
            s = s.after_fold()
        kernel_ops_per_proof = COUNTS.field_muls + COUNTS.field_adds

        generate_transcripts_batch(poly, field)  # warm
        host_ms, dev_ms = [], []
        for _ in range(args.reps):
            e0, e1 = events()
            e0.record()
            t0 = time.perf_counter()
            ts_t = generate_transcripts_batch(poly, field)  # ends in its host read
            t1 = time.perf_counter()
            e1.record()
            e1.synchronize()
            host_ms.append((t1 - t0) * 1e3)
            dev_ms.append(e0.elapsed_time(e1))
        if any(a.to_bytes() != b.to_bytes() for a, b in zip(ts_t, ts)):
            raise AssertionError("timed dispatch changed the transcripts")
        dispatch_ms = statistics.median(host_ms)
        ops_per_s = ops_per_proof * B / (dispatch_ms / 1e3)
        # least device-memory traffic of one dispatch: round 0 reads the k
        # tables, round j >= 1 reads the previous tables and writes the folded
        dispatch_bytes = 2 * B * wb * ((1 << n) + sum((1 << (n - j + 1)) + (1 << (n - j)) for j in range(1, n)))
        log(f"{field.name} dispatch: {dispatch_ms:.3f} ms median of {args.reps} (host clock, ends in the host "
            f"read; all {[round(x, 3) for x in host_ms]}), CUDA events {statistics.median(dev_ms):.3f} ms; "
            f"proof_ms {dispatch_ms / B:.4f}; bound {dispatch_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms "
            f"({dispatch_bytes / 1e9:.2f} GB at 3.35 TB/s) {tag}")
        log(json.dumps({
            "metric": "fs_sumcheck_whole_proof_field_ops_per_s",
            "value": ops_per_s,
            "unit": "field_ops/s",
            "detail": {
                "field": label, "hypercube_points": 1 << n, "batch": B,
                "rounds_per_proof": n, "field_ops_per_proof": ops_per_proof,
                "kernel_actual_field_ops": kernel_ops_per_proof, "proof_ms": dispatch_ms / B,
                "dispatch_ms": dispatch_ms, "reps": args.reps, "card": card,
            },
        }))

        # the host's own share after the read: slicing B x n messages out of
        # the transcript bytes
        lens = [fs_kernel._msg_len(j, d, field.byte_size) for j, d in enumerate(spec.round_degrees())]
        host = np.random.default_rng(args.seed).integers(0, 256, size=(B, sum(lens) + 4), dtype=np.uint8)
        host[:, -4:] = 0
        split_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            fs_kernel.split_transcripts(host, lens)
            split_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"{field.name} host slicing of {B} x {n} messages out of {host.nbytes} transcript bytes (after the "
            f"read, device idle): {statistics.median(split_ms):.3f} ms median of 5 {tag}")

        # kernel 1 at the round-1 shape (fold + claim shortcut), and its plain version
        data = [t.data for t in tables]
        r1 = words(field, B)
        outs = [torch.empty((B, 1 << (n - 1)), dtype=word_dtype(field), device=dev) for _ in data]
        blocks1 = cuda_round.blocks_for(B, 1 << (n - 2))
        k1_ms = time_launches(lambda: cuda_round.round_partials(data, r1, True, outs, field), 20)
        k1_plain_ms = time_launches(lambda: cuda_round.round_partials_plain(data, r1, True, blocks1, field), 3)
        k1_bytes = B * (2 * (1 << n) * wb + 2 * (1 << (n - 1)) * wb + wb) + B * blocks1 * 3 * wb
        k1_bound = k1_bytes / PEAK_BYTES_PER_S * 1e3
        k0_ms = time_launches(lambda: cuda_round.round_partials(data, field=field), 20)
        k0_bound = (B * 2 * (1 << n) * wb) / PEAK_BYTES_PER_S * 1e3
        log(f"{field.name} round kernel, round-1 shape (B={B}, N=2^{n}, fold + claim): {k1_ms:.4f} ms, "
            f"bound {k1_bound:.4f} ms ({k1_bytes / 1e9:.3f} GB), {k1_bound / k1_ms:.1%} of the bound; "
            f"plain torch {k1_plain_ms:.3f} ms; no single PyTorch call computes a fold + round sums {tag}")
        log(f"{field.name} round kernel, round-0 shape (no fold): {k0_ms:.4f} ms, bound {k0_bound:.4f} ms, "
            f"{k0_bound / k0_ms:.1%} of the bound {tag}")
        per_round = [k0_ms]
        for j in range(1, n):
            size = 1 << (n - j + 1)
            tj = [t[:, :size].contiguous() for t in data]
            oj = [o[:, : size // 2].contiguous() for o in outs]
            per_round.append(time_launches(lambda: cuda_round.round_partials(tj, r1, True, oj, field), 5))
        del outs, tj, oj

        parts, kstate = tail_case(field, 2, 5, 1000)
        m2 = fs_kernel._msg_len(5, 2, field.byte_size)

        def tail_once(fn):
            kstate[0].nbytes = 1000  # the same fill (40) and chain for every launch
            fn(parts, *kstate, 5, 15, True, field)

        k2_eager_ms = time_launches(lambda: tail_once(fs_kernel.fs_tail), 100)
        # back to back without the host: 20 launches captured in a CUDA graph
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                tail_once(fs_kernel.fs_tail)
        k2_ms = time_launches(graph.replay, 5) / 20
        k2_plain_ms = time_launches(lambda: tail_once(fs_kernel.fs_tail_plain), 3)
        k2_bytes = parts.numel() * wb + B * (2 * 32 + 2 * 64 + 2 * wb + wb + 3 * wb + 2 * 4 + m2) + 9 * wb
        k2_bound = k2_bytes / PEAK_BYTES_PER_S * 1e3
        k2_comp = compressions(1000, m2, True)
        k2_floor = k2_comp * compress_ms
        dispatch_comp = sum(compressions(sum(lens[:j]), lens[j], j < n - 1) for j in range(n))
        device_ms = sum(per_round) + n * k2_ms
        log(f"{field.name} FS tail kernel (B={B}, degree 2, {parts.shape[1]} partials per proof): {k2_ms:.4f} ms "
            f"per launch replayed from a CUDA graph ({k2_eager_ms:.4f} ms issued from Python), bound "
            f"{k2_bound:.6f} ms ({k2_bytes} B), latency floor {k2_floor:.4f} ms ({k2_comp} compressions); "
            f"plain (Python ints) {k2_plain_ms:.3f} ms {tag}")
        log(f"{field.name} FS tail latency floor per dispatch: {dispatch_comp} compressions on each proof's chain "
            f"over {n} rounds, {dispatch_comp * compress_ms:.4f} ms {tag}")
        log(f"{field.name} per dispatch, kernels timed one shape at a time: round kernel {sum(per_round):.3f} ms "
            f"over {n} launches (rounds 0-3: {[round(x, 4) for x in per_round[:4]]}), FS tail {n * k2_ms:.3f} ms; "
            f"sum {device_ms:.3f} of {dispatch_ms:.3f} ms dispatch {tag}")

        # the batch program's replay against the eager route (the same
        # launches issued one by one from Python), in turns
        def eager_dispatch():
            return fs_kernel._prove_batch(spec, tables, b"", graph=False)

        turns = in_turns({"graph": lambda: fs_kernel.fs_prove_device_batch(spec, tables), "eager": eager_dispatch},
                         args.reps, torch.cuda.synchronize)
        graph_ms_, eager_ms = turns["graph"][0], turns["eager"][0]
        log(f"{field.name} dispatch, graph against eager in turns (fs_prove_device_batch, host clock, ends in the "
            f"host read): graph {graph_ms_:.3f} ms ({[round(x, 3) for x in turns['graph'][1]]}), "
            f"{ops_per_proof * B / (graph_ms_ / 1e3):.4e} field-ops/s; eager {eager_ms:.3f} ms "
            f"({[round(x, 3) for x in turns['eager'][1]]}), {ops_per_proof * B / (eager_ms / 1e3):.4e} field-ops/s; "
            f"{eager_ms / graph_ms_:.3f}x {tag}")

        # device busy time inside one dispatch, from the CUPTI records of a
        # trace: a replayed dispatch, then the eager route
        busy = {}
        for route, run, wall_ms in (("replayed", lambda: generate_transcripts_batch(poly, field), dispatch_ms),
                                    ("eager", eager_dispatch, eager_ms)):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
            spans, busy_us = device_spans(prof)
            per_kernel = {}
            for key in ("round_kernel", "fs_tail_kernel"):
                mine = [s1 - s0 for s0, s1, name in spans if key in name]
                per_kernel[key] = (sum(mine) / 1e3, len(mine))
            if not spans:
                log(f"{field.name} profiler trace of one {route} dispatch: no device records, device idle share not "
                    "measured")
                continue
            busy_ms = busy_us / 1e3
            busy[route] = (busy_ms, len(spans), 1 - busy_ms / wall_ms)
            tail_ms, tail_n = per_kernel["fs_tail_kernel"]
            log(f"{field.name} profiler trace of one {route} dispatch: device busy {busy_ms:.3f} ms (union of "
                f"{len(spans)} device records; round kernel {per_kernel['round_kernel'][0]:.3f} ms over "
                f"{per_kernel['round_kernel'][1]} launches, FS tail {tail_ms:.4f} ms over {tail_n}, "
                f"{tail_ms / max(tail_n, 1) * 1e3:.2f} us each) against the {wall_ms:.3f} ms dispatch -> device "
                f"idle share {1 - busy_ms / wall_ms:.1%} {tag}")
        if "replayed" not in busy:
            raise AssertionError(f"{field.name}: no device records in the trace of a replayed dispatch")
        program = (graph_ms_, eager_ms, busy["replayed"][0], busy["replayed"][1])
        return {"round_kernel": (k1_ms, k1_plain_ms, k1_bound), "fs_tail": (k2_ms, k2_plain_ms, k2_bound, k2_floor),
                "program": program}

    # the latency floor: one thread's chain of dependent compressions; the
    # difference of two chain lengths takes the launch out
    chain_ms = {c: time_launches(lambda: fs_kernel.sha_chain(c, chain_out), 5) for c in (1024, 2048)}
    compress_ms = (chain_ms[2048] - chain_ms[1024]) / 1024
    log(f"SHA-256 compression latency (one thread, dependent chain): {compress_ms * 1e6:.1f} ns "
        f"({chain_ms[1024]:.4f} ms for 1024, {chain_ms[2048]:.4f} ms for 2048) {tag}")

    launches, timing = {}, {}
    for field, label in ((GOLDILOCKS, "goldilocks(2^64-2^32+1)"), (BABYBEAR, "babybear(2^31-2^27+1)")):
        tables, poly, ts, launches[field.backend] = batch_path(field)
        batch_program_inputs(field, tables, ts)
        timing[field.backend] = time_batch_path(field, tables, poly, ts, label)
        del tables, poly, ts
        fs_kernel.programs.clear()  # the program's buffers: 3.2 GB for Goldilocks
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the matrix-multiplication entry point
    L = args.mm_log
    N = 1 << L
    for field in (F5, GOLDILOCKS):
        mrng = np.random.default_rng(args.seed + field.p % 1000)
        a = mrng.integers(0, field.p, size=N * N, dtype=np.uint64)
        b = mrng.integers(0, field.p, size=N * N, dtype=np.uint64)
        i, j = N - 3, 5
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        claim, t = api.prove_matmul_entry(L, a, b, i, j, field)
        prove_s = time.perf_counter() - t0
        counts = read_counts()
        if (counts["round_kernel"][field.backend] != L or sum(counts["fs_tail"].values())
                or counts["multiblock_round"][field.backend] != 1 or counts["mle_bitrev"][field.backend] != 2
                or counts["mle_fold"][field.backend] != 2):
            raise AssertionError(f"matmul {field.name}: expected {L} round kernel launches, c_1 on the "
                                 f"multi-block kernel, 2 bit reversals and 2 folds (f_a, f_b), got {counts}")
        for name in ("mle_bitrev", "mle_fold"):
            b6_launches[(name, field.backend)] = counts[name][field.backend]
        want = sum(int(x) * int(y) for x, y in zip(a[i * N : (i + 1) * N], b[j::N])) % field.p
        if claim.v != want:
            raise AssertionError(f"matmul {field.name}: claim {claim.v} != (A*B)[{i}][{j}] = {want}")
        t0 = time.perf_counter()
        if not api.verify_matmul_entry(L, a, b, i, j, t, field):
            raise AssertionError(f"matmul {field.name}: the verifier rejected an honest transcript")
        verify_s = time.perf_counter() - t0
        bad = [bytearray(m) for m in t.g]
        bad[1][16] ^= 1  # lowest byte of round 1's first coefficient
        try:
            accepted = api.verify_matmul_entry(L, a, b, i, j, FiatShamirTranscript([bytes(m) for m in bad]), field)
        except (SumCheckError, SerializationError):
            accepted = False
        if accepted:
            raise AssertionError(f"matmul {field.name}: a tampered transcript was accepted")
        log(f"matmul entry {field.name}, {N} x {N}: claim == (A*B)[{i}][{j}] from Python ints; round kernel "
            f"launches {counts['round_kernel']}; accepted, rejected with one byte flipped; prove {prove_s:.3f} s, "
            f"verify {verify_s:.3f} s (host clock, tables from numpy on the host) {tag}")

        # where the prover's time goes: the MLE build, c_1, the rounds, the hashing
        point = api._index_point(i, L, field) + api._index_point(j, L, field)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = MatMulG.new(L, a, b, point, field)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prover = SumcheckInteractiveProver(Prover(g))
        t2 = time.perf_counter()
        t_again = generate_transcript(prover, field)
        t3 = time.perf_counter()
        chain = XmdChain(field)
        for m in t_again.g:
            chain.absorb(m)
            chain.draw(1)
        t4 = time.perf_counter()
        if t_again.to_bytes() != t.to_bytes():
            raise AssertionError(f"matmul {field.name}: a second proof differs")
        log(f"matmul entry {field.name} split (host clock): MLE build (from_evals_lsb, relabel, fix_variables) "
            f"{(t1 - t0) * 1e3:.1f} ms; c_1 {(t2 - t1) * 1e3:.2f} ms; {L} rounds with hashing "
            f"{(t3 - t2) * 1e3:.2f} ms, of which host hashing {(t4 - t3) * 1e3:.2f} ms {tag}")
        # the MLE build by step, each synced: the upload of the numpy words,
        # the bit reversal, A's relabel (one permute copy), the fold chain
        build = dict.fromkeys(("upload", "bitrev", "relabel", "fold"), 0.0)
        folded = []
        for words_np, rel, rs in ((a, True, point[:L]), (b, False, point[L:])):
            for step in build:
                if step == "relabel" and not rel:
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if step == "upload":
                    x = FArray.from_ints(words_np, field, device=dev)
                elif step == "bitrev":
                    mle = DenseMLE(mle_kernel.bitrev(x, 2 * L), 2 * L)
                elif step == "relabel":
                    mle = mle.relabel(0, L, L)
                else:
                    mle = mle.fix_variables(list(rs))
                torch.cuda.synchronize()
                build[step] += time.perf_counter() - t0
            folded.append(mle.evals)
            del x, mle
        if any(not torch.equal(f.data, w.data) for f, w in zip(folded, g.tables)):
            raise AssertionError(f"matmul {field.name}: the MLE build by step != MatMulG.new's tables")
        log(f"matmul entry {field.name} MLE build by step (host clock, each synced; 2 x 2^{2 * L} words): upload "
            f"{build['upload'] * 1e3:.2f} ms, bit reversal {build['bitrev'] * 1e3:.3f} ms, relabel "
            f"{build['relabel'] * 1e3:.3f} ms, fold chain {build['fold'] * 1e3:.3f} ms {tag}")
        del a, b, g, prover, folded

        small = 10
        Ns = 1 << small
        a = mrng.integers(0, field.p, size=Ns * Ns, dtype=np.uint64)
        b = mrng.integers(0, field.p, size=Ns * Ns, dtype=np.uint64)
        c_card, t_card = api.prove_matmul_entry(small, a, b, 7, Ns - 1, field)
        c_cpu, t_cpu = api.prove_matmul_entry(small, a, b, 7, Ns - 1, field, device="cpu")
        if c_card != c_cpu or t_card.to_bytes() != t_cpu.to_bytes():
            raise AssertionError(f"matmul {field.name} at n_log = {small}: card transcript != CPU")
        log(f"matmul entry {field.name} at n_log = {small}: transcript byte-identical to device='cpu'")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # ---- GKR: phase 3 (paths) and phase 4 (timing) ----------------------
    def gkr_launch_counts(circuit, fused_path=False):
        """The launches of one proof: per layer 2k of K1 (one per round), 2
        of K2, one of the eq table (phase 1) and one of the eq table with
        the dot (phase 2), one forward-pass launch and one bit reversal
        (W to internal order), and on the per-layer path one evaluation
        (the restriction); on the fused path 2k - 1 of the 2k K1 launches
        carry the round tail (TAIL), and one final tail and the line
        restriction's launches (one at k = 20) follow."""
        ks = [circuit.num_vars_at(i + 1) for i in range(len(circuit.layers))]
        want = {"libra_round": sum(2 * k for k in ks), "phase_tables": 2 * len(ks), "eq_table": len(ks),
                "eq_table_dot": len(ks), "forward": len(ks), "mle_bitrev": len(ks)}
        if not fused_path:  # each layer's c_1 on the multi-block kernel, its restriction on the evaluation form
            want["multiblock_round"] = len(ks)
            want["mle_eval_many"] = sum(k >= 1 for k in ks)
        if fused_path:
            want.update(libra_round_tail=sum(2 * k - 1 for k in ks), gkr_final_tail=len(ks),
                        line_restrict=sum(len(device_tables.line_launches_of(device_tables.line_plan(k, 8)))
                                          for k in ks))
        return want

    def accepts(t, circuit, inputs, field) -> bool:
        try:
            return gkr.verify_gkr_transcript(t, gkr.Verifier(circuit, field), inputs, field)
        except (gkr.GKRError, SumCheckError, SerializationError, ValueError):
            return False

    def gkr_counts_ok(counts, field, circuit, fused_path=False) -> bool:
        want = {name: dict.fromkeys(counts_of, 0) for name, counts_of in counters.items()}
        for name, v in gkr_launch_counts(circuit, fused_path).items():
            want[name][field.backend] = v
        return counts == want

    gkr_launches = {}
    gkr_names = ("libra_round", "phase_tables", "eq_table", "eq_table_dot")
    mixed = [4, 1 << 12, 2, 1 << 10, 1 << 6, 1 << 8]
    for label, field in (("book circuit", F389), ("5-layer mixed-width circuit", GOLDILOCKS),
                         ("5-layer mixed-width circuit", BABYBEAR)):
        if field is F389:
            circuit, inputs = gkr.circuit_from_book(), [3, 2, 3, 1]
        else:
            srng = np.random.default_rng(args.seed + 2)
            circuit = gate_circuit(gkr, mixed, srng)
            inputs = [field.p - 1] + srng.integers(0, min(field.p, 1 << 62), mixed[-1] - 1).tolist()
        felts = field.felts(inputs)
        torch.cuda.synchronize()
        reset_counts()
        t_card = gkr.generate_gkr_transcript(gkr.Prover(circuit, felts, field), field)
        counts = read_counts()
        if not gkr_counts_ok(counts, field, circuit):
            raise AssertionError(f"GKR {label} {field.name}: launches {counts}, expected {gkr_launch_counts(circuit)}")
        gkr_launches[field.backend] = {name: counts[name][field.backend] for name in gkr_names}
        t_cpu = gkr.generate_gkr_transcript(gkr.Prover(circuit, felts, field, device="cpu"), field)
        if t_card.to_bytes() != t_cpu.to_bytes():
            raise AssertionError(f"GKR {label} {field.name}: card transcript != device='cpu'")
        if not accepts(t_card, circuit, felts, field):
            raise AssertionError(f"GKR {label} {field.name}: the verifier rejected an honest transcript")
        outs, ok = api.run_gkr(circuit, inputs, field, seed=args.seed)
        outs_cpu, ok_cpu = api.run_gkr(circuit, inputs, field, seed=args.seed, device="cpu")
        if not (ok and ok_cpu) or [f.v for f in outs] != [f.v for f in outs_cpu]:
            raise AssertionError(f"GKR {label} {field.name}: api.run_gkr on the card != device='cpu' or rejected")
        if field is F389 and [f.v for f in outs] != [36, 6]:
            raise AssertionError(f"GKR book circuit: outputs {[f.v for f in outs]} != [36, 6]")
        log(f"GKR {label} {field.name} (widths {[len(l) for l in circuit.layers] + [circuit.num_inputs]}): "
            f"generate_gkr_transcript on the card byte-identical to device='cpu' ({len(t_card.g)} messages), "
            f"accepted; api.run_gkr outputs and decision == device='cpu'; launches {gkr_launches[field.backend]}")

    # the fused path on small Goldilocks circuits (every layer k >= 2): the
    # card's transcript byte-identical to the fused path on the CPU and to
    # the per-layer path, accepted, no fallback
    for label, widths, seed in (("mixed-width", [1 << 4, 1 << 6, 1 << 4, 1 << 8, 1 << 6, 1 << 6], 3),
                                ("uniform", [1 << 8] * 5, 4)):
        srng = np.random.default_rng(args.seed + seed)
        circuit = gate_circuit(gkr, widths, srng)
        felts = GOLDILOCKS.felts([GOLDILOCKS.p - 1] + srng.integers(0, 1 << 62, widths[-1] - 1).tolist())
        torch.cuda.synchronize()
        reset_counts()
        f0 = gkr_fused.fallbacks
        t_card = gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, felts, GOLDILOCKS), GOLDILOCKS)
        counts = read_counts()
        if gkr_fused.fallbacks != f0 or not gkr_counts_ok(counts, GOLDILOCKS, circuit, fused_path=True):
            raise AssertionError(f"GKR fused {label}: fallbacks {gkr_fused.fallbacks - f0}, launches {counts}, "
                                 f"expected {gkr_launch_counts(circuit, True)}")
        t_cpu = gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, felts, GOLDILOCKS, device="cpu"), GOLDILOCKS)
        t_layer = gkr.generate_gkr_transcript(gkr.Prover(circuit, felts, GOLDILOCKS), GOLDILOCKS)
        if gkr_fused.fallbacks != f0 or not t_card.to_bytes() == t_cpu.to_bytes() == t_layer.to_bytes():
            raise AssertionError(f"GKR fused {label}: card transcript != device='cpu' or != the per-layer path")
        if not accepts(t_card, circuit, felts, GOLDILOCKS):
            raise AssertionError(f"GKR fused {label}: the verifier rejected an honest transcript")
        log(f"GKR fused path, {label} Goldilocks circuit (widths {widths}): generate_gkr_transcript_fused on the "
            f"card byte-identical to device='cpu' and to the per-layer path ({len(t_card.g)} messages), accepted, "
            f"no fallback; launches { {name: counts[name]['goldilocks'] for name in gkr_launch_counts(circuit, True)} }")

    # the flagship: benches/gkr_benchmark.py's circuit at --depth, --width-log
    depth, width = args.gkr_depth, 1 << args.gkr_log
    F = GOLDILOCKS
    grng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    circuit = gate_circuit(gkr, [width] * depth + [width], grng)
    construct_s = time.perf_counter() - t0
    inputs = grng.integers(0, 1 << 62, width)
    log(f"GKR flagship circuit {depth} x 2^{args.gkr_log} ({depth * width} gates) built in Python in "
        f"{construct_s:.2f} s (Gate objects and Circuit.__init__; not prover time)")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    transcript = gkr.generate_gkr_transcript(gkr.Prover(circuit, inputs, F), F)
    prove_s = time.perf_counter() - t0
    counts = read_counts()
    if not gkr_counts_ok(counts, F, circuit):
        raise AssertionError(f"GKR flagship: launches {counts}, expected {gkr_launch_counts(circuit)}")
    gkr_launches[F.backend] = {name: counts[name][F.backend] for name in gkr_names}
    for name in ("forward", "mle_eval_many"):
        b6_launches[(name, F.backend)] = counts[name][F.backend]
    n_msgs = 1 + sum(1 + 2 * circuit.num_vars_at(i + 1) for i in range(depth))
    if len(transcript.g) != n_msgs:
        raise AssertionError(f"GKR flagship: {len(transcript.g)} messages, expected {n_msgs}")
    outs = gkr.deserialize_gkr_message(transcript.g[0], F).circuit_outputs
    t0 = time.perf_counter()
    want = circuit.evaluate_device(FArray.from_ints(inputs, F, device="cpu"))[0].to_u64()
    cpu_fwd_s = time.perf_counter() - t0
    if not isinstance(outs, FeltVector) or not np.array_equal(np.asarray(outs.ints, dtype=np.uint64), want):
        raise AssertionError("GKR flagship: the claimed outputs != the plain forward pass on the CPU")
    t0 = time.perf_counter()
    if not gkr.verify_gkr_transcript(transcript, gkr.Verifier(circuit, F), inputs, F):
        raise AssertionError("GKR flagship: the verifier rejected an honest transcript")
    verify_s = time.perf_counter() - t0
    sumcheck_msgs = [i for i, m in enumerate(transcript.g) if m[0] == 2]
    flip = sumcheck_msgs[len(sumcheck_msgs) // 2]
    bad = list(transcript.g)
    bad[flip] = bad[flip][:-1] + bytes([bad[flip][-1] ^ 1])
    if accepts(gkr.GKRTranscript(bad), circuit, inputs, F):
        raise AssertionError("GKR flagship: a tampered transcript was accepted")
    transcript_bytes = sum(len(m) for m in transcript.g)
    log(f"GKR flagship {depth} x 2^{args.gkr_log} {F.name}: generate_gkr_transcript {prove_s:.3f} s (host clock, "
        f"forward pass included), {len(transcript.g)} messages, {transcript_bytes} bytes; launches K1 "
        f"{gkr_launches[F.backend]['libra_round']}, K2 {gkr_launches[F.backend]['phase_tables']}; outputs == the "
        f"plain forward pass on the CPU ({cpu_fwd_s:.2f} s); verify_gkr_transcript accepted in {verify_s:.3f} s; "
        f"rejected with one byte flipped in sumcheck message {flip} {tag}")

    def gkr_timed(circuit, inputs, field, traced_layer):
        """generate_gkr_transcript with a host-clock bucket per step (every
        step ends in a host read of its result) and one layer traced by the
        profiler. Returns the transcript, the buckets and the traced layer's
        (wall ms, device busy ms, device records)."""
        buckets = dict.fromkeys(("forward_s", "begin_s", "phase1_tables_s", "phase2_tables_s",
                                 "sumcheck_rounds_s", "final_restrict_s", "host_hashing_s"), 0.0)
        trace = []

        def step(name, layer, j, fn):
            if name == "layer":
                if layer != traced_layer:
                    return fn()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    out = fn()
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t) * 1e3
                spans, busy_us = device_spans(prof)
                trace.extend((wall_ms, busy_us / 1e3, spans))
                return out
            if name == "round":
                k = circuit.num_vars_at(layer + 1)
                key = "phase2_tables_s" if j == k else "final_restrict_s" if j == 2 * k - 1 else "sumcheck_rounds_s"
            else:
                key = {"begin": "begin_s", "start_round": "phase1_tables_s", "hash": "host_hashing_s"}[name]
            t = time.perf_counter()
            out = fn()
            buckets[key] += time.perf_counter() - t
            return out

        torch.cuda.synchronize()
        t = time.perf_counter()
        prover = gkr.Prover(circuit, inputs, field)
        torch.cuda.synchronize()
        buckets["forward_s"] = time.perf_counter() - t
        return gkr.generate_gkr_transcript(prover, field, step=step), buckets, tuple(trace)

    timed_t, buckets, (layer_ms, busy_ms, spans) = gkr_timed(circuit, inputs, F, depth // 2)
    if timed_t.to_bytes() != transcript.to_bytes():
        raise AssertionError("GKR flagship: the timed run's transcript differs")
    by_kernel = {}
    k1_longest_us = max([s1 - s0 for s0, s1, name in spans if "libra_round_kernel" in name], default=0.0)
    for s0, s1, name in spans:
        label = ("K1 libra_round_kernel" if "libra_round_kernel" in name else
                 "K2 phase_tables_kernel" if "phase_tables_kernel" in name else "other")
        ms_, n_ = by_kernel.get(label, (0.0, 0))
        by_kernel[label] = (ms_ + (s1 - s0) / 1e3, n_ + 1)
    idle = 1 - busy_ms / layer_ms if spans else None
    log(f"GKR flagship profiler trace of layer {depth // 2}: {layer_ms:.3f} ms wall (profiler on), device busy "
        f"{busy_ms:.3f} ms (union of {len(spans)} device records; "
        f"{', '.join(f'{k} {v[0]:.3f} ms over {v[1]}' for k, v in sorted(by_kernel.items()))}; longest K1 "
        f"record {k1_longest_us:.1f} us) -> device idle share "
        + (f"{idle:.1%}" if spans else "not measured (no device records)") + f" {tag}")
    log(json.dumps({
        "bench": "gkr_prover_full_protocol", "gates": depth * width, "depth": depth, "width": width,
        "field": F.name, "accepted": True, "prover_s": prove_s, "verifier_s": verify_s,
        "messages": len(transcript.g), "transcript_bytes": transcript_bytes,
        "breakdown_s": buckets, "breakdown_total_s": sum(buckets.values()),
        "circuit_construct_s": construct_s, "device_idle_share_one_layer": idle, "card": card,
    }))
    gl_trace = gkr_layer_trace(circuit, inputs, F, depth // 2, tag)
    # final_restrict_s's restriction by step, on a layer of the flagship's
    # width (restrict_poly's steps, each synced, median of 3): the line
    # points (host), evaluate_many (the points' upload, one evaluation
    # launch, the values read back), the Lagrange interpolation (host)
    from thaler_study_tpu_torch.gkr.protocol import line, restrict_poly
    from thaler_study_tpu_torch.sumcheck import lagrange_interpolate

    kw = args.gkr_log
    w_mle = DenseMLE(FArray(slice_words(torch.Generator(device=dev).manual_seed(args.seed), F, (width,), dev), F), kw)
    lb, lc = F.felts(list(range(3, 3 + kw))), F.felts(list(range(7, 7 + kw)))
    t_f = [F.felt(t) for t in range(kw + 1)]
    r_parts = {"points": [], "evaluate_many": [], "interpolation": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts = [[l_.evaluate(t) for l_ in line(lb, lc)] for t in t_f]
        t1 = time.perf_counter()
        vals = w_mle.evaluate_many(pts)
        t2 = time.perf_counter()
        q = lagrange_interpolate(list(zip(t_f, vals)), F)
        t3 = time.perf_counter()
        for key, sec in zip(r_parts, (t1 - t0, t2 - t1, t3 - t2)):
            r_parts[key].append(sec * 1e3)
    if q.coeffs_dense() != restrict_poly(lb, lc, w_mle).coeffs_dense():
        raise AssertionError("GKR flagship: restrict_poly by step != restrict_poly")
    log(f"GKR per-layer restriction by step at 2^{kw} (restrict_poly, median of 3, host clock, synced): the "
        f"{kw + 1} line points {statistics.median(r_parts['points']):.2f} ms, evaluate_many (upload, one "
        f"evaluation launch, read) {statistics.median(r_parts['evaluate_many']):.3f} ms, the Lagrange "
        f"interpolation {statistics.median(r_parts['interpolation']):.2f} ms; the bucket final_restrict_s also "
        f"holds each layer's last sumcheck round {tag}")
    del w_mle

    # the per-layer prover over BabyBear at the flagship's width, the path
    # K1 mont32 serves: the same circuit (benches/gkr_benchmark.py's wiring
    # and MUL probability), inputs drawn below p from the seed, through
    # generate_gkr_transcript and api.run_gkr; a 2-layer cut at 2^12 gates
    # against device="cpu"
    BB = BABYBEAR
    bb_inputs = field_inputs(args.seed, BB, width)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    bb_t = gkr.generate_gkr_transcript(gkr.Prover(circuit, bb_inputs, BB), BB)
    bb_prove_s = time.perf_counter() - t0
    counts = read_counts()
    if not gkr_counts_ok(counts, BB, circuit):
        raise AssertionError(f"GKR BabyBear {depth} x 2^{args.gkr_log}: launches {counts}, expected "
                             f"{gkr_launch_counts(circuit)}")
    gkr_launches[BB.backend] = {name: counts[name][BB.backend] for name in gkr_names}
    for name in ("forward", "mle_eval_many"):
        b6_launches[(name, BB.backend)] = counts[name][BB.backend]
    if len(bb_t.g) != n_msgs:
        raise AssertionError(f"GKR BabyBear: {len(bb_t.g)} messages, expected {n_msgs}")
    bb_outs = gkr.deserialize_gkr_message(bb_t.g[0], BB).circuit_outputs
    bb_want = circuit.evaluate_device(FArray.from_ints(bb_inputs, BB, device="cpu"))[0].to_u64()
    bb_ints = bb_outs.ints if isinstance(bb_outs, FeltVector) else [f.v for f in bb_outs]
    if not np.array_equal(np.asarray(bb_ints, dtype=np.uint64), bb_want):
        raise AssertionError("GKR BabyBear: the claimed outputs != the plain forward pass on the CPU")
    t0 = time.perf_counter()
    if not gkr.verify_gkr_transcript(bb_t, gkr.Verifier(circuit, BB), bb_inputs, BB):
        raise AssertionError("GKR BabyBear: the verifier rejected an honest transcript")
    bb_verify_s = time.perf_counter() - t0
    bad = list(bb_t.g)
    bad[flip] = bad[flip][:-1] + bytes([bad[flip][-1] ^ 1])
    if accepts(gkr.GKRTranscript(bad), circuit, bb_inputs, BB):
        raise AssertionError("GKR BabyBear: a tampered transcript was accepted")
    bb_run_outs, bb_ok = api.run_gkr(circuit, bb_inputs, BB, seed=args.seed)
    if not bb_ok or [f.v for f in bb_run_outs] != [int(x) for x in bb_want]:
        raise AssertionError("GKR BabyBear: api.run_gkr rejected or its outputs differ")
    cut = gate_circuit(gkr, [1 << 12] * 3, np.random.default_rng(args.seed + 11))
    cut_inputs = field_inputs(args.seed, BB, 1 << 12)
    cut_card = gkr.generate_gkr_transcript(gkr.Prover(cut, cut_inputs, BB), BB)
    cut_cpu = gkr.generate_gkr_transcript(gkr.Prover(cut, cut_inputs, BB, device="cpu"), BB)
    if cut_card.to_bytes() != cut_cpu.to_bytes():
        raise AssertionError("GKR BabyBear 2 x 2^12 cut: card transcript != device='cpu'")
    bb_trace = gkr_layer_trace(circuit, bb_inputs, BB, depth // 2, tag)
    log(f"GKR per-layer BabyBear {depth} x 2^{args.gkr_log} (depth {depth}; the flagship's circuit, inputs below p): "
        f"generate_gkr_transcript {bb_prove_s:.3f} s (host clock, forward pass included), {len(bb_t.g)} messages, "
        f"{sum(len(m) for m in bb_t.g)} bytes; launches {gkr_launches[BB.backend]}; outputs == the plain forward pass "
        f"on the CPU; verify_gkr_transcript accepted in {bb_verify_s:.3f} s; rejected with one byte flipped in "
        f"sumcheck message {flip}; api.run_gkr accepted; the 2 x 2^12 cut byte-identical to device='cpu' "
        f"({len(cut_card.g)} messages); traced layer {depth // 2}: idle {bb_trace['idle']:.1%}, plain-torch kernels "
        f"per sumcheck round {bb_trace['plain_per_round']:.2f} (Goldilocks {gl_trace['plain_per_round']:.2f}) {tag}")
    log(json.dumps({
        "bench": "gkr_prover_per_layer_babybear", "gates": depth * width, "depth": depth, "width": width,
        "field": BB.name, "accepted": True, "prover_s": bb_prove_s, "verifier_s": bb_verify_s,
        "messages": len(bb_t.g), "launches": gkr_launches[BB.backend], "idle_one_layer": bb_trace["idle"],
        "plain_per_round": bb_trace["plain_per_round"], "goldilocks_plain_per_round": gl_trace["plain_per_round"],
        "card": card,
    }))
    # slice 13: the per-layer prover with mesh= on the flagship, both fields
    sharded_gkr_info = sharded_gkr([(F, circuit, inputs, transcript), (BB, circuit, bb_inputs, bb_t)], dev,
                                   torch.cuda.synchronize, reset_counts, tag)
    del bb_t, bad, cut, cut_card, cut_cpu

    # the fused path on the flagship: the same bytes as the per-layer run,
    # every layer's rounds on the card, one device-to-host read after the
    # prelude
    fused_keys = ("libra_round", "libra_round_tail", "phase_tables", "eq_table", "eq_table_dot", "line_restrict",
                  "gkr_final_tail")
    torch.cuda.synchronize()
    reset_counts()
    f0 = gkr_fused.fallbacks
    first_timings = []
    t0 = time.perf_counter()
    fused_t = gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, F), F, timings=first_timings)
    fused_first_s = time.perf_counter() - t0
    counts = read_counts()
    if gkr_fused.fallbacks != f0 or not gkr_counts_ok(counts, F, circuit, fused_path=True):
        raise AssertionError(f"GKR flagship fused: fallbacks {gkr_fused.fallbacks - f0}, launches {counts}, "
                             f"expected {gkr_launch_counts(circuit, True)}")
    fused_launches = {name: counts[name][F.backend] for name in fused_keys}
    if fused_t.to_bytes() != transcript.to_bytes():
        raise AssertionError("GKR flagship: the fused transcript != the per-layer transcript")
    t0 = time.perf_counter()
    if not gkr.verify_gkr_transcript(fused_t, gkr.Verifier(circuit, F), inputs, F):
        raise AssertionError("GKR flagship: the verifier rejected the fused transcript")
    fused_verify_s = time.perf_counter() - t0
    final_msgs = [i for i, m in enumerate(fused_t.g) if m[0] == 3]
    flip_f = final_msgs[len(final_msgs) // 2]
    bad = list(fused_t.g)
    bad[flip_f] = bad[flip_f][:-1] + bytes([bad[flip_f][-1] ^ 1])
    if accepts(gkr.GKRTranscript(bad), circuit, inputs, F):
        raise AssertionError("GKR flagship: a tampered fused transcript was accepted")
    capture_s = sum(sec for name_, _, sec in first_timings if name_ == "capture")
    log(f"GKR flagship fused: generate_gkr_transcript_fused byte-identical to the per-layer transcript, no fallback, "
        f"launches {fused_launches} (first run {fused_first_s:.3f} s with the prover's forward pass, the eager loop "
        f"and the capture of the layer loop as one CUDA graph, {capture_s:.3f} s of it; a sync after every step); "
        f"verify_gkr_transcript accepted in {fused_verify_s:.3f} s; rejected with one byte flipped in final "
        f"message {flip_f} {tag}")

    # the circuit's program: every later unsharded proof replays its graph,
    # with the eager loop's launch counts
    (prog,) = circuit._fused_programs.values()
    if prog.graph is None:
        raise AssertionError("GKR flagship fused: the program was not captured")
    replays = prog.graph.replays
    reset_counts()
    again = gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, F), F)
    counts = read_counts()
    if prog.graph.replays != replays + 1 or again.to_bytes() != transcript.to_bytes():
        raise AssertionError("GKR flagship fused: a warm proof did not replay the program, or its bytes differ")
    if not gkr_counts_ok(counts, F, circuit, fused_path=True):
        raise AssertionError(f"GKR flagship fused, replayed: launches {counts}, expected the eager loop's "
                             f"{gkr_launch_counts(circuit, True)}")
    fused_launches["gkr_fused_program"] = prog.graph.replays - replays

    def eager_fused(prover):  # the private eager route: the same loop, issued from Python
        return gkr_fused._transcript(prover, F, b"", None, None, graph=False)

    # a second input through the same program: the replay, the eager route and
    # device="cpu" byte-identical, accepted, rejected when tampered
    inputs_b = np.random.default_rng(args.seed + 16).integers(0, 1 << 62, width)
    t_b = gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs_b, F), F)
    e_b = eager_fused(gkr.Prover(circuit, inputs_b, F))
    t0 = time.perf_counter()
    c_b = gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs_b, F, device="cpu"), F)
    cpu_b_s = time.perf_counter() - t0
    if gkr_fused.fallbacks != f0 or prog.graph.replays != replays + 2:
        raise AssertionError("GKR flagship fused, second input: a fallback, or the proof did not replay")
    if not t_b.to_bytes() == e_b.to_bytes() == c_b.to_bytes() or t_b.to_bytes() == transcript.to_bytes():
        raise AssertionError("GKR flagship fused, second input: the replay != the eager route or device='cpu', or "
                             "the same bytes as the first input")
    if not accepts(t_b, circuit, inputs_b, F):
        raise AssertionError("GKR flagship fused, second input: the verifier rejected the replayed transcript")
    bad_b = list(t_b.g)
    bad_b[flip_f] = bad_b[flip_f][:-1] + bytes([bad_b[flip_f][-1] ^ 1])
    if accepts(gkr.GKRTranscript(bad_b), circuit, inputs_b, F):
        raise AssertionError("GKR flagship fused, second input: a tampered transcript was accepted")
    del t_b, e_b, c_b, bad_b
    log(f"GKR flagship fused program, two inputs: the first's replay byte-identical to the per-layer run with the "
        f"eager loop's launch counts; the second's replay byte-identical to the eager route and to device='cpu' "
        f"({cpu_b_s:.1f} s on the host, {torch.get_num_threads()} threads), accepted, rejected with one byte flipped; "
        f"the program holds "
        f"{prog.held_bytes() / 1e6:.1f} MB (its graph's pool {prog.graph.pool_bytes / 1e6:.1f} MB) {tag}")

    # the graph against the eager route in turns: host clock around Prover
    # (the forward pass) and the proof, which ends in its host read; the
    # proof alone from after the forward pass's sync
    routes = {"graph": lambda pr: gkr.generate_gkr_transcript_fused(pr, F), "eager": eager_fused}
    turn_s = {name: [] for name in routes}
    proof_s = {name: [] for name in routes}
    for rep in range(max(3, args.reps)):
        for name in (list(routes) if rep % 2 == 0 else list(routes)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prover = gkr.Prover(circuit, inputs, F)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            again = routes[name](prover)
            t2 = time.perf_counter()
            turn_s[name].append(t2 - t0)
            proof_s[name].append(t2 - t1)
            if again.to_bytes() != transcript.to_bytes():
                raise AssertionError(f"GKR flagship: a warm fused proof ({name}) differs")
    fused_s = turn_s["graph"]
    graph_med, eager_med = statistics.median(fused_s), statistics.median(turn_s["eager"])
    log(f"GKR flagship fused, graph against eager in turns (host clock, forward pass included): graph "
        f"{graph_med:.4f} s ({[round(x, 4) for x in fused_s]}), eager {eager_med:.4f} s "
        f"({[round(x, 4) for x in turn_s['eager']]}); the proof after the forward pass: graph "
        f"{statistics.median(proof_s['graph']):.4f} s, eager {statistics.median(proof_s['eager']):.4f} s {tag}")
    fwd_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gkr.Prover(circuit, inputs, F)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
    fwd_med = statistics.median(fwd_s)
    # the forward pass split: the inputs' upload, then one kernel per layer
    fwd_parts = {"upload": [], "layers": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inp = FArray.from_ints(inputs, F, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        circuit.evaluate_device(inp)
        torch.cuda.synchronize()
        fwd_parts["upload"].append(t1 - t0)
        fwd_parts["layers"].append(time.perf_counter() - t1)
    # a traced forward pass: one forward-kernel launch per layer (the
    # counters) and no other device record; the host idles around it (a
    # trace stopped right after its last kernel has lost records here)
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(10 * RANGE_GAP_S)
        circuit.evaluate_device(inp)
        torch.cuda.synchronize()
        time.sleep(100 * RANGE_GAP_S)
    fwd_launches = read_counts()["forward"][F.backend]
    fwd_spans, fwd_busy_us = device_spans(prof)
    fwd_records = sum("forward_kernel" in name_ for _, _, name_ in fwd_spans)
    if fwd_launches != depth or fwd_records != len(fwd_spans):
        raise AssertionError(f"GKR flagship: the traced forward pass launched {fwd_launches} forward kernels "
                             f"(expected {depth}, one per layer) and holds {len(fwd_spans)} device records, "
                             f"{fwd_records} of them forward_kernel")
    log(f"GKR flagship forward pass (gkr.Prover, median of 3): {fwd_med * 1e3:.2f} ms; the inputs' upload "
        f"{statistics.median(fwd_parts['upload']) * 1e3:.2f} ms, the {depth} layers (one forward kernel launch "
        f"each) {statistics.median(fwd_parts['layers']) * 1e3:.3f} ms; traced: {fwd_launches} forward-kernel "
        f"launches, {fwd_records} device records in the trace, all forward_kernel, busy {fwd_busy_us / 1e3:.3f} ms "
        f"{tag}")
    # the per-step split on the eager route, and a replayed proof's
    timings = []
    gkr_fused._transcript(gkr.Prover(circuit, inputs, F), F, b"", timings, None, graph=False)
    parts = {name: sum(sec for n_, _, sec in timings if n_ == name)
             for name in ("prelude", "phase1", "phase2", "pull", "assemble")}
    per_layer_ms = [1e3 * sum(sec for n_, i_, sec in timings if i_ == i and n_ in ("phase1", "phase2"))
                    for i in range(depth)]
    scan_timings = []
    gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, F), F, timings=scan_timings)
    scan_parts = {name: sec for name, _, sec in scan_timings}
    if list(scan_parts) != ["prelude", "scan_layers", "pull", "assemble"]:
        raise AssertionError(f"GKR flagship fused: a replayed proof's timings {list(scan_parts)}")
    # the prelude's parts on a fresh prover: the W_0 pull with Begin's
    # serialization, the native midstate over Z_pad || Begin, r_0's draw
    fprover = gkr.Prover(circuit, inputs, F)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    begin_raw = gkr.serialize_gkr_message(fprover.start_protocol())
    t1 = time.perf_counter()
    mid, rest = gkr_tail.midstate(begin_raw)
    t2 = time.perf_counter()
    sha_chain.draw_many_py(F, mid.tolist(), rest, len(begin_raw), circuit.num_vars_at(0))
    t3 = time.perf_counter()
    log(f"GKR flagship fused prelude split (host clock): W_0 pull and Begin serialization {(t1 - t0) * 1e3:.2f} ms, "
        f"native SHA-256 midstate over {len(begin_raw) / 1e6:.2f} MB {(t2 - t1) * 1e3:.2f} ms "
        f"({len(begin_raw) / (t2 - t1) / 1e6:.0f} MB/s), r_0's draw ({circuit.num_vars_at(0)} elements, Python "
        f"compressions) {(t3 - t2) * 1e3:.2f} ms {tag}")
    del fprover
    # traces: a replayed proof (the default route), then the eager route
    traced = {}
    for route, prove in (("replayed", None), ("eager", eager_fused)):
        traced_ms, spans, busy_us, fused_kernels, fused_aten = fused_trace(gkr, circuit, inputs, F, prove)
        if any("gkr_round_tail" in name for _, _, name in spans):
            raise AssertionError(f"GKR flagship fused ({route}): a standalone round-tail kernel ran")
        layer_start = min((s0 for s0, _, name in spans if "eq_table_kernel" in name), default=None)
        copies = [(s0, name) for s0, _, name in spans if "Memcpy" in name]
        if copies and layer_start is not None:
            reads = [name for s0, name in copies if "DtoH" in name and s0 > layer_start]
            writes = [name for s0, name in copies if "HtoD" in name and s0 > layer_start]
            if len(reads) != 1:
                raise AssertionError(f"GKR flagship fused ({route}): {len(reads)} device-to-host reads after the "
                                     f"prelude: {reads}")
            reads_note = (f"device-to-host copies after the prelude (the first eq-table kernel): {len(reads)} "
                          f"({reads[0]}); host-to-device copies after it: {len(writes)}")
        else:
            reads_note = "device-to-host copies: not measured (no copy records in the trace)"
        kernel_records = sum(1 for _, _, name in spans if "Memcpy" not in name and "Memset" not in name)
        idle = 1 - busy_us / 1e3 / traced_ms if spans else None
        traced[route] = (traced_ms, busy_us / 1e3, len(spans), kernel_records, idle)
        log(f"GKR flagship fused, traced {route} proof: {traced_ms:.3f} ms wall (profiler on), device busy "
            f"{busy_us / 1e3:.3f} ms (union of {len(spans)} device records, {kernel_records} of them kernels; "
            f"{split_line(fused_kernels, fused_aten)}); {reads_note}; device idle share "
            + (f"{idle:.1%}" if spans else "not measured (no device records)") + f" {tag}")
        if route == "replayed":
            # the TAIL launches by inner round (2k - 1 per layer, in issue
            # order), grouped by table size: rounds 0-2 of each phase are the
            # large ones
            k_f = circuit.num_vars_at(1)
            per_j = tail_by_round(spans, k_f, depth)
            if per_j is not None:
                log(f"GKR flagship fused trace, K1 with TAIL by inner round (mean over {depth} layers, us): phase 1 "
                    f"{[round(x, 1) for x in per_j[:k_f]]}; phase 2 {[round(x, 1) for x in per_j[k_f:]]} {tag}")
    if traced["replayed"][2] == 0:
        raise AssertionError("GKR flagship fused: no device records in the trace of a replayed proof")
    fused_idle = traced["replayed"][4]
    log(f"GKR flagship fused breakdown on the eager route (a sync after every step): prelude {parts['prelude']:.4f} "
        f"s, phase 1 {parts['phase1']:.4f} s, phase 2 {parts['phase2']:.4f} s over {depth} layers (per layer "
        f"{min(per_layer_ms):.2f}-{max(per_layer_ms):.2f} ms), pull {parts['pull']:.4f} s, assemble "
        f"{parts['assemble']:.4f} s; a replayed proof: prelude {scan_parts['prelude']:.4f} s, scan_layers "
        f"{scan_parts['scan_layers']:.4f} s, pull {scan_parts['pull']:.4f} s, assemble {scan_parts['assemble']:.4f} s; "
        f"forward pass {fwd_med:.4f} s (median of 3) {tag}")
    prove_med = graph_med
    log(json.dumps({
        "bench": "gkr_prover_fused_noninteractive", "gates": depth * width, "depth": depth, "width": width,
        "field": F.name, "accepted": True, "prover_s": prove_med, "verifier_s": fused_verify_s,
        "messages": len(fused_t.g), "transcript_bytes": sum(len(m) for m in fused_t.g),
        "breakdown": {"forward_pass_s": fwd_med, "fused_layers_s": prove_med - fwd_med,
                      "scan_layers_s": scan_parts["scan_layers"], "prelude_s": scan_parts["prelude"],
                      "eager_phase1_s": parts["phase1"], "eager_phase2_s": parts["phase2"],
                      "assemble_s": scan_parts["assemble"], "final_pull_s": scan_parts["pull"]},
        "prover_s_all": fused_s, "reps": len(fused_s), "eager_prover_s": eager_med,
        "eager_prover_s_all": turn_s["eager"], "first_proof_s": fused_first_s, "capture_s": capture_s,
        "program_bytes": prog.held_bytes(), "per_layer_path_prover_s": prove_s,
        "device_idle_share": fused_idle, "traced_ms": traced["replayed"][0], "device_records": traced["replayed"][2],
        "device_busy_ms": traced["replayed"][1], "eager_device_idle_share": traced["eager"][4],
        "launches": fused_launches, "card": card,
    }))
    fused_program = (statistics.median(proof_s["graph"]) * 1e3, statistics.median(proof_s["eager"]) * 1e3,
                     traced["replayed"][1], traced["replayed"][3])
    fused_bytes = fused_t.to_bytes()
    del transcript, timed_t, bad, fused_t, again, prog

    # K1 and K2 at the flagship's shapes: a 2^20-entry phase round with a
    # fold and the claim shortcut (batch 1), and layer 0's phase tables.
    # Issued from Python one by one, these launches time the host's wrapper
    # call; 20 launches captured in a CUDA graph time the kernel.
    def graph_ms(fn, count=20):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(count):
                fn()
        return time_launches(graph.replay, 5) / count

    gkr_timing = {}
    wiring = circuit.device_wiring(0, dev)
    k = circuit.num_vars_at(1)
    g = len(circuit.layers[0])
    for field in (GOLDILOCKS, BABYBEAR):
        wb = 8 if field.backend == "goldilocks" else 4
        N = 1 << k
        tables = [words(field, 1, N) for _ in range(3)]
        r1, scalar = words(field, 1), [words(field, 1)]
        outs = [torch.empty((1, N // 2), dtype=word_dtype(field), device=dev) for _ in range(3)]
        claim1 = words(field, 1)
        vec = cuda_round.vec_words(N // 4, wb, tables + outs)
        rows = {}
        for phase, terms, n_scalars in libra:
            sc = scalar[:n_scalars]
            blocks = cuda_round.libra_blocks(N // 4, vec, cuda_round.wave_blocks(dev, field.backend, phase, True, True))

            def k1():
                cuda_round.libra_round_sums(tables, r1, True, outs, field, terms, sc, claim1)

            issued_ms = time_launches(k1, 20)
            plain_ms = time_launches(
                lambda: cuda_round.libra_round_sums_plain(tables, r1, True, field, terms, sc, claim1), 3)
            # the tables read and the folded tables written once; r, the
            # scalars and the claim read; each block's partials written and
            # read again by the last block; s(0..2) written
            base = 3 * (N + N // 2) * wb + (1 + n_scalars) * wb
            nbytes = base + (1 + 2 * 3 * blocks + 3) * wb
            rows[f"K1 phase {phase}"] = (graph_ms(k1), plain_ms, nbytes / PEAK_BYTES_PER_S * 1e3, nbytes, issued_ms)
            log(f"{field.name} K1 phase {phase} at 2^{k} entries: {blocks} blocks, {vec} words per access, "
                f"{N // 4} pair indices")
            if field is not GOLDILOCKS:
                continue
            # K1 with the round tail as its epilogue, at a chain fill of 40
            (chain_, st_), _ = gkr_tail_case(40, gkr_tail.ROUND_LEN, k)
            counter = torch.zeros(1, dtype=torch.int32, device=dev)

            layer_tail = gkr_tail.LayerTail(chain_, st_["msgs"], st_["zero"], st_["claim"], st_["chal"], counter)

            def k1_tail():
                chain_.nbytes = 64 * 131072 + 40  # the same fill (40) for every launch
                gkr_tail.libra_round_tail(tables, r1, True, phase, sc, gkr_tail.RoundTail(layer_tail, 7, 5, 1), outs)

            def k1_tail_plain():
                chain_.nbytes = 64 * 131072 + 40
                _, parts_ = cuda_round.round_partials_plain(tables, r1, True, blocks, field, terms, sc)
                gkr_tail.round_tail_plain(parts_, chain_, st_["msgs"], 7, st_["zero"], st_["claim"], st_["chal"], 5, 1)

            issued_ms = time_launches(k1_tail, 20)
            plain_ms = time_launches(k1_tail_plain, 3)
            # K1's bytes with its partials written; then the partials read
            # again, the chain's state and block and the zero flag read and
            # written, the message written, the claim read and written, one
            # challenge written
            m_ = gkr_tail.ROUND_LEN
            tblocks = cuda_round.libra_blocks(N // 4, vec, cuda_round.wave_blocks(dev, "goldilocks", phase, True, True,
                                                                                   tail=True))
            tail_bytes = tblocks * 3 * 8 + 2 * (32 + 64 + 4) + m_ + 3 * 8
            floor_ms = compressions(64 * 131072 + 40, m_, True) * compress_ms
            all_bytes = base + tblocks * 3 * 8 + tail_bytes
            rows[f"K1+TAIL phase {phase}"] = (graph_ms(k1_tail), plain_ms, all_bytes / PEAK_BYTES_PER_S * 1e3,
                                              all_bytes, issued_ms, floor_ms)
            del chain_, st_
        eq_r, table = FArray(words(field, g), field), FArray(words(field, N), field)
        for phase, key_t, gidx in ((1, wiring.b, wiring.c), (2, wiring.c, wiring.b)):

            def k2():
                return device_tables.phase_tables(phase, wiring, eq_r, table, k)

            def k2_plain():
                return device_tables.phase_tables_plain(phase, key_t, gidx, wiring.is_mul, eq_r, table, k)

            # K2 against its plain version on the main path's own wiring
            e = max(max_abs_err(a.data, b.data) for a, b in zip(k2(), k2_plain()))
            if e:
                raise AssertionError(f"phase-table kernel != plain: {field.name} flagship layer 0 wiring phase={phase}")
            err[("phase_tables", field.backend)] = max(err[("phase_tables", field.backend)], e)
            log(f"phase-table kernel (K2) == plain (exact) over {field.name} on the flagship's layer 0 wiring "
                f"({g} gates on 2^{k} cells), random words, phase {phase}")
            issued_ms = time_launches(k2, 20)
            plain_ms = time_launches(k2_plain, 3)
            # the plan (order, packed) and eq_r per gate, starts and the
            # gathered table per cell read once; two tables written. (The
            # earlier design of this kernel also read a one-byte gate type
            # per gate: its bound counted g * (4 + 4 + 1 + wb) + the same
            # per-cell bytes.)
            nbytes = g * (4 + 4 + wb) + (N + 1) * 4 + N * wb + 2 * N * wb
            rows[f"K2 phase {phase}"] = (graph_ms(k2), plain_ms, nbytes / PEAK_BYTES_PER_S * 1e3, nbytes, issued_ms)
            prev_bytes = nbytes + g
            log(f"{field.name} K2 phase {phase} bound with a gate-type byte per gate read too (the earlier "
                f"design's count): {prev_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms ({prev_bytes / 1e6:.1f} MB)")
        for name, (ms, plain_ms, bound_ms, nbytes, issued_ms, *floor) in rows.items():
            log(f"{field.name} {name} at the flagship's shape (2^{k} entries, {g} gates): {ms:.4f} ms per launch "
                f"replayed from a CUDA graph ({issued_ms:.4f} ms issued from Python), bound {bound_ms:.4f} ms "
                f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), {bound_ms / ms:.1%} of the bound"
                + (f", tail latency floor {floor[0] * 1e3:.2f} us" if floor else "")
                + f"; plain {plain_ms:.3f} ms {tag}")
        gkr_timing[field.backend] = {"libra_round": rows["K1 phase 1"][:3], "phase_tables": rows["K2 phase 1"][:3]}
        if field is GOLDILOCKS:
            gkr_timing[field.backend]["libra_round_tail"] = rows["K1+TAIL phase 1"][:3] + rows["K1+TAIL phase 1"][5:]
            for phase in (1, 2):
                epi = rows[f"K1+TAIL phase {phase}"][0] - rows[f"K1 phase {phase}"][0]
                host = rows[f"K1+TAIL phase {phase}"][4] - rows[f"K1 phase {phase}"][4]
                with_tail = rows[f"K1+TAIL phase {phase}"][0]
                log(f"Goldilocks inner round, phase {phase}: K1 with the tail {with_tail * 1e3:.2f} "
                    f"us against K1 alone {rows[f'K1 phase {phase}'][0] * 1e3:.2f} us from CUDA graphs: the epilogue "
                    f"adds {epi * 1e3:.2f} us; issued from Python {rows[f'K1+TAIL phase {phase}'][4] * 1e3:.1f} us "
                    f"against {rows[f'K1 phase {phase}'][4] * 1e3:.1f} us per call ({host * 1e3:+.1f} us) {tag}")
        del tables, outs, eq_r, table

    # what the epilogue adds to K1 at each table size (phase 1, fold, claim
    # shortcut; CUDA graphs), against the round tail's latency floor
    (chain_, st_), _ = gkr_tail_case(40, gkr_tail.ROUND_LEN, k)
    layer_tail = gkr_tail.LayerTail(chain_, st_["msgs"], st_["zero"], st_["claim"], st_["chal"],
                                    torch.zeros(1, dtype=torch.int32, device=dev))
    sweep = []
    for m_ in range(4, k + 1, 4):
        tabs = [words(GOLDILOCKS, 1, 1 << m_) for _ in range(3)]
        outs_ = [torch.empty((1, 1 << (m_ - 1)), dtype=torch.int64, device=dev) for _ in range(3)]
        r_ = words(GOLDILOCKS, 1)

        def with_tail():
            chain_.nbytes = 64 * 131072 + 40
            gkr_tail.libra_round_tail(tabs, r_, True, 1, [], gkr_tail.RoundTail(layer_tail, 7, 5, 1), outs_)

        alone = graph_ms(lambda: cuda_round.round_partials(tabs, r_, True, outs_, GOLDILOCKS, libra[0][1]))
        sweep.append((m_, alone * 1e3, graph_ms(with_tail) * 1e3))
    log("K1 alone / K1 with TAIL by table size (phase 1, fold, CUDA graphs, us): "
        + ", ".join(f"2^{m_}: {a:.2f} / {b:.2f} (+{b - a:.2f})" for m_, a, b in sweep) + f" {tag}")
    del chain_, st_, layer_tail, tabs, outs_

    # the GKR table kernels at the flagship's shapes, from CUDA graphs: the
    # eq table (n = k entries; both fields), the eq table with the dot (the
    # phase-2 build's, W of the same width), the line restriction (its
    # tiles, timed per restriction; Goldilocks, the fused path's field);
    # then the final tail at a chain fill of 40 at k
    F = GOLDILOCKS
    for field in (GOLDILOCKS, BABYBEAR):
        wb = 8 if field.backend == "goldilocks" else 4
        r_, w_ = FArray(words(field, k), field), FArray(words(field, 1 << k), field)
        eq_ms = graph_ms(lambda: device_tables.eq_table_dev(r_, k))
        eq_plain = time_launches(lambda: device_tables.eq_table_plain(r_, k), 3)
        eq_bytes = (1 << k) * wb + k * wb  # r read, the table written
        dot_ms = graph_ms(lambda: device_tables.eq_table_dot(r_, w_, k))
        dot_plain = time_launches(lambda: device_tables.dot_mod(w_, device_tables.eq_table_plain(r_, k)), 3)
        dot_bytes = 2 * (1 << k) * wb + (k + 1) * wb  # r and W read, the table and W~(u) written
        gkr_timing[field.backend]["eq_table"] = (eq_ms, eq_plain, eq_bytes / PEAK_BYTES_PER_S * 1e3)
        gkr_timing[field.backend]["eq_table_dot"] = (dot_ms, dot_plain, dot_bytes / PEAK_BYTES_PER_S * 1e3)
        for name, ms, plain, nbytes, what in (("eq-table kernel", eq_ms, eq_plain, eq_bytes, "written"),
                                              ("eq-with-dot kernel", dot_ms, dot_plain, dot_bytes,
                                               "W read, the table written")):
            log(f"{field.name} {name} at n = {k}: {ms:.4f} ms per launch from a CUDA graph, bound "
                f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB {what} at 3.35 TB/s), "
                f"{nbytes / PEAK_BYTES_PER_S * 1e3 / ms:.1%} of the bound; plain torch {plain:.3f} ms {tag}")
    w_, chal_ = FArray(words(F, 1 << k), F), FArray(words(F, 2 * k), F)
    tiles = device_tables.line_plan(k, 8)
    lr_ms = graph_ms(lambda: device_tables.line_restrict_chal(w_, chal_, k))
    lr_plain = time_launches(lambda: device_tables.line_restrict_coeffs_plain(w_, chal_[:k], chal_[k:] - chal_[:k], k), 3)
    lr_bytes = ((1 << k) + 2 * k + k + 1) * 8  # W and the 2k challenges read once; q written
    gkr_timing["goldilocks"]["line_restrict"] = (lr_ms, lr_plain, lr_bytes / PEAK_BYTES_PER_S * 1e3)
    log(f"line-restriction kernel at k = {k} (tiles of {tiles} variables in "
        f"{len(device_tables.line_launches_of(tiles))} launch(es)): {lr_ms:.4f} ms per "
        f"restriction from a CUDA graph, bound {lr_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms ({lr_bytes / 1e6:.1f} MB: W "
        f"read once), {lr_bytes / PEAK_BYTES_PER_S * 1e3 / lr_ms:.1%} of the bound; plain torch {lr_plain:.3f} ms {tag}")
    # by width: how the time grows with the bytes (a latency-bound fold
    # grows with its levels, a bytes-bound one with 2^k)
    sweep = []
    for k_ in range(max(2, k - 8), k + 1, 4):
        w_k, chal_k = FArray(words(F, 1 << k_), F), FArray(words(F, 2 * k_), F)
        sweep.append((k_, graph_ms(lambda: device_tables.line_restrict_chal(w_k, chal_k, k_)) * 1e3,
                      device_tables.line_plan(k_, 8)))
    log("line-restriction kernel by k (CUDA graphs, us; tiles): "
        + ", ".join(f"k = {k_}: {us:.2f} {tl}" for k_, us, tl in sweep) + f" {tag}")
    del w_k, chal_k
    m = gkr_tail.final_len(k)
    (chain_, st_), _ = gkr_tail_case(40, m, k)
    st_["q"] = words(F, k + 1)
    r_next = torch.empty(k, dtype=torch.int64, device=dev)

    def final_launch(fn):
        chain_.nbytes = 64 * 131072 + 40  # the same fill (40) for every launch
        fn(st_["partials"], st_["claim"], st_["q"], st_["chal"], k, chain_, st_["msgs"], 7, st_["zero"], r_next)

    t_ms = graph_ms(lambda: final_launch(gkr_tail.final_tail))
    t_plain = time_launches(lambda: final_launch(gkr_tail.final_tail_plain), 3)
    # partials, the chain's state and partial block and the zero flag read
    # and written, the message written; the claim, q and the 2k challenges
    # read and r_{i+1} written
    t_bytes = tail_blocks * 3 * 8 + 2 * (32 + 64 + 4) + m + (1 + (k + 1) + 2 * k + k) * 8
    floor_ms = compressions(64 * 131072 + 40, m, True) * compress_ms
    gkr_timing["goldilocks"]["gkr_final_tail"] = (t_ms, t_plain, t_bytes / PEAK_BYTES_PER_S * 1e3, floor_ms)
    log(f"gkr_final_tail kernel ({tail_blocks} K1 partials, {m}-byte message at fill 40): {t_ms * 1e3:.2f} us per "
        f"launch from a CUDA graph, bound {t_bytes / PEAK_BYTES_PER_S * 1e3:.7f} ms ({t_bytes} B), latency floor "
        f"{floor_ms * 1e3:.2f} us ({compressions(64 * 131072 + 40, m, True)} compressions); plain (Python ints) "
        f"{t_plain:.3f} ms {tag}")
    # ---- slice 14: the sharded fused GKR prover on the flagship: phases 2-4
    slice14_rows = sharded_fused_slice(circuit, inputs, fused_bytes, dev, torch.cuda.synchronize, graph_ms,
                                       time_launches, reset_counts, read_counts, compress_ms, tag, reps=args.reps)
    del wiring, circuit, fused_bytes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- the multi-block slice: phases 2-4 ----------------------------
    slice_rows = multiblock_slice(args.seed, tag, dev, torch.cuda.synchronize, graph_ms, time_launches,
                                  reset_counts, read_counts)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- slice 12: batched proving, the fused prover over every spec, the
    # PCS and its Merkle build: phases 2-4 ---------------------------------
    slice_rows += batch_pcs_slice(args.seed, tag, dev, torch.cuda.synchronize, graph_ms, time_launches, reset_counts,
                                  read_counts, compress_ms, reps=args.reps, n=n, batch=B, batch4=max(1, B // 4))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- slice 13: the sharded prover on a mesh of 8 shards on the card:
    # phases 2, 3 and 5 (phase 4's GKR part ran on the flagship above) ----
    slice_rows += sharded_slice(args.seed, tag, dev, torch.cuda.synchronize, graph_ms, reset_counts, compress_ms,
                                sharded_gkr_info, reps=args.reps, n=n + (B - 1).bit_length(), gkr_log=args.gkr_log)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- slice 20: B6's device programs: phases 2 and 4 (their main paths
    # ran above: the matmul entry, the per-layer and fused GKR flagship, the
    # triangle's input building, the PCS commit) ----
    slice_rows += mle_slice(args.seed, tag, dev, torch.cuda.synchronize, graph_ms, b6_launches)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- phase 5: summary lines --------------------------------------
    if "thaler_study_tpu" in sys.modules or (not jax_preloaded and "jax" in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    sources = {"round_kernel": ("thaler_study_tpu_torch/csrc/round_kernel.cu", "thaler_study_tpu/ops/pallas_round.py:341"),
               "fs_tail": ("thaler_study_tpu_torch/csrc/fs_tail.cu", "thaler_study_tpu/ops/fs_kernel.py:220")}
    kernels = []
    for name, (source, replaces) in sources.items():
        for backend in ("goldilocks", "mont32"):
            ms, plain_ms, bound_ms, *floor = timing[backend][name]
            row = {
                "name": f"{name}_{backend}", "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[backend][name], "max_abs_err": err[(name, backend)],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                "library_ms": None,
            }
            if floor:
                row["latency_floor_ms"] = floor[0]
            kernels.append(row)
    # the GKR kernels: launches per per-layer flagship proof (Goldilocks, and
    # BabyBear on the same circuit), times at the flagship's shapes (phase 1)
    gkr_sources = {"libra_round": ("thaler_study_tpu_torch/csrc/round_kernel.cu", "thaler_study_tpu/ops/pallas_round.py:341"),
                   "phase_tables": ("thaler_study_tpu_torch/csrc/phase_tables.cu", "thaler_study_tpu/gkr/device_tables.py:192")}
    for name, (source, replaces) in gkr_sources.items():
        for backend in ("goldilocks", "mont32"):
            ms, plain_ms, bound_ms = gkr_timing[backend][name]
            kernels.append({
                "name": f"{name}_{backend}", "route": "cuda", "source": source, "replaces": replaces,
                "launches": gkr_launches[backend][name], "max_abs_err": err[(name, backend)],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            })
    # the fused path's kernels: launches on the flagship's fused proof (the
    # eq tables over mont32: the BabyBear per-layer flagship proof); the line
    # restriction's ms and bound are per restriction (its tile launches);
    # the eq table with the dot replaces eq_table_dev (:316) and dot_mod
    # (:350) as phase2_tables (:411) applies them
    fused_sources = {
        ("eq_table", "goldilocks"): ("thaler_study_tpu_torch/csrc/gkr_tables.cu", "thaler_study_tpu/gkr/device_tables.py:316"),
        ("eq_table", "mont32"): ("thaler_study_tpu_torch/csrc/gkr_tables.cu", "thaler_study_tpu/gkr/device_tables.py:316"),
        ("eq_table_dot", "goldilocks"): ("thaler_study_tpu_torch/csrc/gkr_tables.cu",
                                         "thaler_study_tpu/gkr/device_tables.py:350"),
        ("eq_table_dot", "mont32"): ("thaler_study_tpu_torch/csrc/gkr_tables.cu",
                                     "thaler_study_tpu/gkr/device_tables.py:350"),
        ("line_restrict", "goldilocks"): ("thaler_study_tpu_torch/csrc/gkr_tables.cu", "thaler_study_tpu/gkr/device_tables.py:454"),
        ("libra_round_tail", "goldilocks"): ("thaler_study_tpu_torch/csrc/gkr_tail.cuh", "thaler_study_tpu/gkr/fused.py:161"),
        ("gkr_final_tail", "goldilocks"): ("thaler_study_tpu_torch/csrc/gkr_tail.cu", "thaler_study_tpu/gkr/fused.py:318"),
    }
    for (name, backend), (source, replaces) in fused_sources.items():
        ms, plain_ms, bound_ms, *floor = gkr_timing[backend][name]
        row = {
            "name": f"{name}_{backend}", "route": "cuda", "source": source, "replaces": replaces,
            "launches": fused_launches[name] if backend == "goldilocks" else gkr_launches[backend][name],
            "max_abs_err": err[(name, backend)], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
        }
        if floor:
            row["latency_floor_ms"] = floor[0]
        kernels.append(row)
    # the one-program forms (CUDA graphs of the kernels above): launches =
    # replays on the main path's counted run; ms = the replayed dispatch or
    # proof (host clock, ends in its host read; the GKR proof after the
    # forward pass); plain_ms = the same launches issued from Python (the
    # eager route); bound_ms = the device busy time of a traced replay (the
    # union of its device records), so ms / bound_ms - 1 is the host's share
    # left; max_abs_err = 0: replays byte-identical to the eager route
    for backend in ("goldilocks", "mont32"):
        ms, plain_ms, busy_ms, records = timing[backend]["program"]
        kernels.append({
            "name": f"fs_batch_program_{backend}", "route": "cuda",
            "source": "thaler_study_tpu_torch/ops/fs_kernel.py", "replaces": "thaler_study_tpu/ops/fs_kernel.py:337",
            "launches": launches[backend]["fs_batch_program"], "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": busy_ms, "bound_by": "bytes", "bound_is": "device busy time of a traced replay",
            "device_records": records, "library_ms": None,
        })
    ms, plain_ms, busy_ms, records = fused_program
    kernels.append({
        "name": "gkr_fused_program_goldilocks", "route": "cuda", "source": "thaler_study_tpu_torch/gkr/fused.py",
        "replaces": "thaler_study_tpu/gkr/fused.py:398", "launches": fused_launches["gkr_fused_program"],
        "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": busy_ms, "bound_by": "bytes",
        "bound_is": "device busy time of a traced replay", "device_records": records, "library_ms": None,
    })
    kernels += slice_rows + slice14_rows
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
