#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

Usage, from the repository root on a machine with a card:

    python3 chip_smoke.py [--seed 42] [--n 22] [--batch 64] [--reps 5] [--mm-log 13]
                          [--gkr-depth 16] [--gkr-log 20] [--fused-trace-only]

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
  benchmark draws them; and ``api.run_gkr`` with ``generate_gkr_transcript``
  on the book circuit (F389) and a 5-layer mixed-width circuit (Goldilocks
  and BabyBear);
- the fused GKR prover (``gkr.generate_gkr_transcript_fused``) on two small
  Goldilocks circuits and on the flagship.

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
   at several sizes, and the phase-table kernel (K2, over its static plan)
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
   (2, 3, 10, 20) x every fill;
3. each path at full size, with the launch counts set to 0 just before it
   and read just after: per field, instances 0 and B - 1 byte-identical to
   the plain path on CPU copies, accepted by the verifier and rejected when
   tampered, and a batch with an all-zero factor in one instance; the
   matmul entry against the product entry computed with Python ints, the
   verifier, a tampered transcript, and a smaller entry against the same
   call on the CPU; the GKR circuits: the small ones byte-identical to
   ``device="cpu"`` through both entry points, the flagship's outputs equal
   to the plain forward pass on the CPU, accepted by the verifier and
   rejected when tampered; the fused path byte-identical to ``device="cpu"``
   and to the per-layer path (small circuits) and to the per-layer run
   (flagship), with no fallback and the launch counts of its design;
4. timing with CUDA events, a dependent host read and a profiler trace,
   and the FS tail's latency floor (one thread's chain of dependent SHA-256
   compressions, times the compressions on a round's chain); for GKR, the
   proof's seconds with a breakdown by step, the device idle share from a
   trace of one layer, and K1 and K2 at the flagship's shapes; for the
   fused path, the median of warm proofs, its ``timings`` breakdown, the
   prelude's parts, a trace of one proof (device idle share, one
   device-to-host read after the prelude, no standalone round tail, the
   plain-torch time by aten op), and its kernels at the flagship's shapes
   (K1 with TAIL beside K1 alone; the eq table, the eq table with the dot
   and the line restriction);
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


def device_spans(prof):
    """The device records of a trace, sorted, and the microseconds their
    union covers."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
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


# the fused proof's device records by kernel (the first match of a name);
# line_fold_kernel is the line restriction of trees before the tiles
FUSED_KERNELS = ("libra_round_kernel", "phase_tables_kernel", "eq_table_kernel", "line_tile_kernel",
                 "line_fold_kernel", "gkr_final_tail_kernel", "Memcpy DtoH", "Memcpy HtoD")


def template_flag(name: str, kernel: str) -> bool:
    """Whether the last template argument of ``kernel`` in a record's name
    is true (K1's TAIL, the eq table's DOT)."""
    return name.split(kernel + "<", 1)[-1].split(">", 1)[0].endswith("true")


def fused_trace(gkr, circuit, inputs, field):
    """One fused proof of a fresh prover under the profiler: (wall ms,
    device records, busy us, device ms by kernel label, aten split)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prover = gkr.Prover(circuit, inputs, field)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gkr.generate_gkr_transcript_fused(prover, field)
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
    from thaler_study_tpu_torch.ops import cuda_round, fs_kernel, gkr_tail, sha_chain
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
    log(f"built {sorted(_build.SOURCES)} in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
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
                "libra_round_tail": gkr_tail.tail_launches, "gkr_final_tail": gkr_tail.final_launches}

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
        reset_counts()
        ts = generate_transcripts_batch(poly, field)
        counts = read_counts()
        launches = {k: v[field.backend] for k, v in counts.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = dict.fromkeys(counters, 0)
        want.update(round_kernel=n, fs_tail=n)
        if launches != want or sum(sum(v.values()) for v in counts.values()) != 2 * n:
            raise AssertionError(f"{field.name}: expected {n} launches of each kernel per dispatch, got {counts}")
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

    # ---- phase 4: timing ---------------------------------------------
    def compressions(nbytes, m, draw):
        """SHA-256 compressions on one proof's chain in a round: the absorb's
        full blocks, then b_0's closing blocks and b_1."""
        end = nbytes % 64 + m
        return end // 64 + ((1 if end % 64 + 5 <= 56 else 2) + 1 if draw else 0)

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

        # device busy time inside one dispatch, from the CUPTI records of a trace
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            generate_transcripts_batch(poly, field)
        spans, busy_us = device_spans(prof)
        per_kernel = {}
        for key in ("round_kernel", "fs_tail_kernel"):
            mine = [s1 - s0 for s0, s1, name in spans if key in name]
            per_kernel[key] = (sum(mine) / 1e3, len(mine))
        if spans:
            busy_ms = busy_us / 1e3
            tail_ms, tail_n = per_kernel["fs_tail_kernel"]
            log(f"{field.name} profiler trace of one dispatch: device busy {busy_ms:.3f} ms (union of {len(spans)} "
                f"device records; round kernel {per_kernel['round_kernel'][0]:.3f} ms over "
                f"{per_kernel['round_kernel'][1]} launches, FS tail {tail_ms:.4f} ms over {tail_n}, "
                f"{tail_ms / max(tail_n, 1) * 1e3:.2f} us each) against the {dispatch_ms:.3f} ms dispatch -> device "
                f"idle share {1 - busy_ms / dispatch_ms:.1%} {tag}")
        else:
            log(f"{field.name} profiler trace of one dispatch: no device records, device idle share not measured")
        return {"round_kernel": (k1_ms, k1_plain_ms, k1_bound), "fs_tail": (k2_ms, k2_plain_ms, k2_bound, k2_floor)}

    # the latency floor: one thread's chain of dependent compressions; the
    # difference of two chain lengths takes the launch out
    chain_ms = {c: time_launches(lambda: fs_kernel.sha_chain(c, chain_out), 5) for c in (1024, 2048)}
    compress_ms = (chain_ms[2048] - chain_ms[1024]) / 1024
    log(f"SHA-256 compression latency (one thread, dependent chain): {compress_ms * 1e6:.1f} ns "
        f"({chain_ms[1024]:.4f} ms for 1024, {chain_ms[2048]:.4f} ms for 2048) {tag}")

    launches, timing = {}, {}
    for field, label in ((GOLDILOCKS, "goldilocks(2^64-2^32+1)"), (BABYBEAR, "babybear(2^31-2^27+1)")):
        tables, poly, ts, launches[field.backend] = batch_path(field)
        timing[field.backend] = time_batch_path(field, tables, poly, ts, label)
        del tables, poly, ts
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
        if counts["round_kernel"][field.backend] != L or sum(counts["fs_tail"].values()):
            raise AssertionError(f"matmul {field.name}: expected {L} round kernel launches, got {counts}")
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
        del a, b, g, prover

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
        the dot (phase 2); on the fused path 2k - 1 of the 2k K1 launches
        carry the round tail (TAIL), and one final tail and the line
        restriction's launches (one at k = 20) follow."""
        ks = [circuit.num_vars_at(i + 1) for i in range(len(circuit.layers))]
        want = {"libra_round": sum(2 * k for k in ks), "phase_tables": 2 * len(ks), "eq_table": len(ks),
                "eq_table_dot": len(ks)}
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
        want = {name: {b: 0 for b in ("goldilocks", "mont32")} for name in counters}
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

    # the fused path on the flagship: the same bytes as the per-layer run,
    # every layer's rounds on the card, one device-to-host read after the
    # prelude
    fused_keys = ("libra_round", "libra_round_tail", "phase_tables", "eq_table", "eq_table_dot", "line_restrict",
                  "gkr_final_tail")
    torch.cuda.synchronize()
    reset_counts()
    f0 = gkr_fused.fallbacks
    t0 = time.perf_counter()
    fused_t = gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, F), F)
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
    log(f"GKR flagship fused: generate_gkr_transcript_fused byte-identical to the per-layer transcript, no fallback, "
        f"launches {fused_launches} (first run {fused_first_s:.3f} s with the prover's forward pass); "
        f"verify_gkr_transcript accepted in {fused_verify_s:.3f} s; rejected with one byte flipped in final "
        f"message {flip_f} {tag}")

    # warm proofs: host clock around Prover (the forward pass) + the fused
    # call, which ends in its host read; then the forward pass alone, the
    # timings breakdown (a sync after every step) and one traced proof
    fused_s = []
    for _ in range(max(3, args.reps)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, F), F)
        fused_s.append(time.perf_counter() - t0)
        if again.to_bytes() != transcript.to_bytes():
            raise AssertionError("GKR flagship: a warm fused proof differs")
    fwd_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gkr.Prover(circuit, inputs, F)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
    fwd_med = statistics.median(fwd_s)
    timings = []
    gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, F), F, timings=timings)
    parts = {name: sum(sec for n_, _, sec in timings if n_ == name)
             for name in ("prelude", "phase1", "phase2", "pull", "assemble")}
    per_layer_ms = [1e3 * sum(sec for n_, i_, sec in timings if i_ == i and n_ in ("phase1", "phase2"))
                    for i in range(depth)]
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
    traced_ms, spans, busy_us, fused_kernels, fused_aten = fused_trace(gkr, circuit, inputs, F)
    if any("gkr_round_tail" in name for _, _, name in spans):
        raise AssertionError("GKR flagship fused: a standalone round-tail kernel ran")
    # the TAIL launches by inner round (2k - 1 per layer, in issue order),
    # grouped by table size: rounds 0-2 of each phase are the large ones
    tail_us = [s1 - s0 for s0, s1, name in spans
               if "libra_round_kernel<" in name and template_flag(name, "libra_round_kernel")]
    k_f = circuit.num_vars_at(1)
    if spans and len(tail_us) == depth * (2 * k_f - 1):
        per_j = [statistics.mean(tail_us[j :: 2 * k_f - 1]) for j in range(2 * k_f - 1)]
        log(f"GKR flagship fused trace, K1 with TAIL by inner round (mean over {depth} layers, us): phase 1 "
            f"{[round(x, 1) for x in per_j[:k_f]]}; phase 2 {[round(x, 1) for x in per_j[k_f:]]} {tag}")
    layer_start = min((s0 for s0, _, name in spans if "eq_table_kernel" in name), default=None)
    copies = [(s0, name) for s0, _, name in spans if "Memcpy" in name]
    if copies and layer_start is not None:
        reads = [name for s0, name in copies if "DtoH" in name and s0 > layer_start]
        writes = [name for s0, name in copies if "HtoD" in name and s0 > layer_start]
        if len(reads) != 1:
            raise AssertionError(f"GKR flagship fused: {len(reads)} device-to-host reads after the prelude: {reads}")
        reads_note = (f"device-to-host copies after the prelude (the first eq-table kernel): {len(reads)} "
                      f"({reads[0]}); host-to-device copies after it: {len(writes)}")
    else:
        reads_note = "device-to-host copies: not measured (no copy records in the trace)"
    fused_idle = 1 - busy_us / 1e3 / traced_ms if spans else None
    log(f"GKR flagship fused, traced proof: {traced_ms:.3f} ms wall (profiler on), device busy {busy_us / 1e3:.3f} ms "
        f"(union of {len(spans)} device records; {split_line(fused_kernels, fused_aten)}); {reads_note}; "
        "device idle share " + (f"{fused_idle:.1%}" if spans else "not measured (no device records)") + f" {tag}")
    log(f"GKR flagship fused breakdown (a sync after every step): prelude {parts['prelude']:.4f} s, phase 1 "
        f"{parts['phase1']:.4f} s, phase 2 {parts['phase2']:.4f} s over {depth} layers (per layer "
        f"{min(per_layer_ms):.2f}-{max(per_layer_ms):.2f} ms), pull {parts['pull']:.4f} s, assemble "
        f"{parts['assemble']:.4f} s; forward pass {fwd_med:.4f} s (median of 3) {tag}")
    prove_med = statistics.median(fused_s)
    log(json.dumps({
        "bench": "gkr_prover_fused_noninteractive", "gates": depth * width, "depth": depth, "width": width,
        "field": F.name, "accepted": True, "prover_s": prove_med, "verifier_s": fused_verify_s,
        "messages": len(fused_t.g), "transcript_bytes": sum(len(m) for m in fused_t.g),
        "breakdown": {"forward_pass_s": fwd_med, "fused_layers_s": prove_med - fwd_med,
                      "phase1_s": parts["phase1"], "phase2_s": parts["phase2"], "prelude_s": parts["prelude"],
                      "assemble_s": parts["assemble"], "final_pull_s": parts["pull"]},
        "prover_s_all": fused_s, "reps": len(fused_s), "per_layer_path_prover_s": prove_s,
        "device_idle_share": fused_idle, "traced_ms": traced_ms, "device_records": len(spans),
        "device_busy_ms": busy_us / 1e3, "launches": fused_launches, "card": card,
    }))
    del transcript, timed_t, bad, fused_t, again

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
        blocks = cuda_round.blocks_for(1, N // 4)
        rows = {}
        for phase, terms, n_scalars in libra:
            sc = scalar[:n_scalars]

            def k1():
                cuda_round.round_partials(tables, r1, True, outs, field, terms, sc)

            issued_ms = time_launches(k1, 20)
            plain_ms = time_launches(lambda: cuda_round.round_partials_plain(tables, r1, True, blocks, field, terms, sc), 3)
            nbytes = 3 * (N + N // 2) * wb + (1 + n_scalars) * wb + blocks * 3 * wb
            rows[f"K1 phase {phase}"] = (graph_ms(k1), plain_ms, nbytes / PEAK_BYTES_PER_S * 1e3, nbytes, issued_ms)
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
            # K1's bytes; then the partials read again, the chain's state and
            # block and the zero flag read and written, the message written,
            # the claim read and written, one challenge written
            m_ = gkr_tail.ROUND_LEN
            tail_bytes = blocks * 3 * 8 + 2 * (32 + 64 + 4) + m_ + 3 * 8
            floor_ms = compressions(64 * 131072 + 40, m_, True) * compress_ms
            all_bytes = nbytes + tail_bytes
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
    del wiring, circuit
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
    # the GKR kernels: launches per proof (Goldilocks: the flagship; mont32:
    # the BabyBear 5-layer circuit), times at the flagship's shapes (phase 1)
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
    # eq tables over mont32: the BabyBear 5-layer per-layer proof); the line
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
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
