#!/usr/bin/env python3
"""Time K1 (the round kernel's LibraW shapes), the other mont32.cuh rows and the GKR provers on one card, for the checkout at --root.

Usage, on a machine with a card:

    python3 scripts/k1_times.py [--root DIR] [--gkr-depth 16] [--gkr-log 20] [--reps 5] [--diag]

Imports ``thaler_study_tpu_torch`` from ``--root`` (default: this checkout),
so that two checkouts, such as a commit and its parent, can be timed in
turns on one card; the helpers come from this checkout's ``chip_smoke.py``.
Prints log lines and one JSON line with:

- ``k1``: per field (Goldilocks, BabyBear) and LibraW phase, at 2^gkr-log
  entries with a fold and the claim shortcut, from CUDA graphs (20
  launches captured, replayed 5 times): the kernel (the tree's
  ``cuda_round.libra_round_sums`` where it has one, which finishes the
  round in its launch, else ``round_partials``); the round as
  ``round_kernel.round_step`` runs it on the per-layer path (the parent's
  adds its plain-torch sum of the partials and the claim's s(1)); and,
  where the tree has 16-byte accesses, the kernel over tables one word off
  16 bytes (its scalar path);
- ``mont32``: the other rows that use ``csrc/mont32.cuh``'s reduction, from
  CUDA graphs: the eq table with the dot (BabyBear, n = gkr-log), the
  tensor-core matmul at the 1024-node triangle's X round 0 (M = 512,
  N = K = 1024), the batch round kernel's round 1 (n = 22, B = 64) and K2
  phase 1 on the flagship's layer-0 wiring;
- ``gkr``: per field, the per-layer prover (``gkr.generate_gkr_transcript``)
  on the flagship circuit (``chip_smoke.gate_circuit`` at gkr-depth x
  2^gkr-log gates from seed 42; Goldilocks inputs as the benchmark draws
  them, BabyBear ones below p from ``chip_smoke.field_inputs``): one warm
  proof, then --reps timed ones (host clock, each ending in its host
  read) and their median, every proof's bytes the first one's; and one
  proof with its middle layer traced (``chip_smoke.gkr_layer_trace``: the
  idle share, the plain-torch kernels per sumcheck round); and the fused
  prover over Goldilocks the same way, with K1's round-tail launches
  summed in a traced proof (``chip_smoke.fused_trace``) and by inner
  round (``chip_smoke.tail_by_round``);
- with ``--diag``, ``diag``: the K1 mont32 instantiation (phase 1, fold,
  skip-1, no tail) in the SASS of the tree's build (``cuobjdump -sass``):
  its instructions and calls (the emulated 64-bit division's subroutine),
  then again in a diagnostic build of the tree's ``round_kernel.cu`` with
  ``m32::acc_reduce`` stubbed out (made in a temporary directory and
  deleted; its sums are wrong), and that build's K1 time at the same
  shape: what the reduction costs.

Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SEED = 42


def sass_counts(lib: str) -> dict:
    """Instructions and CALLs of the K1 mont32 instantiation (phase 1, fold,
    skip-1, no tail) in ``lib``'s SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], check=True, capture_output=True, text=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)[1:]
    body = next((f for f in funcs if all(x in f.split("\n", 1)[0] for x in
                                        ("libra_round_kernel", "M32Ops", "Li1ELb1ELb1ELb0E"))), None)
    if body is None:
        raise AssertionError(f"no K1 mont32 instantiation in the SASS of {lib}")
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
    ops = [o for o in ops if not o.startswith("NOP")]
    return {"instructions": len(ops), "calls": sum(o.startswith("CALL") for o in ops),
            "imad": sum(o.startswith("IMAD") for o in ops)}


def stubbed_build(csrc: Path, out: Path) -> None:
    """``round_kernel.cu`` built with ``m32::acc_reduce`` returning a word of
    its accumulator (no reduction), into ``out``."""
    from thaler_study_tpu_torch import _build

    work = out.parent / "csrc"
    shutil.copytree(csrc, work)
    header = work / "mont32.cuh"
    text = header.read_text()
    head = "acc_reduce(const Field& f, const Acc& a) {"
    start = text.index(head) + len(head)
    end = text.index("\n}\n", start)
    header.write_text(text[:start] + "\n  return (uint32_t)(a.lo ^ a.hi) & 0xffffffu;" + text[end:])
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(work / "round_kernel.cu")],
                   check=True, capture_output=True, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout to import")
    ap.add_argument("--gkr-depth", type=int, default=16, help="layers of the flagship circuit")
    ap.add_argument("--gkr-log", type=int, default=20, help="log2 of the flagship circuit's width")
    ap.add_argument("--reps", type=int, default=5, help="timed proofs per field")
    ap.add_argument("--diag", action="store_true", help="the SASS counts and the stubbed-reduction build")
    args = ap.parse_args(argv)
    spec_ = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_times: torch.cuda.is_available() is false; no result", file=sys.stderr)
        return 1
    from thaler_study_tpu_torch import _build, gkr
    from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray
    from thaler_study_tpu_torch.fields.farray import word_dtype
    from thaler_study_tpu_torch.gkr import device_tables
    from thaler_study_tpu_torch.ops import cuda_round, modmatmul
    from thaler_study_tpu_torch.ops import round_kernel as rk

    _build.build()
    card = smoke.card_line()
    tag = f"[{card}]"
    dev = torch.device("cuda")
    new = hasattr(cuda_round, "libra_round_sums")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def words(field, *shape):
        hi = field.p if field.backend == "mont32" else 1 << 62
        x = torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int64)
        return x.to(word_dtype(field))

    def graph_ms(fn, count=20):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(count):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            graph.replay()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / 5 / count

    out = {"root": str(root), "card": card, "device": torch.cuda.get_device_name(0), "k1": {}, "mont32": {},
           "gkr": {}}
    k, N = args.gkr_log, 1 << args.gkr_log
    libra = ((1, cuda_round.LIBRA_PHASE1, 0), (2, cuda_round.LIBRA_PHASE2, 1))
    for field in (GOLDILOCKS, BABYBEAR):
        tables = [words(field, 1, N) for _ in range(3)]
        r1, claim, scalar = words(field, 1), words(field, 1), [words(field, 1)]
        outs = [torch.empty((1, N // 2), dtype=word_dtype(field), device=dev) for _ in range(3)]
        for phase, terms, n_scalars in libra:
            sc = scalar[:n_scalars]
            if new:
                def k1(tabs=tables):
                    cuda_round.libra_round_sums(tabs, r1, True, outs, field, terms, sc, claim)
            else:
                def k1(tabs=tables):
                    cuda_round.round_partials(tabs, r1, True, outs, field, terms, sc)
            spec = rk.PolySpec((k,), ((0,),) * 3 + ((),) * n_scalars, terms)
            ftabs = [FArray(t.reshape(-1), field) for t in tables] + [FArray(x, field) for x in sc]
            r_f, claim_f = FArray(r1.reshape(()), field), FArray(claim.reshape(()), field)
            row = {"kernel_ms": graph_ms(k1),
                   "round_ms": graph_ms(lambda: rk.round_step(spec, ftabs, r_f, claim=claim_f))}
            if new:
                off = [words(field, N + 1)[1:].view(1, N) for _ in range(3)]
                row["kernel_scalar_path_ms"] = graph_ms(lambda: k1(off))
            out["k1"][f"{field.name} phase {phase}"] = row
            log_row = ", ".join(f"{key} {v:.5f}" for key, v in row.items())
            smoke.log(f"{root.name} K1 {field.name} phase {phase} at 2^{k} (fold, claim, CUDA graphs): {log_row} {tag}")
        del tables, outs

    # the rows that use mont32.cuh's reduction
    F = BABYBEAR
    r_, w_ = FArray(words(F, k), F), FArray(words(F, N), F)
    out["mont32"]["eq_table_dot n=%d" % k] = graph_ms(lambda: device_tables.eq_table_dot(r_, w_, k))
    a, b, d = (words(F, 1024, 1024) for _ in range(3))
    planes = modmatmul.digit_planes(b, F)
    out["mont32"]["MM_TC 1024-node X round 0"] = graph_ms(
        lambda: modmatmul.contract_partials_tc(a, b, d, F, 2, planes), count=10)
    del a, b, d, planes
    data = [words(F, 64, 1 << 22) for _ in range(2)]
    rb = words(F, 64)
    outs_b = [torch.empty((64, 1 << 21), dtype=torch.int32, device=dev) for _ in range(2)]
    out["mont32"]["batch round kernel round 1 (n = 22, B = 64)"] = graph_ms(
        lambda: cuda_round.round_partials(data, rb, True, outs_b, F), count=5)
    del data, outs_b
    torch.cuda.empty_cache()

    grng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    circuit = smoke.gate_circuit(gkr, [N] * args.gkr_depth + [N], grng)
    construct_s = time.perf_counter() - t0
    gl_inputs = grng.integers(0, 1 << 62, N)
    wiring = circuit.device_wiring(0, dev)
    eq_r, table = FArray(words(F, len(circuit.layers[0])), F), FArray(words(F, N), F)
    out["mont32"]["K2 phase 1, flagship layer 0"] = graph_ms(
        lambda: device_tables.phase_tables(1, wiring, eq_r, table, k))
    del wiring, eq_r, table
    smoke.log(f"{root.name} mont32.cuh rows (CUDA graphs, ms): {out['mont32']} {tag}")
    for field, inputs in ((GOLDILOCKS, gl_inputs), (BABYBEAR, smoke.field_inputs(SEED, BABYBEAR, N))):
        first = gkr.generate_gkr_transcript(gkr.Prover(circuit, inputs, field), field).to_bytes()
        seconds = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t = gkr.generate_gkr_transcript(gkr.Prover(circuit, inputs, field), field)
            seconds.append(time.perf_counter() - t0)
            if t.to_bytes() != first:
                raise AssertionError("two proofs of one circuit differ")
        trace = smoke.gkr_layer_trace(circuit, inputs, field, args.gkr_depth // 2, tag)
        out["gkr"][field.name] = {"prove_s": seconds, "median_s": statistics.median(seconds),
                                  "idle": trace["idle"], "plain_per_round": trace["plain_per_round"],
                                  "copies_per_round": trace["copies_per_round"]}
        smoke.log(f"{root.name} GKR per-layer {field.name} {args.gkr_depth} x 2^{k}: prove median "
                  f"{statistics.median(seconds):.4f} s of {[round(x, 4) for x in seconds]} {tag}")
    # the fused prover (Goldilocks), whose inner rounds run K1 with the round tail
    gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, gl_inputs, GOLDILOCKS), GOLDILOCKS)
    seconds = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, gl_inputs, GOLDILOCKS), GOLDILOCKS)
        seconds.append(time.perf_counter() - t0)
    _, spans, busy_us, by_kernel, _ = smoke.fused_trace(gkr, circuit, gl_inputs, GOLDILOCKS)
    tail_ms, tail_n = by_kernel.get("libra_round_kernel TAIL", (0.0, 0))
    per_round = smoke.tail_by_round(spans, k, args.gkr_depth)
    out["gkr"]["Goldilocks fused"] = {"prove_s": seconds, "median_s": statistics.median(seconds),
                                      "busy_ms": busy_us / 1e3, "k1_tail_ms": tail_ms, "k1_tail_launches": tail_n,
                                      "k1_tail_us_by_round": per_round}
    smoke.log(f"{root.name} GKR fused Goldilocks {args.gkr_depth} x 2^{k}: prove median "
              f"{statistics.median(seconds):.4f} s of {[round(x, 4) for x in seconds]}; a traced proof's device "
              f"busy {busy_us / 1e3:.3f} ms, K1 with the round tail {tail_ms:.3f} ms over {tail_n}, by inner round "
              f"(us) {per_round and [round(x, 1) for x in per_round]} {tag}")
    out["gkr"]["circuit_construct_s"] = construct_s
    del circuit

    if args.diag:
        lib = str(_build._library_path("round_kernel"))
        diag = {"sass": sass_counts(lib)}
        with tempfile.TemporaryDirectory() as tmp:
            stub = Path(tmp) / "libround_kernel_stub.so"
            stubbed_build(_build.CSRC, stub)
            diag["sass_stubbed"] = sass_counts(str(stub))
            _build._loaded["round_kernel"] = ctypes.CDLL(str(stub))
            cuda_round._fns.clear()
            tables = [words(F, 1, N) for _ in range(3)]
            r1, claim = words(F, 1), words(F, 1)
            outs = [torch.empty((1, N // 2), dtype=torch.int32, device=dev) for _ in range(3)]
            if new:
                diag["stubbed_kernel_ms"] = graph_ms(
                    lambda: cuda_round.libra_round_sums(tables, r1, True, outs, F, cuda_round.LIBRA_PHASE1, [], claim))
            else:
                diag["stubbed_kernel_ms"] = graph_ms(
                    lambda: cuda_round.round_partials(tables, r1, True, outs, F, cuda_round.LIBRA_PHASE1))
            del _build._loaded["round_kernel"]
            cuda_round._fns.clear()
        out["diag"] = diag
        smoke.log(f"{root.name} K1 mont32 diagnostic (phase 1, fold, skip-1): {diag} {tag}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
