#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Usage, from the repository root on a machine with a card:

    python3 chip_smoke.py [--seed 42] [--n 22] [--batch 64] [--reps 5]

The main path is the batched Fiat-Shamir sumcheck prover
(``protocols.batched.generate_transcripts_batch`` ->
``ops.fs_kernel.fs_prove_device_batch``): B whole proofs of a 2-factor
Goldilocks product over a 2^n hypercube per dispatch, n = 22 and B = 64 by
default (4.3 GB of tables on the card).

Phases, each ending in ``torch.cuda.synchronize()``:

1. device: card name and power limit; build both kernels with nvcc;
2. each kernel against its plain torch version on the card, on the same
   tensors, exactly (field values have no rounding);
3. the main path at full size: launch counts, 2 instances byte-identical
   to the plain path on CPU copies, accepted by the verifier and rejected
   when tampered; a batch with an all-zero factor in one instance;
4. timing with CUDA events and a dependent host read;
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42, help="numpy seed of the tables")
    ap.add_argument("--n", type=int, default=22, help="variables per proof")
    ap.add_argument("--batch", type=int, default=64, help="proofs per dispatch")
    ap.add_argument("--reps", type=int, default=5, help="timed dispatches")
    args = ap.parse_args(argv)
    jax_preloaded = "jax" in sys.modules

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result", file=sys.stderr)
        return 1

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from thaler_study_tpu_torch import _build
    from thaler_study_tpu_torch.fiat_shamir import (
        FiatShamirTranscript,
        SerializationError,
        SumcheckInteractiveProver,
        SumcheckInteractiveVerifier,
        generate_transcript,
        verify_transcript,
    )
    from thaler_study_tpu_torch.fields import GOLDILOCKS, FArray
    from thaler_study_tpu_torch.fields import goldilocks as gl
    from thaler_study_tpu_torch.fields.farray import tensor_u64, u64_tensor
    from thaler_study_tpu_torch.ops import cuda_round, fs_kernel
    from thaler_study_tpu_torch.ops.round_kernel import single_block_spec
    from thaler_study_tpu_torch.ops.sha_chain import DevChain
    from thaler_study_tpu_torch.protocols import (
        BatchedProductPoly,
        ProductPoly,
        generate_transcripts_batch,
    )
    from thaler_study_tpu_torch.sumcheck import Prover, SumCheckError, Verifier
    from thaler_study_tpu_torch.utils.counters import COUNTS, count_round

    F = GOLDILOCKS
    P = F.p
    dev = torch.device("cuda")
    n, B = args.n, args.batch

    # ---- phase 1: device and build -----------------------------------
    card = card_line()
    log(card)
    tag = f"[{card}]"
    count = torch.cuda.device_count()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (count {count}), torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"built {sorted(_build.SOURCES)} in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    torch.cuda.synchronize()

    # ---- phase 2: kernels against their plain versions ---------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    boundary = torch.tensor(
        [gl.to_i64(v) for v in (0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
                                1 << 63, (1 << 63) - 1, (1 << 64) - (1 << 32))],
        dtype=torch.int64, device=dev,
    )

    def rand(*shape):
        """Canonical values < p (hi word <= 2^32 - 2), boundary values first."""
        lo = torch.randint(0, 1 << 32, shape, generator=gen, device=dev, dtype=torch.int64)
        hi = torch.randint(0, (1 << 32) - 1, shape, generator=gen, device=dev, dtype=torch.int64)
        x = (hi << 32) | lo
        m = min(x.numel(), boundary.numel())
        x.view(-1)[:m] = boundary[:m]
        return x

    def max_abs_err(a, b) -> int:
        if torch.equal(a, b):
            return 0
        diff = (a != b).nonzero()[:64]
        ua, ub = tensor_u64(a[tuple(diff.T)]), tensor_u64(b[tuple(diff.T)])
        return max(abs(int(x) - int(y)) for x, y in zip(ua, ub))

    err = {"round_kernel": 0, "fs_tail": 0}
    checks = 0
    for k in (2, 3):
        for size in (4, 8, 1 << 12, 1 << n):
            tables = [rand(B, size) for _ in range(k)]
            r = rand(B)
            for fold, skip in ((False, False), (False, True), (True, False), (True, True)):
                rr = r if fold else None
                folded, parts = cuda_round.round_partials(tables, rr, skip_t1=skip)
                ref_folded, ref = cuda_round.round_partials_plain(tables, rr, skip, parts.shape[1])
                torch.cuda.synchronize()
                e = max_abs_err(parts, ref)
                if fold:
                    e = max([e] + [max_abs_err(a, b) for a, b in zip(folded, ref_folded)])
                if e:
                    raise AssertionError(f"round kernel != plain: k={k} N={size} fold={fold} skip={skip}")
                err["round_kernel"] = max(err["round_kernel"], e)
                checks += 1
            del tables, folded, ref_folded, parts, ref
    torch.cuda.empty_cache()
    log(f"round kernel == plain (exact) in {checks} cases: k in (2, 3), N in (4, 8, 2^12, 2^{n}), "
        f"B = {B}, all four modes")

    def tail_case(degree, round_idx, draw, nbytes):
        blocks = cuda_round.blocks_for(B, 1 << (n - 2))
        parts = rand(B, blocks, degree + 1)
        claim = rand(B)
        parts[3] = 0  # proof 3: all sums zero -> zero coefficients -> flagged
        claim[3] = 0
        chain = DevChain.fresh(B, dev)
        chain.state.copy_(torch.randint(-(1 << 31), 1 << 31, (B, 8), generator=gen, device=dev,
                                        dtype=torch.int64).to(torch.int32))
        fill = nbytes % 64
        chain.buf[:, :fill] = torch.randint(0, 256, (B, fill), generator=gen, device=dev,
                                            dtype=torch.int64).to(torch.uint8)
        chain.nbytes = nbytes
        vinv = u64_tensor(
            np.array(fs_kernel._interp_matrix(degree, P), dtype=np.uint64).reshape(-1), dev)
        state = [chain, claim, rand(B), rand(B), rand(B, n * (degree + 1)),
                 torch.zeros(B, dtype=torch.int32, device=dev), vinv]
        return parts, state

    def clone_state(state):
        chain, *rest = state
        return [DevChain(chain.state.clone(), chain.buf.clone(), chain.nbytes)] + [t.clone() for t in rest]

    tail_cases = [(2, 0, True, 0), (2, 5, True, 1000), (3, 9, True, 1210), (2, 21, False, 1170)]
    for degree, round_idx, draw, nbytes in tail_cases:
        parts, kstate = tail_case(degree, round_idx, draw, nbytes)
        pstate = clone_state(kstate)
        off = (degree + 1) * min(round_idx, n - 1)
        fs_kernel.fs_tail(parts, *kstate, round_idx, off, draw)
        fs_kernel.fs_tail_plain(parts, *pstate, round_idx, off, draw)
        torch.cuda.synchronize()
        kc, pc = kstate[0], pstate[0]
        outs = [(kc.state, pc.state), (kc.buf, pc.buf)] + list(zip(kstate[1:6], pstate[1:6]))
        e = max(max_abs_err(a.to(torch.int64), b.to(torch.int64)) for a, b in outs)
        if e:
            raise AssertionError(f"FS tail kernel != plain: degree={degree} round={round_idx}")
        err["fs_tail"] = max(err["fs_tail"], e)
        if int(kstate[5][3]) != 1:
            raise AssertionError("FS tail kernel did not flag proof 3's zero coefficients")
    log(f"FS tail kernel == plain (exact) in {len(tail_cases)} cases: B = {B}, degree 2 and 3, "
        "round 0 / middle / last, one proof with zero coefficients")

    # ---- phase 3: the main path at full size -------------------------
    rng = np.random.default_rng(args.seed)
    tables = []
    for _ in range(2):
        lo = rng.integers(0, 1 << 32, size=(B, 1 << n), dtype=np.uint32)
        hi = rng.integers(0, 1 << 31, size=(B, 1 << n), dtype=np.uint32)
        tables.append(FArray.from_jax_limbs(lo, hi, device=dev))
        del lo, hi
    spec = single_block_spec(2, n)
    poly = BatchedProductPoly(tables)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_round.launches = 0
    fs_kernel.launches = 0
    ts = generate_transcripts_batch(poly, F)
    launches = {"round_kernel": cuda_round.launches, "fs_tail": fs_kernel.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"round_kernel": n, "fs_tail": n}:
        raise AssertionError(f"expected {n} launches of each kernel per dispatch, got {launches}")
    if len(ts) != B or any(len(t.g) != n for t in ts):
        raise AssertionError("wrong transcript shape")
    if any(len(t.g[0]) != 64 or any(len(m) != 56 for m in t.g[1:]) for t in ts):
        raise AssertionError("a transcript has a message of the wrong length")
    log(f"main path: {B} proofs x n = {n}: launches {launches} per dispatch; "
        f"peak device memory {peak_gb:.3f} GB {tag}")

    idx = [0, B - 1]
    cpu_tables = [FArray(t.data[idx].cpu(), F) for t in tables]
    t0 = time.perf_counter()
    ts_cpu = generate_transcripts_batch(BatchedProductPoly(cpu_tables), F)
    cpu_s = time.perf_counter() - t0
    for j, i in enumerate(idx):
        if ts_cpu[j].to_bytes() != ts[i].to_bytes():
            raise AssertionError(f"instance {i}: card transcript != plain CPU path")
        inst = [FArray(t.data[j], F) for t in cpu_tables]
        v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, inst)), F)
        if not verify_transcript(ts[i], v, F):
            raise AssertionError(f"instance {i}: the verifier rejected an honest transcript")
        bad = [bytearray(m) for m in ts[i].g]
        bad[1][16] ^= 1  # lowest byte of round 1's first coefficient
        v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, inst)), F)
        try:
            accepted = verify_transcript(FiatShamirTranscript([bytes(m) for m in bad]), v, F)
        except (SumCheckError, SerializationError):
            accepted = False
        if accepted:
            raise AssertionError(f"instance {i}: a tampered transcript was accepted")
    log(f"instances {idx}: byte-identical to the plain path on CPU copies ({cpu_s:.2f} s on the host), "
        "accepted by verify_transcript with a CPU oracle, rejected with one byte flipped")

    z = 5
    zdata = tables[0].data.clone()
    zdata[z] = 0
    ztables = [FArray(zdata, F), tables[1]]
    out = fs_kernel.fs_prove_device_batch(spec, ztables)
    if out[z] is not None or any(out[i] != ts[i].g for i in range(B) if i != z):
        raise AssertionError("zero batch: wrong per-instance fallback decision or results")
    ts_z = generate_transcripts_batch(BatchedProductPoly(ztables), F)
    zcpu = [FArray(t.data[z].cpu(), F) for t in ztables]
    host = generate_transcript(SumcheckInteractiveProver(Prover(ProductPoly(spec, zcpu))), F)
    if ts_z[z].to_bytes() != host.to_bytes():
        raise AssertionError("zero batch: fallback transcript != CPU host loop")
    if any(ts_z[i].to_bytes() != ts[i].to_bytes() for i in range(B) if i != z):
        raise AssertionError("zero batch: the other instances lost their fused result")
    v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, zcpu)), F)
    if not verify_transcript(ts_z[z], v, F):
        raise AssertionError("zero batch: the fallback transcript was rejected")
    del zdata, ztables, out, ts_z
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"zero batch: instance {z} took the host fallback (== CPU host loop, accepted); "
        f"the other {B - 1} kept the fused result")

    # ---- phase 4: timing ---------------------------------------------
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

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    generate_transcripts_batch(poly, F)  # warm
    host_ms, dev_ms = [], []
    for _ in range(args.reps):
        e0, e1 = events()
        e0.record()
        t0 = time.perf_counter()
        ts_t = generate_transcripts_batch(poly, F)  # ends in its host read
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
    dispatch_bytes = 2 * B * 8 * ((1 << n) + sum((1 << (n - j + 1)) + (1 << (n - j)) for j in range(1, n)))
    log(f"dispatch: {dispatch_ms:.3f} ms median of {args.reps} (host clock, ends in the host read; "
        f"all {[round(x, 3) for x in host_ms]}), CUDA events {statistics.median(dev_ms):.3f} ms; "
        f"proof_ms {dispatch_ms / B:.4f}; bound {dispatch_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms "
        f"({dispatch_bytes / 1e9:.2f} GB at 3.35 TB/s) {tag}")
    log(json.dumps({
        "metric": "fs_sumcheck_whole_proof_field_ops_per_s",
        "value": ops_per_s,
        "unit": "field_ops/s",
        "detail": {
            "field": "goldilocks(2^64-2^32+1)", "hypercube_points": 1 << n, "batch": B,
            "rounds_per_proof": n, "field_ops_per_proof": ops_per_proof,
            "kernel_actual_field_ops": kernel_ops_per_proof, "proof_ms": dispatch_ms / B,
            "dispatch_ms": dispatch_ms, "reps": args.reps, "card": card,
        },
    }))

    # the host's own share after the read: assembling B x n messages' bytes
    coeff_rows = np.random.default_rng(args.seed).integers(0, P, size=(B, 1 + 3 * n), dtype=np.uint64)
    degrees = spec.round_degrees()
    asm_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        for row in coeff_rows:
            fs_kernel._assemble_msgs(int(row[0]), row[1:].tolist(), degrees, F.byte_size)
        asm_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"host byte assembly of {B} x {n} messages (after the read, device idle): "
        f"{statistics.median(asm_ms):.3f} ms median of 5 {tag}")

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

    # kernel 1 at the round-1 shape (fold + claim shortcut), and its plain version
    data = [t.data for t in tables]
    r1 = rand(B)
    outs = [torch.empty((B, 1 << (n - 1)), dtype=torch.int64, device=dev) for _ in data]
    blocks1 = cuda_round.blocks_for(B, 1 << (n - 2))
    k1_ms = time_launches(lambda: cuda_round.round_partials(data, r1, skip_t1=True, out=outs), 20)
    k1_plain_ms = time_launches(lambda: cuda_round.round_partials_plain(data, r1, True, blocks1), 3)
    k1_bytes = B * (2 * (1 << n) * 8 + 2 * (1 << (n - 1)) * 8 + 8) + B * blocks1 * 3 * 8
    k1_bound = k1_bytes / PEAK_BYTES_PER_S * 1e3
    k0_ms = time_launches(lambda: cuda_round.round_partials(data), 20)
    k0_bound = (B * 2 * (1 << n) * 8) / PEAK_BYTES_PER_S * 1e3
    log(f"round kernel, round-1 shape (B={B}, N=2^{n}, fold + claim): {k1_ms:.4f} ms, "
        f"bound {k1_bound:.4f} ms ({k1_bytes / 1e9:.3f} GB), {k1_bound / k1_ms:.1%} of the bound; "
        f"plain torch {k1_plain_ms:.3f} ms; no single PyTorch call computes a Goldilocks fold + sum {tag}")
    log(f"round kernel, round-0 shape (no fold): {k0_ms:.4f} ms, bound {k0_bound:.4f} ms {tag}")
    per_round = [k0_ms]
    for j in range(1, n):
        size = 1 << (n - j + 1)
        tj = [t[:, :size].contiguous() for t in data]
        oj = [o[:, : size // 2].contiguous() for o in outs]
        per_round.append(time_launches(lambda: cuda_round.round_partials(tj, r1, skip_t1=True, out=oj), 5))
    del outs, tj, oj

    parts, kstate = tail_case(2, 5, True, 1000)
    k2_ms = time_launches(lambda: fs_kernel.fs_tail(parts, *kstate, 5, 15, True), 100)
    k2_plain_ms = time_launches(lambda: fs_kernel.fs_tail_plain(parts, *kstate, 5, 15, True), 3)
    k2_bytes = (parts.numel() * 8 + B * (2 * 32 + 2 * 64 + 2 * 8 + 8 + 3 * 8 + 2 * 4) + 9 * 8)
    k2_bound = k2_bytes / PEAK_BYTES_PER_S * 1e3
    device_ms = sum(per_round) + n * k2_ms
    log(f"FS tail kernel (B={B}, degree 2, {parts.shape[1]} partials per proof): {k2_ms:.4f} ms per launch, "
        f"bound {k2_bound:.6f} ms ({k2_bytes} B); plain (Python ints) {k2_plain_ms:.3f} ms {tag}")
    log(f"per dispatch, kernels timed one shape at a time: round kernel {sum(per_round):.3f} ms over "
        f"{n} launches (rounds 0-3: {[round(x, 4) for x in per_round[:4]]}), FS tail {n * k2_ms:.3f} ms; "
        f"sum {device_ms:.3f} of {dispatch_ms:.3f} ms dispatch -> 1 - sum / dispatch = "
        f"{1 - device_ms / dispatch_ms:.1%} {tag}")

    # device busy time inside one dispatch, from the CUPTI records of a trace
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        generate_transcripts_batch(poly, F)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s0, s1, _ in spans:
        if s1 > end:
            busy_us += s1 - max(s0, end)
            end = s1
    per_kernel = {}
    for key in ("round_kernel", "fs_tail_kernel"):
        mine = [s1 - s0 for s0, s1, name in spans if key in name]
        per_kernel[key] = (sum(mine) / 1e3, len(mine))
    if spans:
        busy_ms = busy_us / 1e3
        log(f"profiler trace of one dispatch: device busy {busy_ms:.3f} ms (union of {len(spans)} device "
            f"records; round kernel {per_kernel['round_kernel'][0]:.3f} ms over "
            f"{per_kernel['round_kernel'][1]} launches, FS tail {per_kernel['fs_tail_kernel'][0]:.4f} ms over "
            f"{per_kernel['fs_tail_kernel'][1]}) against the {dispatch_ms:.3f} ms dispatch -> device idle "
            f"share {1 - busy_ms / dispatch_ms:.1%} {tag}")
    else:
        log("profiler trace of one dispatch: no device records, device idle share not measured")

    # ---- phase 5: summary lines --------------------------------------
    if "thaler_study_tpu" in sys.modules or (not jax_preloaded and "jax" in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    kernels = [
        {"name": "round_kernel", "route": "cuda",
         "source": "thaler_study_tpu_torch/csrc/round_kernel.cu",
         "replaces": "thaler_study_tpu/ops/pallas_round.py:341",
         "launches": launches["round_kernel"], "max_abs_err": err["round_kernel"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": "bytes",
         "library_ms": None},
        {"name": "fs_tail", "route": "cuda",
         "source": "thaler_study_tpu_torch/csrc/fs_tail.cu",
         "replaces": "thaler_study_tpu/ops/fs_kernel.py:220",
         "launches": launches["fs_tail"], "max_abs_err": err["fs_tail"],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": "bytes",
         "library_ms": None},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
