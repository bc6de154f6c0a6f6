#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

Usage, from the repository root on a machine with a card:

    python3 chip_smoke.py [--seed 42] [--n 22] [--batch 64] [--reps 5] [--mm-log 13]

The paths, each driven through the entry points a user calls:

- the batched Fiat-Shamir sumcheck prover
  (``protocols.batched.generate_transcripts_batch`` ->
  ``ops.fs_kernel.fs_prove_device_batch``): B whole proofs of a 2-factor
  product over a 2^n hypercube per dispatch, n = 22 and B = 64 by default,
  over Goldilocks (4.3 GB of tables on the card) and over BabyBear
  (2.15 GB);
- the matrix-multiplication IP entry point (``api.prove_matmul_entry`` /
  ``verify_matmul_entry``) on two 2^mm_log x 2^mm_log matrices made from the
  seed with numpy, 8192 x 8192 by default, over F5 and Goldilocks.

Phases, each ending in ``torch.cuda.synchronize()``:

1. device: card name and power limit; build both kernels with nvcc;
2. each kernel instantiation against its plain torch version on the card,
   on the same tensors, exactly (field values have no rounding): the round
   kernel over Goldilocks and over the mont32 fields BabyBear, F1572869,
   F389 and F5; the FS tail over the same five fields at every buffer fill
   (nbytes % 64 = 0..63), degree 2 and 3, round 0 / middle / last, its
   transcript bytes included; the SHA-256 chain helper against Python;
3. each path at full size, with the launch counts set to 0 just before it
   and read just after: per field, instances 0 and B - 1 byte-identical to
   the plain path on CPU copies, accepted by the verifier and rejected when
   tampered, and a batch with an all-zero factor in one instance; the
   matmul entry against the product entry computed with Python ints, the
   verifier, a tampered transcript, and a smaller entry against the same
   call on the CPU;
4. timing with CUDA events, a dependent host read and a profiler trace,
   and the FS tail's latency floor (one thread's chain of dependent SHA-256
   compressions, times the compressions on a round's chain);
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
    ap.add_argument("--mm-log", type=int, default=13, help="log2 of the matmul entry's matrix side")
    args = ap.parse_args(argv)
    jax_preloaded = "jax" in sys.modules

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result", file=sys.stderr)
        return 1

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from thaler_study_tpu_torch import _build, api
    from thaler_study_tpu_torch.fiat_shamir import (
        FiatShamirTranscript,
        SerializationError,
        SumcheckInteractiveProver,
        SumcheckInteractiveVerifier,
        XmdChain,
        generate_transcript,
        verify_transcript,
    )
    from thaler_study_tpu_torch.fields import BABYBEAR, F5, F389, F1572869, GOLDILOCKS, FArray
    from thaler_study_tpu_torch.fields import goldilocks as gl
    from thaler_study_tpu_torch.fields.farray import tensor_u64, word_dtype
    from thaler_study_tpu_torch.ops import cuda_round, fs_kernel
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
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"built {sorted(_build.SOURCES)} in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Function properties for" in line or "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
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

    # ---- phase 3: the paths at full size -----------------------------
    def reset_counts():
        for counts in (cuda_round.launches, fs_kernel.launches):
            for key in counts:
                counts[key] = 0

    def read_counts():
        return {"round_kernel": dict(cuda_round.launches), "fs_tail": dict(fs_kernel.launches)}

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
        if launches != {"round_kernel": n, "fs_tail": n} or sum(sum(v.values()) for v in counts.values()) != 2 * n:
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
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
