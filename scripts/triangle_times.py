#!/usr/bin/env python3
"""Time the triangle-counting IP's prover, the sharded proofs and the multi-block rounds on one card, for the checkout at --root.

Usage, on a machine with a card:

    python3 scripts/triangle_times.py [--root DIR] [--device-proofs] [--sharded-fs N] [--mb-shapes] [--no-api]

Imports ``thaler_study_tpu_torch`` from ``--root`` (default: this checkout),
so that two checkouts, such as a commit and its parent, can be timed in
turns on one card (run the script once per checkout, alternating). Builds
the checkout's kernels first. Proves ``chip_smoke.py``'s main-path graph
(its ``triangle_graph`` at ``TRI_NODES`` nodes, from seed 42, taken from
this checkout's ``chip_smoke.py``) over Goldilocks once to warm up and 5
more times with ``api.prove_triangle_count`` (host clock; a proof ends in
its host read), checks that every proof's claim and bytes are the first
one's (``--no-api`` leaves the timed proofs out). Each option adds a
part:

- ``--device-proofs``: the same proof through ``generate_transcript_device``
  unsharded and sharded over Z on ``chip_smoke.py``'s mesh
  (``SHARD_COUNT`` shards of the card, n_shard ``SHARD_VARS``), in turns,
  each byte-identical to the API's proof;
- ``--sharded-fs N``: the Fiat-Shamir proof of a 2-factor product over a
  2^N hypercube, ``fs_prove_device_sharded`` on the same mesh and
  ``fs_prove_device``, Goldilocks and BabyBear (random words from a seed),
  byte-identical, in turns;
- ``--mb-shapes``: the multi-block round kernel at its unsharded shapes of
  ``chip_smoke.py``'s table (the 4096-node triangle's X -> Y round, the
  round after it, the middle of the Y phase; dense W's first b round at 8
  x 2^11 gates), each held against its plain version and timed from a
  CUDA graph of 20 launches (median of 5 replays); with ptxas's registers
  and spills of each ``mb_round_kernel`` instantiation where this run
  built the library.

Proofs in turns: 5 timed runs each after one warm run, medians in ms.
Prints one JSON line, with the card's name and power limit; exits 1
without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SEED, REPS = 42, 5
TRI = ((0, 1), (1, 2), (0, 2))
W_BLOCKS = ((0, 1), (0, 1), (0,), (1,))
W_TERMS = ((0, 2), (0, 3), (1, 2, 3))


def in_turns(runs, sync, check):
    """Each run of ``runs`` (name -> function) once to warm up and REPS
    more times, in turns; ``check(name, result)`` on every result. The
    host-clock milliseconds and their medians."""
    ms = {name: [] for name in runs}
    for i in range(REPS + 1):
        for name, run in runs.items():
            sync()
            t0 = time.perf_counter()
            got = run()
            sync()
            if i:
                ms[name].append((time.perf_counter() - t0) * 1e3)
            check(name, got)
    return {name: {"ms": v, "median_ms": statistics.median(v)} for name, v in ms.items()}


def graph_ms(fn, sync, count=20):
    """Milliseconds per call of ``fn`` from a CUDA graph of ``count`` calls:
    the median of 5 replays."""
    import torch

    fn()
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            fn()
    out = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        sync()
        out.append(a.elapsed_time(b) / count)
    return statistics.median(out)


def ptxas_of(log: str, kernel: str) -> dict:
    """ptxas's lines for each entry function whose name holds ``kernel``:
    its stack frame and spills, and its registers and constant bank."""
    out, name = {}, None
    for line in log.splitlines():
        line = line.strip()
        if line.startswith("ptxas info") and "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and kernel in name and ("spill" in line or line.startswith("ptxas info    : Used")):
            out.setdefault(name, []).append(line.replace("ptxas info    : ", ""))
        if line.startswith("ptxas info    : Used"):
            name = None
    return {k: "; ".join(v) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout to import")
    ap.add_argument("--device-proofs", action="store_true",
                    help="also time generate_transcript_device, unsharded and sharded, in turns")
    ap.add_argument("--sharded-fs", type=int, default=0, metavar="N",
                    help="also time the FS proof of 2^N entries, sharded and not, in turns")
    ap.add_argument("--mb-shapes", action="store_true", help="also time the multi-block round at its unsharded shapes")
    ap.add_argument("--no-api", action="store_true", help="leave out api.prove_triangle_count")
    args = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("triangle_times: torch.cuda.is_available() is false; no result", file=sys.stderr)
        return 1
    from thaler_study_tpu_torch import _build, api
    from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray
    from thaler_study_tpu_torch.parallel import make_mesh

    logs = _build.build()
    sync = torch.cuda.synchronize
    dev = torch.device("cuda")
    mesh = make_mesh([dev] * smoke.SHARD_COUNT)
    nodes = smoke.TRI_NODES
    adj = smoke.triangle_graph(nodes, SEED)
    out = {"root": str(Path(args.root).resolve()), "device": torch.cuda.get_device_name(0)}
    if not args.no_api or args.device_proofs:
        claim, first = api.prove_triangle_count(adj, nodes, GOLDILOCKS)
    if not args.no_api:
        seconds = []
        for _ in range(REPS):
            sync()
            t0 = time.perf_counter()
            c, t = api.prove_triangle_count(adj, nodes, GOLDILOCKS)
            seconds.append(time.perf_counter() - t0)
            if c != claim or t.to_bytes() != first.to_bytes():
                raise AssertionError("two proofs of one graph differ")
        out.update(nodes=nodes, claim=claim, prove_s=seconds, median_s=statistics.median(seconds))
    if args.device_proofs:
        from thaler_study_tpu_torch.fiat_shamir import generate_transcript_device
        from thaler_study_tpu_torch.protocols import TriangleG

        k = (nodes - 1).bit_length()
        g = TriangleG.new_adj_matrix(2 * k, adj, GOLDILOCKS, device=dev)
        want = first.to_bytes()

        def check(name, got):
            if got.to_bytes() != want:
                raise AssertionError(f"{name}: the device proof's bytes differ from the API's proof")

        out["triangle"] = in_turns(
            {"device": lambda: generate_transcript_device(g, GOLDILOCKS),
             "sharded_device": lambda: generate_transcript_device(g, GOLDILOCKS, mesh=mesh,
                                                                  n_shard=smoke.SHARD_VARS)}, sync, check)
        del g
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def words(field, shape):
        if field.backend == "goldilocks":
            lo = torch.randint(0, 1 << 32, shape, generator=gen, device=dev, dtype=torch.int64)
            hi = torch.randint(0, (1 << 32) - 1, shape, generator=gen, device=dev, dtype=torch.int64)
            return (hi << 32) | lo
        return torch.randint(0, field.p, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    if args.sharded_fs:
        from thaler_study_tpu_torch.ops import fs_kernel
        from thaler_study_tpu_torch.ops.round_kernel import single_block_spec

        n = args.sharded_fs
        out["fs"] = {"n": n}
        for field in (GOLDILOCKS, BABYBEAR):
            x = words(field, (2, 1 << n))
            tables = [FArray(x[0], field), FArray(x[1], field)]
            fs_spec = single_block_spec(2, n)
            want = [m.hex() for m in fs_kernel.fs_prove_device(fs_spec, tables)]

            def check(name, got):
                if got is None or [m.hex() for m in got] != want:
                    raise AssertionError(f"the {name} FS proof ({field.name}) != fs_prove_device")

            out["fs"][field.name] = in_turns(
                {"unsharded": lambda: fs_kernel.fs_prove_device(fs_spec, tables),
                 "sharded": lambda: fs_kernel.fs_prove_device_sharded(fs_spec, tables, mesh,
                                                                      n_shard=smoke.SHARD_VARS)}, sync, check)
            del x, tables
            torch.cuda.empty_cache()
    if args.mb_shapes:
        from thaler_study_tpu_torch.ops import multiblock
        from thaler_study_tpu_torch.ops import round_kernel as rk

        def folded(spec, j):
            for _ in range(j):
                spec = spec.after_fold()
            return spec

        tri = rk.PolySpec((12, 12, 12), TRI, ((0, 1, 2),))
        cases = (("X -> Y", folded(tri, 11), True), ("the round after it", folded(tri, 12), True),
                 ("mid-Y", folded(tri, 17), True),
                 ("dense W first b round", rk.PolySpec((11, 11), W_BLOCKS, W_TERMS), False))
        out["mb_ms"] = {}
        for name, mb_spec, fold in cases:
            post = mb_spec.after_fold() if fold else mb_spec
            plan = multiblock.round_plan(mb_spec, fold, post.terms, post.degree())
            tabs = [words(GOLDILOCKS, (rk._table_size(mb_spec, t),)) for t in range(len(mb_spec.table_blocks))]
            r = words(GOLDILOCKS, (1,)) if fold else None
            cl = words(GOLDILOCKS, (1,)) if fold else None
            f, s = multiblock.round_sums(plan, tabs, r, GOLDILOCKS, fold, cl)
            pf, ps = multiblock.round_sums_plain(plan, tabs, r, GOLDILOCKS, fold, cl)
            if not torch.equal(s, ps) or any(a is not None and not torch.equal(a, b) for a, b in zip(f, pf)):
                raise AssertionError(f"MB {name}: the kernel != plain")
            out["mb_ms"][name] = graph_ms(lambda: multiblock.round_sums(plan, tabs, r, GOLDILOCKS, fold, cl), sync)
            del tabs
        log = logs.get("multiblock_round")
        out["mb_ptxas"] = ptxas_of(log, "mb_round_kernel") if log else "built before this run"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
