#!/usr/bin/env python3
"""Time the triangle-counting IP's prover, the sharded proofs and single kernels on one card, for the checkout at --root.

Usage, on a machine with a card:

    python3 scripts/triangle_times.py [--root DIR] [--device-proofs] [--sharded-fs N] [--mb-shapes]
                                      [--k2-rows LOG] [--fs-tail ROWS] [--dispatch] [--merkle] [--mle LOG]
                                      [--no-api]

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
  built the library;
- ``--k2-rows LOG``: kernel K2 on one random layer of 2^LOG gates over
  2^LOG cells (labels uniform, MUL with probability 0.5, seed 42: the
  flagship's wiring), Goldilocks and BabyBear words, both phases: over all
  ``SHARD_COUNT`` shard rows in one launch (``phase_tables_rows``) and
  unsharded (``phase_tables``), each held against its plain version (the
  rows form also at the groups of rows (3, 1), (6, 2) and (1, 5)) and
  timed from CUDA graphs, twice each in turns;
- ``--fs-tail ROWS``: the FS tail (degree 2, round 1, a chain fill of 40)
  of one proof over 32, 64, 128, 256, 512 and ROWS partial rows, and of
  64 proofs over 32 rows each (the batch dispatch's), both fields, in
  each of the kernel's forms (one warp per proof and the wide form, each
  forced through ``fs_kernel.tail_warps``; a checkout without that choice
  in the form it has), each held against its plain version and timed from
  CUDA graphs, twice each in turns;
- ``--dispatch``: the batch dispatch of B = 64 proofs of a 2-factor
  product over 2^22 (``bench.py``'s shape) through
  ``generate_transcripts_batch``, both fields: one warm dispatch, then 5
  timed (host clock, each ending in its host read).
- ``--merkle``: the Merkle build (``merkle_kernel.build_tree``) over
  ``chip_smoke.py``'s trees, 2^22 leaves of 8 bytes and 2^18 of 2 (random
  bytes, seed 42), timed from CUDA graphs twice; every level of the 2^18
  tree held against ``hashlib``, and the SHA-256 of each whole tree
  printed (equal across checkouts); beside it the checkout's launches split:
  each launch of the build alone from a CUDA graph (a checkout with one
  launch per node level: the leaf level, each node level, the top block),
  the lane-instructions per clock per SM achieved (``chip_smoke``'s pinned
  SASS per hash) on the leaf launch, the largest node launch and the whole
  build, the SASS of each of the library's kernels by pipe
  (``chip_smoke.sass_pipes``), and the depth floor (1 + 2 log2 n
  compressions at one thread's compression latency, ``fs_kernel.sha_chain``).
- ``--mle LOG``: the dense MLE's kernels at the paths' shapes, from CUDA
  graphs twice each: ``mle_kernel.eval_many`` at GKR's restriction (LOG + 1
  points over 2^LOG Goldilocks and BabyBear words) and at the PCS commit's
  ``PCS_POINTS`` F389 points over ``PCS_M`` variables,
  ``forward_kernel.forward_layer`` on 2^LOG gates over 2^LOG values (labels
  uniform, MUL with probability 0.5) over both fields, and
  ``mle_kernel.fold`` of the first half of ``MLE_WIDE_LOG`` variables (the
  matmul entry's; Goldilocks and F5), all constants ``chip_smoke.py``'s.
  The words come from a generator seeded 21 on the card, so two checkouts
  see the same inputs; each result's SHA-256 is printed (equal across
  checkouts), with ptxas's registers and spills of the kernels where this
  run built them (``chip_smoke.py --parent-root`` runs it parent, this,
  this, parent).

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


def merkle_times(smoke, dev, sync) -> dict:
    """``--merkle``: the build at both trees, its launches split, the SASS
    by pipe, the depth floor (module docstring)."""
    import hashlib

    import numpy as np
    import torch

    from thaler_study_tpu_torch import _build
    from thaler_study_tpu_torch.ops import fs_kernel, merkle_kernel

    clock_hz = smoke.max_sm_clock_mhz() * 1e6
    leaf_ins, node_ins = smoke.MERKLE_SASS_PER_HASH["leaf"], smoke.MERKLE_SASS_PER_HASH["node"]

    def per_clock_sm(ins, ms):
        return ins / (ms * 1e-3 * clock_hz * 132)

    chain = torch.empty(8, dtype=torch.int32, device=dev)
    chain_ms = {}
    for c in (1024, 2048):
        fs_kernel.sha_chain(c, chain)
        sync()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            fs_kernel.sha_chain(c, chain)
        b.record()
        sync()
        chain_ms[c] = a.elapsed_time(b) / 5
    compress_ms = (chain_ms[2048] - chain_ms[1024]) / 1024
    lib = merkle_kernel._library()
    path = str(_build._library_path("merkle"))
    kernels = [k for k in ("leaf_kernel", "node_kernel", "top_kernel", "build_kernel")
               if hasattr(lib, "ts_merkle_build_launch") == (k == "build_kernel")]
    out = {"compress_ns": compress_ms * 1e6, "clock_mhz": clock_hz / 1e6,
           "sass_by_pipe": {k: smoke.sass_pipes(path, k) for k in kernels}}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for log_n, bs in ((22, 8), (18, 2)):
        n = 1 << log_n
        vals = torch.randint(0, 256, (n, bs), generator=gen, device=dev, dtype=torch.int64).to(torch.uint8)
        tree = merkle_kernel.build_tree(vals)
        words = tree.cpu().numpy()
        if log_n == 18:
            want = merkle_kernel.build_tree_plain(vals.cpu().numpy())
            if any(not np.array_equal(a, b) for a, b in zip(merkle_kernel.split_levels(words), want)):
                raise AssertionError(f"Merkle build at 2^{log_n} leaves: a level != hashlib")
        ins = n * leaf_ins + (n - 1) * node_ins
        ms = [graph_ms(lambda: merkle_kernel.build_tree(vals), sync, 5) for _ in range(2)]
        row = {"ms": ms, "tree_sha256": hashlib.sha256(words.tobytes()).hexdigest(),
               "depth_floor_ms": compress_ms * (1 + 2 * log_n),
               "lane_instructions_per_clock_per_sm": per_clock_sm(ins, min(ms))}
        def stream():  # the capturing stream inside a graph capture
            return torch.cuda.current_stream(dev).cuda_stream

        if hasattr(lib, "ts_merkle_build_launch"):  # one launch: the build is its split
            row["launches"] = {"build": min(ms)}
        else:  # a launch per node level of more than TOP nodes, then the top block
            split, off = {}, 0
            split[f"leaf {n}"] = graph_ms(lambda: lib.ts_merkle_leaf_launch(vals.data_ptr(), bs, n, tree.data_ptr(),
                                                                            stream()), sync)
            for m in merkle_kernel.level_sizes(n)[1:]:
                if m <= merkle_kernel.TOP:
                    split[f"top {m}"] = graph_ms(lambda: lib.ts_merkle_top_launch(tree[off].data_ptr(), m, stream()),
                                                 sync)
                    break
                split[f"node {m}"] = graph_ms(lambda: lib.ts_merkle_node_launch(
                    tree[off].data_ptr(), m, tree[off + 2 * m].data_ptr(), stream()), sync)
                off += 2 * m
            row["launches"] = split
            row["leaf_lane_instructions_per_clock_per_sm"] = per_clock_sm(n * leaf_ins, split[f"leaf {n}"])
            row["node_lane_instructions_per_clock_per_sm"] = per_clock_sm(n // 2 * node_ins, split[f"node {n // 2}"])
            if not torch.equal(tree, merkle_kernel.build_tree(vals)):
                raise AssertionError("the split's launches changed the tree")
        out[f"2^{log_n} x {bs} bytes"] = row
        del vals, tree
    return out


def mle_times(smoke, dev, sync, logs, log_n) -> dict:
    """``--mle LOG``: the evaluation, forward and fold kernels at the
    paths' shapes (module docstring)."""
    import hashlib

    import torch

    from thaler_study_tpu_torch.fields import BABYBEAR, F5, F389, GOLDILOCKS, FArray
    from thaler_study_tpu_torch.ops import forward_kernel as fk
    from thaler_study_tpu_torch.ops import mle_kernel as mk

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)

    def words(field, size):
        if field.backend == "goldilocks":
            lo = torch.randint(0, 1 << 32, (size,), generator=gen, device=dev, dtype=torch.int64)
            hi = torch.randint(0, (1 << 32) - 1, (size,), generator=gen, device=dev, dtype=torch.int64)
            return FArray((hi << 32) | lo, field)
        return FArray(torch.randint(0, field.p, (size,), generator=gen, device=dev, dtype=torch.int64)
                      .to(torch.int32), field)

    out = {"ms": {}, "sha256": {}, "ptxas": {}}

    def run(name, fn):
        out["sha256"][name] = hashlib.sha256(fn().data.cpu().numpy().tobytes()).hexdigest()
        out["ms"][name] = [graph_ms(fn, sync) for _ in range(2)]

    for field in (GOLDILOCKS, BABYBEAR):
        be = field.backend
        t = words(field, 1 << log_n)
        rs = FArray(words(field, (log_n + 1) * log_n).data.reshape(log_n + 1, log_n), field)
        run(f"eval_{be}", lambda: mk.eval_many(t, rs))
        cur = words(field, 1 << log_n)
        b = torch.randint(0, 1 << log_n, (1 << log_n,), generator=gen, device=dev, dtype=torch.int32)
        c = torch.randint(0, 1 << log_n, (1 << log_n,), generator=gen, device=dev, dtype=torch.int32)
        m = torch.rand((1 << log_n,), generator=gen, device=dev) < 0.5
        run(f"forward_{be}", lambda: fk.forward_layer(cur, b, c, m))
        del t, rs, cur, b, c, m
    tp = words(F389, 1 << smoke.PCS_M)
    rp = FArray(words(F389, smoke.PCS_POINTS * smoke.PCS_M).data.reshape(smoke.PCS_POINTS, smoke.PCS_M), F389)
    run("eval_pcs", lambda: mk.eval_many(tp, rp))
    del tp, rp
    kf = smoke.MLE_WIDE_LOG // 2
    for field in (GOLDILOCKS, F5):
        t = words(field, 1 << smoke.MLE_WIDE_LOG)
        r = words(field, kf)
        run(f"fold_{field.backend}", lambda: mk.fold(t, r, kf))
        del t, r
        torch.cuda.empty_cache()
    for lib, kernel in (("mle", "eval"), ("mle", "fold_kernel"), ("forward", "forward_kernel")):
        if lib in logs:
            out["ptxas"].update(ptxas_of(logs[lib], kernel))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout to import")
    ap.add_argument("--device-proofs", action="store_true",
                    help="also time generate_transcript_device, unsharded and sharded, in turns")
    ap.add_argument("--sharded-fs", type=int, default=0, metavar="N",
                    help="also time the FS proof of 2^N entries, sharded and not, in turns")
    ap.add_argument("--mb-shapes", action="store_true", help="also time the multi-block round at its unsharded shapes")
    ap.add_argument("--k2-rows", type=int, default=0, metavar="LOG",
                    help="also time K2 over shard rows and unsharded on a layer of 2^LOG gates")
    ap.add_argument("--fs-tail", type=int, default=0, metavar="ROWS",
                    help="also time the FS tail over ROWS and 32 partial rows per proof")
    ap.add_argument("--dispatch", action="store_true", help="also time the B = 64 batch dispatch")
    ap.add_argument("--merkle", action="store_true", help="also time and split the Merkle build at 2^22 and 2^18")
    ap.add_argument("--mle", type=int, default=0, metavar="LOG",
                    help="also time the MLE evaluation, fold and forward kernels at a GKR width of 2^LOG")
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
    fields = (GOLDILOCKS, BABYBEAR)

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    if args.k2_rows:
        import numpy as np

        from thaler_study_tpu_torch.gkr import device_tables
        from thaler_study_tpu_torch.gkr.circuit import layer_wiring

        k, n_shard = args.k2_rows, smoke.SHARD_VARS
        rng = np.random.default_rng(SEED)
        b, c = (torch.from_numpy(rng.integers(0, 1 << k, 1 << k).astype(np.int32)).to(dev) for _ in range(2))
        wiring = layer_wiring(b, c, torch.from_numpy(rng.random(1 << k) < 0.5).to(dev), k)
        out["k2_ms"] = {}
        for field in fields:
            eq_r, table = FArray(words(field, (1 << k,)), field), FArray(words(field, (1 << k,)), field)
            for phase, key, gidx in ((1, wiring.b, wiring.c), (2, wiring.c, wiring.b)):
                for row0, rows in ((0, 1 << n_shard), (3, 1), (6, 2), (1, 5)):
                    got = device_tables.phase_tables_rows(phase, wiring, eq_r, table, k, n_shard, row0, rows)
                    want = device_tables.phase_tables_rows_plain(phase, key, gidx, wiring.is_mul, eq_r, table, k,
                                                                 n_shard, row0, rows)
                    if not same([t.data for t in got], [t.data for t in want]):
                        raise AssertionError(f"K2 over shard rows != plain: {field.name} {phase} {row0} {rows}")
                got = device_tables.phase_tables(phase, wiring, eq_r, table, k)
                want = device_tables.phase_tables_plain(phase, key, gidx, wiring.is_mul, eq_r, table, k)
                if not same([t.data for t in got], [t.data for t in want]):
                    raise AssertionError(f"K2 != plain: {field.name} phase {phase}")
                runs = {"rows": [], "whole": []}
                for _ in range(2):
                    runs["rows"].append(graph_ms(lambda: device_tables.phase_tables_rows(
                        phase, wiring, eq_r, table, k, n_shard, 0, 1 << n_shard), sync))
                    runs["whole"].append(graph_ms(lambda: device_tables.phase_tables(phase, wiring, eq_r, table, k),
                                                  sync))
                out["k2_ms"][f"{field.name} phase {phase}"] = runs
            del eq_r, table
    if args.fs_tail:
        from thaler_study_tpu_torch.fields.farray import word_dtype
        from thaler_study_tpu_torch.ops import fs_kernel
        from thaler_study_tpu_torch.ops.sha_chain import DevChain

        # each of the kernel's forms forced where the checkout picks one
        # (fs_kernel.tail_warps), else the one it has
        picks = getattr(fs_kernel, "tail_warps", None)
        forms = {"one warp": 1, "wide": fs_kernel.WIDE_WARPS} if picks else {"as built": None}
        nbytes = 64 * 7 + 40
        out["fs_tail_us"] = {}
        for field in fields:
            vinv = fs_kernel.interp_tensor(field, 2, dev)
            w, m_len = word_dtype(field), fs_kernel._msg_len(1, 2, field.byte_size)

            def state(batch):
                chain = DevChain.fresh(batch, dev)
                chain.state.copy_(torch.arange(8 * batch, device=dev, dtype=torch.int32).reshape(batch, 8) * 40503
                                  + 7)
                chain.buf[:, :40] = 7
                chain.nbytes = nbytes
                return [chain, words(field, (batch,)), torch.zeros(batch, dtype=w, device=dev),
                        torch.zeros(batch, dtype=w, device=dev), torch.zeros((batch, 9), dtype=w, device=dev),
                        torch.zeros((batch, nbytes + m_len), dtype=torch.uint8, device=dev),
                        torch.zeros(batch, dtype=torch.int32, device=dev), vinv]

            shapes = {f"1 x {x}": (1, x) for x in sorted({32, 64, 128, 256, 512, args.fs_tail})}
            shapes["64 x 32"] = (64, 32)
            cases = {}
            for name, (batch, nrows) in shapes.items():
                rows = words(field, (batch, nrows, 3))
                for form, warps in forms.items():
                    fs_kernel.tail_warps = picks if warps is None else lambda blocks, w=warps: w
                    a, p = state(batch), state(batch)
                    p[1].copy_(a[1])
                    fs_kernel.fs_tail(rows, *a, 1, 3, True, field)
                    fs_kernel.fs_tail_plain(rows, *p, 1, 3, True, field)
                    if not same([a[0].state, a[0].buf] + a[1:7], [p[0].state, p[0].buf] + p[1:7]):
                        raise AssertionError(f"FS tail != plain: {field.name}, {name} rows, {form}")
                    cases[name, form] = (rows, state(batch))

            def tail(key):
                rows, st = cases[key]
                st[0].nbytes = nbytes
                fs_kernel.fs_tail(rows, *st, 1, 3, True, field)

            runs = {f"{name}, {form}": [] for name, form in cases}
            try:
                for _ in range(2):
                    for (name, form), warps in ((key, forms[key[1]]) for key in cases):
                        fs_kernel.tail_warps = picks if warps is None else lambda blocks, w=warps: w
                        runs[f"{name}, {form}"].append(graph_ms(lambda: tail((name, form)), sync) * 1e3)
            finally:
                fs_kernel.tail_warps = picks
            out["fs_tail_us"][field.name] = runs
            del cases
    if args.dispatch:
        from thaler_study_tpu_torch.protocols.batched import BatchedProductPoly, generate_transcripts_batch

        out["dispatch_ms"] = {}
        for field in fields:
            poly = BatchedProductPoly([FArray(words(field, (64, 1 << 22)), field) for _ in range(2)])
            generate_transcripts_batch(poly, field)
            times = []
            for _ in range(REPS):
                sync()
                t0 = time.perf_counter()
                generate_transcripts_batch(poly, field)
                times.append((time.perf_counter() - t0) * 1e3)
            out["dispatch_ms"][field.name] = {"ms": times, "median_ms": statistics.median(times)}
            del poly
            torch.cuda.empty_cache()
    if args.merkle:
        out["merkle"] = merkle_times(smoke, dev, sync)
    if args.mle:
        out["mle"] = mle_times(smoke, dev, sync, logs, args.mle)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
