"""Check the sharded prover on a mesh of several real cards against the
unsharded prover, byte for byte.

Run on a machine with 2 or more CUDA devices, from the repository root:

    python3 scripts/multi_card_check.py [--n 24] [--nodes 4096] [--procs 2]

Phases (each prints one line; any mismatch raises and the exit code is 1):

1. one process, ``make_mesh()`` (every visible card) and an 8-position mesh
   that alternates the cards (a group per position): the sharded FS proof
   ``fs_prove_device_sharded`` of a 2-factor product over Goldilocks and
   BabyBear, ``n_shard`` 3, against ``fs_prove_device`` on card 0; its
   collectives (each reduction sends D + 1 words off every card but the
   first); its layout (``ShardedBlockPoly.from_internal_tables``: one
   launch of the shard layout kernel per table and group on card 0, each
   group's rows then copied to its card) timed in turns with the proofs;
2. the triangle IP sharded over Z across the cards (each card's shards on
   one launch of the tensor-core matmul's dot form per t): the per-round loop over
   ``ShardedBlockPoly`` and ``generate_transcript_device(mesh=)`` against
   the unsharded ``generate_transcript_device``;
3. the per-layer GKR prover with ``mesh=`` over the cards against the
   unsharded one, and ``api.run_gkr(mesh=, n_shard=)``;
4. ``--procs`` processes, one card each (``torch.cuda.set_device``, then
   ``init_distributed`` over a file store: NCCL for the card's tensors),
   each one DCN row of ``make_mesh_2d``: every process's FS proof bytes
   equal phase 1's unsharded ones, and every process's sharded fused GKR
   proof (phase 5's circuit) equals the unsharded fused proof on card 0;
5. the sharded fused GKR prover (``generate_gkr_transcript_fused(mesh=)``,
   Goldilocks, ``--gkr-depth`` x 2^``--gkr-log``) on ``make_mesh()`` and
   on the alternating mesh against the unsharded fused proof on card 0:
   bytes, collectives and challenge sends, the medians of 3 in turns; then
   one instrumented proof on ``make_mesh()`` that splits its sharded rounds
   into K1's TOTAL form over each card's rows (one row per card), the
   reduction (the copies to card 0; a row-sum kernel where a card has more
   than one row), the round tail and the challenge sends,
   each step timed alone between syncs of every card (so the split adds
   up to more than a proof: the steps no longer overlap);
6. (run first) the one-program forms on the last card while the current
   device stays card 0: the batch program (n = 14, B = 8, both fields)
   and the fused GKR program (4 x 2^10), each captured at its first run
   and replayed at its second, equal to the same runs on card 0.

``--cpu K`` rehearses the same phases on K alternating CPU positions
(``["cpu", "cpu:0"] * (K // 2)``) and processes of one CPU device each
(gloo), at the sizes given. The last line is one JSON object with
``"ok"``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHARD_VARS = 3


def digest(msgs) -> str:
    return hashlib.sha256(b"".join(len(m).to_bytes(4, "little") + m for m in msgs)).hexdigest()[:16]


def product_tables(field, n: int, seed: int, dev):
    import numpy as np

    from thaler_study_tpu_torch.fields import FArray

    rng = np.random.default_rng(seed)
    hi = min(field.p, 1 << 63)
    return [FArray.from_ints(rng.integers(0, hi, 1 << n, dtype=np.uint64), field, device=dev) for _ in range(2)]


def fields():
    from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS

    return (GOLDILOCKS, BABYBEAR)


def gkr_field():
    from thaler_study_tpu_torch.fields import GOLDILOCKS

    return GOLDILOCKS


def gkr_case(args):
    """Phase 3's circuit (``--gkr-depth`` x 2^``--gkr-log``, from the
    seed) and its Goldilocks inputs."""
    import numpy as np

    from chip_smoke import gate_circuit
    from thaler_study_tpu_torch import gkr

    width = 1 << args.gkr_log
    circuit = gate_circuit(gkr, [width] * (args.gkr_depth + 1), np.random.default_rng(args.seed))
    inputs = [int(x) for x in np.random.default_rng(args.seed + 7).integers(0, 1 << 63, width, dtype=np.uint64)]
    return circuit, inputs


def split_rounds(gkr, circuit, inputs, mesh, sync) -> dict:
    """One sharded fused proof with each step of its sharded rounds timed
    alone (every card synced before and after it, host clock): ms summed
    over the proof and calls, per step."""
    from thaler_study_tpu_torch.gkr import fused
    from thaler_study_tpu_torch.ops import row_sums

    spent = {}

    def timed(name, fn):
        def run(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            ms, n = spent.get(name, (0.0, 0))
            spent[name] = (ms + (time.perf_counter() - t0) * 1e3, n + 1)
            return out
        return run

    saved = {name: getattr(fused, name) for name in ("libra_round_total", "collective", "round_tail", "send")}
    row_sum = row_sums.row_sums
    fused.libra_round_total = timed("K1 TOTAL over a card's rows", saved["libra_round_total"])
    fused.round_tail = timed("round tail", saved["round_tail"])
    fused.send = timed("challenge sends", saved["send"])

    def collective(mesh_, op, parts, field):
        if op != "sum":
            return saved["collective"](mesh_, op, parts, field)
        row_sums.row_sums = timed("reduction: row-sum kernel", row_sum)
        try:
            return timed("reduction (sums and copies to card 0)", saved["collective"])(mesh_, op, parts, field)
        finally:
            row_sums.row_sums = row_sum

    fused.collective = collective
    try:
        gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, gkr_field(), device=mesh.primary),
                                          gkr_field(), mesh=mesh)
    finally:
        for name, fn in saved.items():
            setattr(fused, name, fn)
        row_sums.row_sums = row_sum
    return spent


def worker(args) -> int:
    """Phase 4's process ``args.rank`` of ``args.world``."""
    import torch
    import torch.distributed as dist

    from thaler_study_tpu_torch.ops import fs_kernel
    from thaler_study_tpu_torch.ops.round_kernel import single_block_spec
    from thaler_study_tpu_torch.parallel import init_distributed, make_mesh_2d, sharded

    torch.set_num_threads(1)
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", args.rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(f"file://{args.store}", args.world, args.rank)
    try:
        mesh = make_mesh_2d([dev])
        out = {"shape": list(mesh.devices.shape), "proofs": {}}
        for field in fields():
            tables = product_tables(field, args.n, args.seed, dev)
            msgs = fs_kernel.fs_prove_device_sharded(single_block_spec(2, args.n), tables, mesh, n_shard=SHARD_VARS)
            out["proofs"][field.name] = None if msgs is None else digest(msgs)
        out["collectives"] = dict(sharded.collectives)
        from thaler_study_tpu_torch import gkr

        circuit, inputs = gkr_case(args)
        prove = lambda: gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, gkr_field(), device=dev),
                                                          gkr_field(), mesh=mesh)
        out["gkr"] = digest(prove().g)
        times = []
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            prove()
            times.append((time.perf_counter() - t0) * 1e3)
        out["gkr_ms"] = sorted(times)[1]
        with open(args.out, "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42, help="numpy seed of the tables, the graph and the circuit")
    ap.add_argument("--n", type=int, default=24, help="variables of the product proofs")
    ap.add_argument("--nodes", type=int, default=4096, help="nodes of the triangle IP's graph")
    ap.add_argument("--gkr-depth", type=int, default=4, help="layers of the GKR circuit")
    ap.add_argument("--gkr-log", type=int, default=18, help="log2 of the GKR circuit's width")
    ap.add_argument("--procs", type=int, default=2, help="processes of phase 4")
    ap.add_argument("--cpu", type=int, default=0, help="rehearse on this many CPU positions instead of the cards")
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank >= 0:
        return worker(args)

    import numpy as np
    import torch

    from chip_smoke import field_inputs, gate_circuit, in_turns, triangle_graph
    from thaler_study_tpu_torch import _build, api, gkr
    from thaler_study_tpu_torch.fiat_shamir import (
        SumcheckInteractiveProver,
        generate_transcript,
        generate_transcript_device,
    )
    from thaler_study_tpu_torch.fields import FArray
    from thaler_study_tpu_torch.ops import fs_kernel, modmatmul, shard_layout
    from thaler_study_tpu_torch.ops.round_kernel import single_block_spec
    from thaler_study_tpu_torch.parallel import ShardedBlockPoly, make_mesh, sharded
    from thaler_study_tpu_torch.protocols import TriangleG
    from thaler_study_tpu_torch.sumcheck import Prover

    if args.cpu:
        devices = ["cpu", "cpu:0"] * (args.cpu // 2)
        first = torch.device("cpu")

        def sync():
            pass
    else:
        if torch.cuda.device_count() < 2:
            print("multi_card_check: needs 2 or more CUDA devices", file=sys.stderr)
            return 1
        devices = None
        first = torch.device("cuda", 0)
        sync = torch.cuda.synchronize
        t0 = time.perf_counter()
        _build.build()
        print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True)
        print(smi.stdout.strip(), flush=True)
    cards = make_mesh(devices)
    count = cards.devices.size
    alternating = make_mesh(list(cards.devices.flat) * max(1, 8 // count))
    report = {"devices": [str(d) for d in cards.devices.flat]}

    def reset():
        for key in sharded.collectives:
            sharded.collectives[key] = 0

    # phase 6 (first, it is short): the one-program forms on the last card
    # while the current device stays the first
    last = list(cards.devices.flat)[-1]
    rng6 = np.random.default_rng(args.seed + 6)
    n6, b6 = 14, 8
    vals6 = {f.name: [rng6.integers(0, min(f.p, 1 << 63), (b6, 1 << n6), dtype=np.uint64) for _ in range(2)]
             for f in fields()}
    circuit6 = gate_circuit(gkr, [1 << 10] * 5, np.random.default_rng(args.seed + 6))
    inputs6 = [int(x) for x in rng6.integers(0, 1 << 62, 1 << 10)]
    runs6 = {}
    for dev in (first, last):
        for field in fields():
            tabs = [FArray.from_ints(v, field, device=dev) for v in vals6[field.name]]
            spec6 = single_block_spec(2, n6)
            runs6[(str(dev), field.name)] = [digest(sum(fs_kernel.fs_prove_device_batch(spec6, tabs), []))
                                             for _ in range(2)]
            prog = fs_kernel.programs[(2, n6, field.name, b6, tabs[0].data.device)]
            if not args.cpu and (prog.graph is None or prog.graph.replays != 1):
                raise AssertionError(f"phase 6: the batch program on {dev} was not captured and replayed")
        runs6[(str(dev), "gkr")] = [digest(gkr.generate_gkr_transcript_fused(
            gkr.Prover(circuit6, inputs6, gkr_field(), device=dev), gkr_field()).g) for _ in range(2)]
        if not args.cpu:
            progs = [pr for key, pr in circuit6._fused_programs.items() if key[0] == dev]
            if len(progs) != 1 or progs[0].graph is None or progs[0].graph.replays != 1:
                raise AssertionError(f"phase 6: the fused GKR program on {dev} was not captured and replayed")
            if torch.cuda.current_device() != 0:
                raise AssertionError(f"phase 6: the current device moved to {torch.cuda.current_device()}")
    for key, (a, b) in runs6.items():
        if a != b or runs6[(str(first), key[1])][0] != a:
            raise AssertionError(f"phase 6: {key}: the first run {a}, the replay {b}, on {first} "
                                 f"{runs6[(str(first), key[1])][0]}")
    print(f"phase 6: the batch programs (n = {n6}, B = {b6}, both fields) and the fused GKR program (4 x 2^10) on "
          f"{last}, the current device {first}: each first run and its replay == the same on {first} "
          f"({sorted(set(v[0] for v in runs6.values()))})", flush=True)
    report["programs"] = {f"{k[0]} {k[1]}": v[0] for k, v in runs6.items()}
    fs_kernel.programs.clear()

    # phase 1: the sharded FS proof on meshes of the cards
    spec = single_block_spec(2, args.n)
    want = {}
    for field in fields():
        tables = product_tables(field, args.n, args.seed, first)
        ref = fs_kernel.fs_prove_device(spec, tables)
        want[field.name] = digest(ref)
        for name, mesh in (("make_mesh()", cards), ("alternating", alternating)):
            reset()
            laid = shard_layout.launches[field.backend]
            tail, tail_rows = fs_kernel.fs_tail, []  # the partial rows each FS tail sums (its form's input)
            fs_kernel.fs_tail = lambda partials, *a: (tail_rows.append(partials.shape[1]), tail(partials, *a))[1]
            try:
                got = fs_kernel.fs_prove_device_sharded(spec, tables, mesh, n_shard=SHARD_VARS)
            finally:
                fs_kernel.fs_tail = tail
            sync()
            laid = shard_layout.launches[field.backend] - laid
            coll = dict(sharded.collectives)
            if got is None or digest(got) != want[field.name]:
                raise AssertionError(f"phase 1 {field.name} on {name} {mesh}: != fs_prove_device")
            groups = len(mesh.layout(mesh.devices.size))
            others = sum(1 for d, _, _ in mesh.layout(mesh.devices.size) if d != mesh.primary)
            if coll["reduce"] != args.n - SHARD_VARS or coll["reduce_words"] != others * 3 * coll["reduce"]:
                raise AssertionError(f"phase 1 {field.name} on {name}: collectives {coll}")
            if not args.cpu and laid != 2 * groups:
                raise AssertionError(f"phase 1 {field.name} on {name}: {laid} layout launches, not one per table "
                                     f"and group ({2 * groups})")
            times = in_turns({"unsharded": lambda: fs_kernel.fs_prove_device(spec, tables),
                              "sharded": lambda: fs_kernel.fs_prove_device_sharded(spec, tables, mesh,
                                                                                   n_shard=SHARD_VARS),
                              "layout": lambda: ShardedBlockPoly.from_internal_tables(spec, tables, mesh,
                                                                                      n_shard=SHARD_VARS)}, 3, sync)
            print(f"phase 1: sharded FS proof {field.name} n = {args.n} on {name} {mesh} ({groups} groups, "
                  f"n_shard {SHARD_VARS}) == fs_prove_device on {first}; collectives {coll}; {laid} layout kernel "
                  f"launches; the FS tail over up to {max(tail_rows)} partial rows (the first card's and the "
                  f"others' sums, {fs_kernel.tail_warps(max(tail_rows))} warps per proof); median of 3 in turns sharded {times['sharded'][0]:.1f} ms (its layout alone: the "
                  f"kernel on {first}, then the copies to the cards, {times['layout'][0]:.2f} ms), unsharded "
                  f"{times['unsharded'][0]:.1f} ms", flush=True)
            report[f"fs {field.name} {name}"] = {"sharded_ms": times["sharded"][0], "layout_ms": times["layout"][0],
                                                 "unsharded_ms": times["unsharded"][0], "collectives": coll}
        del tables

    # phase 2: the triangle IP sharded over Z across the cards
    field = fields()[0]
    k = (args.nodes - 1).bit_length()
    g = TriangleG.new_adj_matrix(2 * k, triangle_graph(args.nodes, args.seed), field, device=first)
    ref = generate_transcript_device(g, field).to_bytes()
    poly = ShardedBlockPoly.from_internal_tables(g.spec, g.tables, cards, n_shard=SHARD_VARS)
    if generate_transcript(SumcheckInteractiveProver(Prover(poly)), field).to_bytes() != ref:
        raise AssertionError(f"phase 2: the per-round sharded triangle ({args.nodes} nodes) != the unsharded one")
    tc = dict(modmatmul.total_launches)
    got = generate_transcript_device(g, field, mesh=cards, n_shard=SHARD_VARS).to_bytes()
    launches = modmatmul.total_launches[field.backend] - tc[field.backend]
    if got != ref:
        raise AssertionError(f"phase 2: generate_transcript_device(mesh=) ({args.nodes} nodes) != the unsharded one")
    if not args.cpu and not launches:
        raise AssertionError(f"phase 2: the sharded triangle ({args.nodes} nodes) launched no tensor-core matmul")
    print(f"phase 2: triangle IP {args.nodes} nodes {field.name} sharded over Z on {cards}: the per-round loop and "
          f"generate_transcript_device(mesh=) == the unsharded transcript; tensor-core matmul launches (the ROWS "
          f"form: each card's shard rows as one contraction) of the device proof {launches}", flush=True)
    report["triangle"] = {"nodes": args.nodes, "tc_launches": launches}
    del g, poly

    # phase 3: the per-layer GKR prover with mesh=
    grng = np.random.default_rng(args.seed)
    width = 1 << args.gkr_log
    circuit = gate_circuit(gkr, [width] * (args.gkr_depth + 1), grng)
    for field in fields():
        inputs = [int(x) for x in field_inputs(args.seed, field, width)] if field.backend == "mont32" else \
            [int(x) for x in np.random.default_rng(args.seed + 7).integers(0, 1 << 63, width, dtype=np.uint64)]
        dev_kw = {"device": "cpu"} if args.cpu else {}
        ref = gkr.generate_gkr_transcript(gkr.Prover(circuit, inputs, field, **dev_kw), field).to_bytes()
        got = gkr.generate_gkr_transcript(gkr.Prover(circuit, inputs, field, mesh=cards, n_shard=SHARD_VARS,
                                                     **dev_kw), field).to_bytes()
        if got != ref:
            raise AssertionError(f"phase 3: sharded per-layer GKR ({field.name}) != the unsharded transcript")
        outs, ok = api.run_gkr(circuit, inputs, field, seed=args.seed, mesh=cards, n_shard=SHARD_VARS, **dev_kw)
        if not ok:
            raise AssertionError(f"phase 3: api.run_gkr(mesh=) ({field.name}) rejected")
        print(f"phase 3: per-layer GKR {field.name} {args.gkr_depth} x 2^{args.gkr_log} on {cards}: == the "
              f"unsharded transcript; api.run_gkr(mesh=, n_shard={SHARD_VARS}) accepts", flush=True)

    # phase 5: the sharded fused GKR prover across the cards (run before
    # phase 4, whose processes check their bytes against it)
    from thaler_study_tpu_torch.gkr import fused

    circuit, inputs = gkr_case(args)
    field = gkr_field()
    dev_kw = {"device": "cpu"} if args.cpu else {}
    fb = fused.fallbacks
    ref = gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, field, **dev_kw), field)
    want_gkr = digest(ref.g)
    for name, mesh in (("make_mesh()", cards), ("alternating", alternating)):
        reset()
        for key in sharded.sends:
            sharded.sends[key] = 0
        got = gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, field, **dev_kw), field, mesh=mesh)
        sync()
        if fused.fallbacks != fb or digest(got.g) != want_gkr:
            raise AssertionError(f"phase 5: sharded fused GKR on {name} {mesh} != the unsharded fused proof "
                                 f"(fallbacks {fused.fallbacks - fb})")
        coll, sends = dict(sharded.collectives), dict(sharded.sends)
        gkr_times = in_turns({
            "unsharded": lambda: gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, field, **dev_kw), field),
            "sharded": lambda: gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, inputs, field, **dev_kw), field,
                                                                 mesh=mesh)}, 3, sync)
        groups = [(row0, rows) for _, row0, rows in mesh.layout(1 << SHARD_VARS)]
        print(f"phase 5: sharded fused GKR {field.name} {args.gkr_depth} x 2^{args.gkr_log} on {name} {mesh} == the "
              f"unsharded fused proof on {first} (K2 over each group's shard rows (row0, rows): {groups}); "
              f"collectives {coll}, sends {sends}; median of 3 in turns sharded "
              f"{gkr_times['sharded'][0]:.1f} ms, unsharded {gkr_times['unsharded'][0]:.1f} ms", flush=True)
        report[f"gkr fused {name}"] = {"sharded_ms": gkr_times["sharded"][0],
                                       "unsharded_ms": gkr_times["unsharded"][0], "collectives": coll, "sends": sends}
    spent = split_rounds(gkr, circuit, inputs, cards, (lambda: [torch.cuda.synchronize(d) for d in cards.devices.flat])
                         if not args.cpu else sync)
    print(f"phase 5: one sharded fused proof on make_mesh() {cards}, each step of its sharded rounds timed alone "
          f"(every card synced around it): " + "; ".join(f"{name} {ms:.2f} ms over {n} calls ({ms / n * 1e3:.1f} us "
                                                         f"each)" for name, (ms, n) in spent.items()), flush=True)
    report["gkr fused split"] = {name: {"ms": ms, "calls": n} for name, (ms, n) in spent.items()}
    del ref, got

    # phase 4: processes, one device each, in one process group
    procs = args.procs
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(procs)]
        cmd = [sys.executable, os.path.abspath(__file__), "--n", str(args.n), "--seed", str(args.seed),
               "--gkr-depth", str(args.gkr_depth), "--gkr-log", str(args.gkr_log),
               "--world", str(procs), "--store", os.path.join(tmp, "store")] + (["--cpu", "1"] if args.cpu else [])
        ps = [subprocess.Popen(cmd + ["--rank", str(r), "--out", outs[r]], cwd=ROOT, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT) for r in range(procs)]
        deadline = time.monotonic() + 600
        try:
            logs = [p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0].decode(errors="replace")
                    for p in ps]
        finally:
            for p in ps:
                p.kill()
        for r, (p, text) in enumerate(zip(ps, logs)):
            if p.returncode != 0:
                raise AssertionError(f"phase 4: rank {r} exited {p.returncode}: {text[-3000:]}")
        for r, path in enumerate(outs):
            with open(path) as f:
                got = json.load(f)
            if got["proofs"] != want or got["shape"] != [procs, 1] or got["gkr"] != want_gkr:
                raise AssertionError(f"phase 4: rank {r}: {got} (want {want}, GKR {want_gkr})")
        print(f"phase 4: {procs} processes, one {'CPU device' if args.cpu else 'card'} each, one DCN row each "
              f"(mesh {got['shape']}): every process's sharded FS proofs == phase 1's unsharded ones "
              f"({want}); collectives of rank {procs - 1}: {got['collectives']}; every process's sharded fused "
              f"GKR proof == the unsharded fused one ({want_gkr}), median of 3 {got['gkr_ms']:.1f} ms (rank "
              f"{procs - 1}) against {gkr_times['unsharded'][0]:.1f} ms unsharded on one card", flush=True)
        report["processes"] = {"procs": procs, "collectives": got["collectives"], "gkr_ms": got["gkr_ms"]}
    print(json.dumps({"ok": True, "multi_card": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
