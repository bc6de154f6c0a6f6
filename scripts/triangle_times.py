#!/usr/bin/env python3
"""Time the triangle-counting IP's prover on one card, for the checkout at --root.

Usage, on a machine with a card:

    python3 scripts/triangle_times.py [--root DIR]

Imports ``thaler_study_tpu_torch`` from ``--root`` (default: this checkout),
so that two checkouts, such as a commit and its parent, can be timed in
turns on one card. Proves ``chip_smoke.py``'s main-path graph (its
``triangle_graph`` at ``TRI_NODES`` nodes, from seed 42, taken from this
checkout's ``chip_smoke.py``) over Goldilocks once to warm up and 5 more
times with ``api.prove_triangle_count`` (host clock; a proof ends in its
host read), checks that every proof's claim and bytes are the first one's,
and prints one JSON line with the seconds and their median. With
``--device-proofs`` it also times, in turns, the same proof through
``generate_transcript_device`` unsharded and sharded over Z on
``chip_smoke.py``'s mesh (``SHARD_COUNT`` shards of the card, n_shard
``SHARD_VARS``), each byte-identical to the first. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SEED, REPS = 42, 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout to import")
    ap.add_argument("--device-proofs", action="store_true",
                    help="also time generate_transcript_device, unsharded and sharded, in turns")
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
    from thaler_study_tpu_torch.fields import GOLDILOCKS

    _build.build()
    nodes = smoke.TRI_NODES
    adj = smoke.triangle_graph(nodes, SEED)
    claim, first = api.prove_triangle_count(adj, nodes, GOLDILOCKS)
    seconds = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, t = api.prove_triangle_count(adj, nodes, GOLDILOCKS)
        seconds.append(time.perf_counter() - t0)
        if c != claim or t.to_bytes() != first.to_bytes():
            raise AssertionError("two proofs of one graph differ")
    out = {"root": str(Path(args.root).resolve()), "nodes": nodes, "claim": claim,
           "device": torch.cuda.get_device_name(0), "prove_s": seconds, "median_s": statistics.median(seconds)}
    if args.device_proofs:
        from thaler_study_tpu_torch.fiat_shamir import generate_transcript_device
        from thaler_study_tpu_torch.parallel import make_mesh
        from thaler_study_tpu_torch.protocols import TriangleG

        k = (nodes - 1).bit_length()
        g = TriangleG.new_adj_matrix(2 * k, adj, GOLDILOCKS, device="cuda")
        mesh = make_mesh(["cuda:0"] * smoke.SHARD_COUNT)
        runs = {"device_s": lambda: generate_transcript_device(g, GOLDILOCKS),
                "sharded_device_s": lambda: generate_transcript_device(g, GOLDILOCKS, mesh=mesh,
                                                                       n_shard=smoke.SHARD_VARS)}
        want = first.to_bytes()
        for name in runs:
            out[name] = []
        for i in range(REPS + 1):
            for name, run in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = run().to_bytes()
                if i:
                    out[name].append(time.perf_counter() - t0)
                if got != want:
                    raise AssertionError(f"{name}: the device proof's bytes differ from the first proof's")
        for name in runs:
            out[name.replace("_s", "_median_s")] = statistics.median(out[name])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
