#!/usr/bin/env python3
"""Trace a warm triangle-counting proof on one card, for the checkout at --root.

Usage, on a machine with a card:

    python3 scripts/triangle_trace.py [--root DIR]

Imports ``thaler_study_tpu_torch`` from ``--root`` (default: this checkout),
so that two checkouts, such as a commit and its parent, can be traced the
same way. Runs ``chip_smoke.triangle_trace`` (this checkout's) on
``chip_smoke.py``'s main-path graph (``TRI_NODES`` nodes, seed 42) over
Goldilocks: the multi-block round kernel's device records (count, sum),
the device idle share of one ``api.prove_triangle_count``, and the port's
kernels, plain-torch kernels and copies of each round of a proof driven
round by round. Prints the log line and one JSON line. Exits 1 without a
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SEED = 42


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout to import")
    args = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("triangle_trace: torch.cuda.is_available() is false; no result", file=sys.stderr)
        return 1
    from thaler_study_tpu_torch import _build

    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          check=True, capture_output=True, text=True).stdout.strip()
    out = smoke.triangle_trace(smoke.TRI_NODES, SEED, f"[{card}]")
    print(json.dumps({"root": str(Path(args.root).resolve()), "nodes": smoke.TRI_NODES, "card": card, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
