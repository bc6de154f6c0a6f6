"""Profiling: per-round timing and device traces.

Counterpart of ``thaler_study_tpu/utils/profiling.py``: a round timer that
any prover loop can wrap, and :func:`device_trace`, a ``torch.profiler``
trace of the host and the card written as a Chrome trace (open it in
Perfetto or ``chrome://tracing``) where the reference writes a JAX
profiler trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

from .counters import COUNTS


class RoundTimer:
    """Collects (label, seconds, field_ops) per protocol round."""

    def __init__(self):
        self.records: List[Dict] = []

    @contextlib.contextmanager
    def round(self, label: str):
        muls0, adds0 = COUNTS.field_muls, COUNTS.field_adds
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.records.append(
            {
                "label": label,
                "seconds": dt,
                "field_muls": COUNTS.field_muls - muls0,
                "field_adds": COUNTS.field_adds - adds0,
            }
        )

    def summary(self) -> Dict:
        total = sum(r["seconds"] for r in self.records)
        muls = sum(r["field_muls"] for r in self.records)
        adds = sum(r["field_adds"] for r in self.records)
        return {
            "rounds": len(self.records),
            "total_s": total,
            "field_muls": muls,
            "field_adds": adds,
            "field_ops_per_s": (muls + adds) / total if total else 0.0,
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (the CPU, and the card where
    CUDA is available) and write ``log_dir/trace.json``, a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
