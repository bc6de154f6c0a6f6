"""One-program forms: a fixed sequence of the port's kernel launches
captured once as a CUDA graph and replayed.

The JAX package runs a whole GKR proof (``gkr/fused.py:398``
``_scan_proof_jit``) and B whole sumcheck proofs
(``ops/fs_kernel.py:337`` ``_fs_prove_batch_jit``) as one XLA program
each. The port's counterpart is a CUDA graph of the hand-written kernels
it already launches: the same launches, on the same buffers, with the host
ints of every launch (offsets, grids, byte counts) fixed at capture. A
replay issues them all with one call, so the host's 30-60 µs per wrapper
call goes away; nothing in a kernel changes.

:class:`Graph` captures a function on one CUDA device and replays it. A
capture launches nothing, so the port's launch counters
(:func:`launch_counters`) are put back to what they held before it, and
each replay adds the counts the capture recorded: a counter still means
launches on the card. A capture that fails raises; there is no eager
fallback.

Rules for a captured function (the callers, ``gkr/fused.py`` and
``ops/fs_kernel.py``, keep them): it runs once eagerly first, so that every
lazy step (a library load, a ticket counter, a device wiring, an index
tensor, an occupancy query) is done before the capture; it reads and
writes only buffers that outlive the graph; every host int it bakes in is
part of the caller's key for the graph.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Tuple

import torch

_PACKAGE = __name__.split(".")[0]


def launch_counters() -> List[Dict[str, int]]:
    """Every launch counter of the port: the module-level dicts named
    ``*launches`` of its imported modules (``cuda_round.launches``,
    ``gkr_tail.tail_launches``, ...)."""
    out = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == _PACKAGE or name.startswith(_PACKAGE + ".")):
            continue
        out += [v for attr, v in vars(mod).items() if attr.endswith("launches") and isinstance(v, dict)]
    return out


class Graph:
    """``fn``'s launches on the CUDA device ``dev``, captured at
    construction (on a capture stream of that device, into the graph's own
    memory pool) and replayed by :meth:`replay` on the device's current
    stream. ``replays``: the replays so far; ``pool_bytes``: the device
    memory the capture reserved for the graph's own tensors."""

    def __init__(self, dev: torch.device, fn: Callable[[], None]):
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph is captured on a CUDA device, not {dev}")
        self.dev = dev
        counters = launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev):
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()  # as the capture does, so that the difference below is the pool
            reserved = torch.cuda.memory_reserved(dev)
            try:
                with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev)):
                    fn()
            finally:
                self._counts: List[Tuple[Dict[str, int], Dict[str, int]]] = []
                for c, b in zip(counters, before):
                    delta = {key: c[key] - b.get(key, 0) for key in c if c[key] != b.get(key, 0)}
                    c.clear()
                    c.update(b)
                    if delta:
                        self._counts.append((c, delta))
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph = graph
        self.replays = 0

    def replay(self) -> None:
        """Replay the captured launches on ``dev``'s current stream and
        count them."""
        with torch.cuda.device(self.dev):
            self.graph.replay()
        self.replays += 1
        for c, delta in self._counts:
            for key, v in delta.items():
                c[key] += v
