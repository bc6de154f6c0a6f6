"""Field-operation counters — the criterion-throughput analogue.

The reference's only perf instrumentation is criterion wall-clock with
``Throughput::Elements`` (matrix-multiplication/benches/mm_benchmark.rs:85).
Here we additionally model the exact number of field multiplications each
fused round kernel performs, so the benchmark can report field-ops/s per
chip against the speed-of-light estimate (BASELINE.md north-star metric).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..ops.round_kernel import PolySpec


@dataclasses.dataclass
class OpCounts:
    field_muls: int = 0
    field_adds: int = 0

    def reset(self):
        self.field_muls = 0
        self.field_adds = 0


COUNTS = OpCounts()


def _grid_size(spec, term) -> int:
    blocks = set()
    for k in term:
        blocks.update(spec.table_blocks[k])
    return 1 << sum(spec.block_sizes[b] for b in blocks)


def count_round(spec: "PolySpec", fold: bool, claim_known: bool = False):
    """Model the field ops of one fused round (fold + partial sums).

    ``claim_known``: the round claim c = g_prev(r_prev) is available, so
    the kernel derives s(1) = c - s(0) instead of running the t = 1
    hypercube pass (ops/round_kernel._round_sums claim shortcut) — the
    modeled ops shrink accordingly so field-ops/s stays an honest measure
    of work actually performed."""
    degree = spec.degree()
    t_passes = degree if (claim_known and degree >= 1) else degree + 1
    muls = 0
    adds = 0
    if fold:
        for tb in spec.table_blocks:
            if 0 in tb:
                n = 1 << sum(spec.block_sizes[b] for b in tb)
                muls += n // 2  # (hi-lo)*r
                adds += n  # sub + add
    for term in spec.terms:
        half_grid = _grid_size(spec, term) // 2
        # product: (len(term)-1) muls per grid point per t value
        muls += t_passes * max(len(term) - 1, 0) * half_grid
        # tree reduction: ~1 add per element per t value
        adds += t_passes * 2 * half_grid
    COUNTS.field_muls += muls
    COUNTS.field_adds += adds
