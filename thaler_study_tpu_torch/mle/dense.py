"""Dense multilinear extensions over the boolean hypercube.

Counterpart of ``thaler_study_tpu/mle/dense.py`` (ark-poly's
``DenseMultilinearExtension``, used by the reference at
gkr-protocol/src/lib.rs:378-416 and matrix-multiplication/src/lib.rs:81-92).
A :class:`DenseMLE` is a 2^n evaluation table held as an :class:`FArray`.

Variable order, as in the JAX package: arkworks indexes evaluations
little-endian (bit j of the index is variable x_j); internally the table is
stored bit-reversed, variable 0 the most significant index bit, so folding
variable 0 combines the two contiguous halves
``t' = lo + r * (hi - lo)`` and variable 1 is then the new MSB. Conversions
happen only at the constructors and ``to_evaluations``.

On the card the bit reversal (:func:`bitrev`), the fold chain
(``fix_variables``, ``evaluate``) and the evaluation at many points
(``evaluate_many``) are hand-written kernels, ``csrc/mle.cu`` through
``ops/mle_kernel.py`` (the JAX package's jnp programs ``_device_bitrev``,
``_fold_impl`` and ``_eval_many_impl``); on the CPU their plain versions.
``relabel`` is one permute copy and :func:`fold_msb` one fold, both plain
torch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..fields import FArray, Felt, FieldConfig
from ..ops import mle_kernel


def bitrev_perm(n: int) -> np.ndarray:
    """The bit-reversal permutation on [0, 2^n) as int64: rev_n is
    (2 rev_{n-1}, 2 rev_{n-1} + 1), built by doubling in O(2^n)."""
    rev = np.zeros(1, dtype=np.int64)
    for _ in range(n):
        rev = np.concatenate([2 * rev, 2 * rev + 1])
    return rev


def bitrev(table: FArray, n: int) -> FArray:
    """Bit-reverse a 2^n-entry table on its device (an involution: label
    order <-> internal MSB-first order): on the card one launch of the
    bit-reversal kernel (``ops/mle_kernel.bitrev``), no index tensor."""
    return mle_kernel.bitrev(table, n)


class DenseMLE:
    """A dense MLE table (internal MSB-first variable order)."""

    __slots__ = ("evals", "num_vars")

    def __init__(self, evals: FArray, num_vars: int):
        if evals.shape != (1 << num_vars,):
            raise ValueError(f"a {num_vars}-variable MLE takes {1 << num_vars} evaluations, got {evals.shape}")
        self.evals = evals
        self.num_vars = num_vars

    @property
    def field(self) -> FieldConfig:
        return self.evals.field

    # ---- constructors ----
    @classmethod
    def from_evals_lsb(cls, values, num_vars: int, field: FieldConfig, device="cuda") -> "DenseMLE":
        """From evaluations in arkworks index order (index bit j = var x_j):
        ints, Felts or a numpy integer array. The bit reversal runs on
        ``device``."""
        if not isinstance(values, np.ndarray) and len(values) > 0 and isinstance(values[0], Felt):
            values = [v.v for v in values]
        table = FArray.from_ints(values, field, device=device)
        if table.shape != (1 << num_vars,):
            raise ValueError(f"a {num_vars}-variable MLE takes {1 << num_vars} evaluations, got {table.shape}")
        return cls(bitrev(table, num_vars), num_vars)

    @classmethod
    def from_evals_lsb_farray(cls, evals: FArray, num_vars: int) -> "DenseMLE":
        """From a table already on its device in arkworks order: the bit
        reversal runs there."""
        if evals.shape != (1 << num_vars,):
            raise ValueError(f"a {num_vars}-variable MLE takes {1 << num_vars} evaluations, got {evals.shape}")
        return cls(bitrev(evals, num_vars), num_vars)

    @classmethod
    def from_evals_msb(cls, evals: FArray, num_vars: int) -> "DenseMLE":
        """From a table already in internal (MSB-first) order."""
        return cls(evals, num_vars)

    # ---- core ops ----
    def fix_variables(self, rs: Sequence[Felt]) -> "DenseMLE":
        """Fold the first ``len(rs)`` variables at the given points
        (arkworks ``fix_variables``; e.g. matrix-multiplication/src/lib.rs:83-86):
        one launch of the fold kernel on the card."""
        if not rs:
            return self
        if len(rs) > self.num_vars:
            raise ValueError(f"{len(rs)} points for a {self.num_vars}-variable MLE")
        r = FArray.from_felts(list(rs), self.field, device=self.evals.device)
        return DenseMLE(mle_kernel.fold(self.evals, r, len(rs)), self.num_vars - len(rs))

    def evaluate(self, point: Sequence[Felt]) -> Felt:
        """Evaluate the MLE at a field point (fold every variable)."""
        if len(point) != self.num_vars:
            raise ValueError(f"a point of {len(point)} coordinates for {self.num_vars} variables")
        return self.fix_variables(list(point)).evals.item()

    def evaluate_many(self, points: Sequence[Sequence[Felt]]) -> list:
        """Evaluate at P points (the JAX package's ``_eval_many_impl``; GKR's
        ``restrict_poly`` needs n + 1 line points per layer): one launch of
        the fold kernel's evaluation form on the card, one host read."""
        if any(len(pt) != self.num_vars for pt in points):
            raise ValueError(f"every point needs {self.num_vars} coordinates")
        if not points:
            return []
        if self.num_vars == 0:
            v = self.evals.item()
            return [v for _ in points]
        flat = [f.v for pt in points for f in pt]
        rs = FArray.from_ints(flat, self.field, device=self.evals.device).reshape(len(points), self.num_vars)
        return mle_kernel.eval_many(self.evals, rs).to_felts()

    def relabel(self, a: int, b: int, k: int) -> "DenseMLE":
        """Swap the variable blocks [a, a+k) and [b, b+k) (ark-poly
        ``relabel``; the matmul IP moves A's row variables first with it,
        matrix-multiplication/src/lib.rs:82). The blocks must not overlap.
        The table is viewed with each block as one axis, so a swap is one
        five-axis permute at any number of variables."""
        n = self.num_vars
        lo, hi = min(a, b), max(a, b)
        if k < 0 or lo < 0 or hi + k > n or (lo != hi and lo + k > hi):
            raise ValueError(f"relabel({a}, {b}, {k}) of a {n}-variable MLE")
        if k == 0 or lo == hi:
            return DenseMLE(self.evals, n)
        shape = (1 << lo, 1 << k, 1 << (hi - lo - k), 1 << k, 1 << (n - hi - k))
        data = self.evals.data.reshape(shape).permute(0, 3, 2, 1, 4).reshape(-1)
        return DenseMLE(FArray(data, self.field), n)

    def sum(self) -> Felt:
        """Sum of all evaluations over the hypercube (the sumcheck C_1)."""
        return self.evals.sum(axis=0).item()

    def to_evaluations(self) -> list:
        """Host Felts in arkworks (little-endian) index order."""
        ints = self.evals.to_u64()[bitrev_perm(self.num_vars)]  # an involution
        return [Felt(int(v), self.field) for v in ints]

    def to_evals_lsb_farray(self) -> FArray:
        """The table in arkworks order, on its device (the bit reversal)."""
        return bitrev(self.evals, self.num_vars)

    def __repr__(self):
        return f"DenseMLE(n={self.num_vars}, {self.field.name})"


def fold_msb(table: FArray, r: FArray) -> FArray:
    """One fold step, t' = lo + r (hi - lo), halving the table (the
    reference's even/odd pair identity, matrix-multiplication/src/lib.rs:
    114-122, in contiguous-halves form). ``r`` is a 0-d FArray."""
    half = table.shape[0] // 2
    return FArray.fold(table[:half], table[half:], r)
