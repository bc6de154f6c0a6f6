"""Standalone MLE evaluation algorithms.

Counterpart of ``thaler_study_tpu/mle/algorithms.py``, the two algorithms
of the reference's ``multilinear-extensions`` crate:

- :func:`vsbw_multilinear_from_evaluations`
  (multilinear-extensions/src/lib.rs:6-24): build the full 2^n table of
  Lagrange-basis weights (:func:`eq_weight_table`), then inner-product it
  with the evaluations. O(2^n) time and memory.
- :func:`cti_multilinear_from_evaluations`
  (multilinear-extensions/src/lib.rs:29-48): stream over the evaluation
  indices, weighting each by eq(r, bits(i)), on the host. O(2^n n) time.

Both take evaluations in the crate's big-endian index order (variable 0
the most significant index bit, the internal order of ``DenseMLE``) and
agree with each other and with :meth:`DenseMLE.evaluate`. On a CUDA device
the weight table is the eq-table kernel of ``csrc/gkr_tables.cu``
(``gkr.device_tables.eq_table_dev``); the rest is plain torch. Dimensions
are checked (the reference's guard at :51 compares ``x.len() != x.len()``).
"""

from __future__ import annotations

from typing import Sequence

from ..fields import FArray, Felt


def eq_weight_table(point: Sequence[Felt], *, lsb_order: bool = True, device="cuda") -> FArray:
    """The 2^n table of Lagrange basis weights eq(point, w), w in {0,1}^n.

    With ``lsb_order=True`` the index order is arkworks' (index bit j =
    variable j); otherwise internal MSB-first order (variable 0 = the most
    significant bit), which is the little-endian table of the reversed
    point. CPU tensors run the eq table's plain version, CUDA tensors its
    kernel."""
    from ..gkr.device_tables import eq_table_dev  # gkr imports mle

    field = point[0].field
    coords = list(point) if lsb_order else list(reversed(point))
    return eq_table_dev(FArray.from_felts(coords, field, device=device), len(coords))


def _check_dims(evals: Sequence[Felt], r: Sequence[Felt]) -> None:
    if len(evals) != 1 << len(r):
        raise ValueError(f"{len(evals)} evaluations for a {len(r)}-variable MLE")


def vsbw_multilinear_from_evaluations(evals: Sequence[Felt], r: Sequence[Felt], device="cuda") -> Felt:
    """Table-based MLE evaluation (ref multilinear-extensions/src/lib.rs:6-24):
    the big-endian weight table inner-producted with the evaluations, on
    ``device``."""
    _check_dims(evals, r)
    field = r[0].field
    table = eq_weight_table(r, lsb_order=False, device=device)
    ev = FArray.from_felts(list(evals), field, device=device)
    return (table * ev).sum(axis=0).item()


def cti_multilinear_from_evaluations(evals: Sequence[Felt], r: Sequence[Felt]) -> Felt:
    """Streaming MLE evaluation (ref multilinear-extensions/src/lib.rs:29-48)
    on the host, as in the reference: index bits decoded big-endian
    (:37-42), so bit j of i pairs with r[n - 1 - j]."""
    _check_dims(evals, r)
    field = r[0].field
    n = len(r)
    acc = field.zero()
    one = field.one()
    for i, ev in enumerate(evals):
        w = [(one if (i >> j) & 1 else field.zero()) for j in reversed(range(n))]
        basis = one
        for x_i, w_i in zip(r, w):
            basis = basis * (x_i * w_i + (one - x_i) * (one - w_i))
        acc = acc + ev * basis
    return acc
