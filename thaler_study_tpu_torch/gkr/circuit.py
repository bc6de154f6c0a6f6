"""Layered arithmetic circuits for GKR (ref: gkr-protocol/src/circuit.rs).

Counterpart of ``thaler_study_tpu/gkr/circuit.py``. A circuit is a list of
fan-in-2 layers stored output-first, input-last (ref :72-79), each gate
naming two input labels in the next layer. Layer sizes must be powers of
two (``num_vars_at`` uses trailing_zeros like the reference :86-96).

Two evaluation paths:

- :meth:`Circuit.evaluate`: host values, the reference's layer loop
  (ref :99-124);
- :meth:`Circuit.evaluate_device`: the forward pass on the tensor's device,
  per layer two gathers, an add, a product and a select (plain torch,
  exact), over wiring uploaded once per circuit and device and cached.

The wiring arrays (``_wiring``) and their device copies with the static
plans of the phase-table scatter-adds (``device_wiring``) are what the
LibraW prover and the sparse verifier read; ``add_i_ext`` / ``mul_i_ext``
build the dense-W prover's wiring tables from them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Sequence

import numpy as np
import torch

from ..fields import FArray


class GateType(enum.Enum):
    ADD = "add"
    MUL = "mul"


@dataclasses.dataclass(frozen=True)
class Gate:
    """A fan-in-2 gate: type + two input labels into the next layer
    (ref circuit.rs:18-31)."""

    ttype: GateType
    inputs: tuple

    def __init__(self, ttype: GateType, inputs):
        object.__setattr__(self, "ttype", ttype)
        object.__setattr__(self, "inputs", tuple(inputs))


class CircuitLayer:
    """One layer of gates (ref circuit.rs:35-53)."""

    def __init__(self, gates: Sequence[Gate]):
        self.gates = list(gates)

    def __len__(self):
        return len(self.gates)


class CircuitEvaluation:
    """Per-layer value vectors, output layer first (ref circuit.rs:58-68)."""

    def __init__(self, layers: List[list]):
        self.layers = layers

    def w(self, layer: int, label: int):
        return self.layers[layer][label]


@dataclasses.dataclass
class PhasePlan:
    """The static plan of one phase-table scatter-add (kernel K2), in the
    tables' output order: ``order`` (int32 [g]) lists the gates so that
    those of output position ``pos`` = bitrev_k(key) are contiguous, in
    ascending pos; ``starts`` (int32 [2^k + 1]) is the first listed
    position of each pos; ``packed`` (int32 [g]) is the gather index of
    gate ``order[s]`` with its type in bit 31 (1 = MUL). It depends only on
    the circuit, so it is made once per circuit and device."""

    order: torch.Tensor
    starts: torch.Tensor
    packed: torch.Tensor


@dataclasses.dataclass
class LayerWiring:
    """One layer's wiring on a device: input labels, gate types, and the
    plans of the two phase-table scatter-adds: phase 1 keyed on b and
    gathering at c, phase 2 keyed on c and gathering at b."""

    b: torch.Tensor  # int32 [g]
    c: torch.Tensor  # int32 [g]
    is_mul: torch.Tensor  # bool [g]
    plan1: PhasePlan
    plan2: PhasePlan


def scan_plan(idx: torch.Tensor, size: int):
    """The sort structure of a scatter-add keyed on ``idx``: ``order``
    (int32 [g]) lists the gates so that equal cells are contiguous (a
    stable sort), ``starts`` (int32 [size + 1]) the first sorted position
    of each cell, cumulative-count form (the JAX package's host
    ``scan_plan``, ``gkr/device_tables.py:163``, made on the tensor's
    device)."""
    order = torch.argsort(idx, stable=True).to(torch.int32)
    counts = torch.bincount(idx.to(torch.int64), minlength=size)
    starts = torch.zeros(size + 1, dtype=torch.int64, device=idx.device)
    starts[1:] = torch.cumsum(counts, 0)
    return order, starts.to(torch.int32)


def phase_plan(key: torch.Tensor, gather_idx: torch.Tensor, is_mul: torch.Tensor, k: int) -> PhasePlan:
    """The :class:`PhasePlan` of a scatter-add keyed on ``key`` over 2^k
    cells (labels < 2^k <= 2^30): :func:`scan_plan` keyed on bitrev_k(key),
    and the gather index and gate type permuted into its order."""
    key = key.to(torch.int64)
    pos = torch.zeros_like(key)
    for j in range(k):
        pos |= ((key >> j) & 1) << (k - 1 - j)
    order, starts = scan_plan(pos, 1 << k)
    idx = order.to(torch.int64)
    packed = gather_idx.to(torch.int64)[idx] - (is_mul[idx].to(torch.int64) << 31)  # bit 31 of the int32
    return PhasePlan(order, starts, packed.to(torch.int32))


def layer_wiring(b: torch.Tensor, c: torch.Tensor, is_mul: torch.Tensor, k: int) -> LayerWiring:
    """A :class:`LayerWiring` on the tensors' device (b, c int32 labels
    below 2^k, is_mul bool)."""
    return LayerWiring(b, c, is_mul, phase_plan(b, c, is_mul, k), phase_plan(c, b, is_mul, k))


class Circuit:
    """A layered circuit; layer 0 is the output layer (ref circuit.rs:72-79)."""

    def __init__(self, layers: Sequence[CircuitLayer], num_inputs: int):
        self.layers = list(layers)
        self.num_inputs = num_inputs
        self._wiring = [
            (
                np.array([g.inputs[0] for g in l.gates], dtype=np.int32),
                np.array([g.inputs[1] for g in l.gates], dtype=np.int32),
                np.array([g.ttype is GateType.MUL for g in l.gates], dtype=bool),
            )
            for l in self.layers
        ]
        self._dev_wiring = {}

    # ---- shape queries ----
    def num_vars_at(self, layer: int):
        """log2 of the layer size via trailing_zeros (ref :86-96; requires
        power-of-two layers, like the reference)."""
        if layer < len(self.layers):
            n = len(self.layers[layer])
        elif layer == len(self.layers):
            n = self.num_inputs
        else:
            return None
        return (n & -n).bit_length() - 1

    def num_outputs(self) -> int:
        return len(self.layers[0])

    # ---- evaluation ----
    def evaluate(self, inputs: Sequence) -> CircuitEvaluation:
        """Host forward pass, the reference's layer loop (ref :99-124)."""
        layers = [list(inputs)]
        current = list(inputs)
        for layer in reversed(self.layers):
            nxt = []
            for g in layer.gates:
                a, b = current[g.inputs[0]], current[g.inputs[1]]
                nxt.append(a * b if g.ttype is GateType.MUL else a + b)
            layers.append(nxt)
            current = nxt
        layers.reverse()
        return CircuitEvaluation(layers)

    def device_wiring(self, i: int, device) -> LayerWiring:
        """Layer i's wiring on ``device``, uploaded (and its phase plans
        made) once per circuit and device."""
        dev = torch.device(device)
        key = (i, dev.type, dev.index)
        w = self._dev_wiring.get(key)
        if w is None:
            b_idx, c_idx, is_mul = self._wiring[i]
            size = 1 << self.num_vars_at(i + 1)
            # the gathers and the phase-table kernel index by these labels
            if any(len(x) and (x.min() < 0 or x.max() >= size) for x in (b_idx, c_idx)):
                raise ValueError(f"layer {i} wires an input label outside layer {i + 1}'s {size} values")
            w = layer_wiring(*(torch.from_numpy(x).to(dev) for x in (b_idx, c_idx, is_mul)), self.num_vars_at(i + 1))
            self._dev_wiring[key] = w
        return w

    def evaluate_device(self, inputs: FArray) -> List[FArray]:
        """The forward pass on ``inputs``' device: per layer, two gathers,
        an add, a product and a select. Returns per-layer FArrays, output
        layer first, in label order (position = gate label)."""
        out = [inputs]
        cur = inputs
        for i in reversed(range(len(self.layers))):
            w = self.device_wiring(i, inputs.device)
            lhs = FArray(torch.index_select(cur.data, 0, w.b), cur.field)
            rhs = FArray(torch.index_select(cur.data, 0, w.c), cur.field)
            cur = FArray(torch.where(w.is_mul, (lhs * rhs).data, (lhs + rhs).data), cur.field)
            out.append(cur)
        out.reverse()
        return out

    # ---- wiring predicates ----
    def add_i(self, i: int, a: int, b: int, c: int) -> bool:
        g = self.layers[i].gates[a]
        return g.ttype is GateType.ADD and g.inputs == (b, c)

    def mul_i(self, i: int, a: int, b: int, c: int) -> bool:
        g = self.layers[i].gates[a]
        return g.ttype is GateType.MUL and g.inputs == (b, c)

    def _wiring_ext(self, r_i: Sequence, i: int, want_mul: bool, field, device="cuda"):
        """add~_i / mul~_i fixed at r_i, as a dense MLE over (b, c) on
        ``device``.

        Sparse construction on the host runtime: the eq table over the
        layer-i variables at each gate's output label, scattered into the
        (b, c) grid at ((c << k) | b) — the index layout the reference's
        dense triple loop produces (circuit.rs:163-173: a innermost, then b,
        then c) — then one upload and the bit reversal on ``device``.
        """
        from .. import runtime
        from ..mle.dense import DenseMLE

        k_next = self.num_vars_at(i + 1)
        b_idx, c_idx, is_mul = self._wiring[i]
        w = runtime.eq_table([f.v for f in r_i], field.p)
        grid = runtime.wiring_scatter(b_idx, c_idx, is_mul == want_mul, w[: len(b_idx)], k_next, field.p)
        return DenseMLE.from_evals_lsb(grid, 2 * k_next, field, device=device)

    def add_i_ext(self, r_i: Sequence, i: int, device="cuda"):
        """Dense MLE of add_i fixed at r_i (ref circuit.rs:152-181)."""
        return self._wiring_ext(r_i, i, False, r_i[0].field, device=device)

    def mul_i_ext(self, r_i: Sequence, i: int, device="cuda"):
        """Dense MLE of mul_i fixed at r_i (ref circuit.rs:183-212)."""
        return self._wiring_ext(r_i, i, True, r_i[0].field, device=device)


def circuit_from_book() -> Circuit:
    """Thaler fig. 4.12 test circuit (ref circuit.rs:215-253)."""
    return Circuit(
        [
            CircuitLayer([Gate(GateType.MUL, (0, 1)), Gate(GateType.MUL, (2, 3))]),
            CircuitLayer(
                [
                    Gate(GateType.MUL, (0, 0)),
                    Gate(GateType.MUL, (1, 1)),
                    Gate(GateType.MUL, (1, 2)),
                    Gate(GateType.MUL, (3, 3)),
                ]
            ),
        ],
        4,
    )
