"""Layered arithmetic circuits for GKR (ref: gkr-protocol/src/circuit.rs).

Counterpart of ``thaler_study_tpu/gkr/circuit.py``. A circuit is a list of
fan-in-2 layers stored output-first, input-last (ref :72-79), each gate
naming two input labels in the next layer. Layer sizes must be powers of
two (``num_vars_at`` uses trailing_zeros like the reference :86-96).

Two evaluation paths:

- :meth:`Circuit.evaluate`: host values, the reference's layer loop
  (ref :99-124);
- :meth:`Circuit.evaluate_device`: the forward pass on the tensor's device,
  one launch of the forward kernel per layer on the card
  (``ops/forward_kernel.py``; on the CPU its plain version: two gathers,
  an add, a product and a select), over wiring uploaded once per circuit
  and device and cached.

The wiring arrays (``_wiring``) and their device copies with the static
plans of the phase-table scatter-adds (``device_wiring``; a plan per
phase and group of shard rows, made at first use) are what the
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
from ..ops.forward_kernel import forward_layer


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
    """The static plan of one phase-table scatter-add (kernel K2) over a
    group of shard rows, in the order the tables are laid out: ``order``
    (int32 [g']) lists the group's g' gates so that those of output
    position ``pos`` are contiguous, in ascending pos (and ascending gate
    within a pos); ``starts`` (int32 [positions + 1]) is the first listed
    position of each pos; ``packed`` (int32 [g']) is the gather index of
    gate ``order[s]`` with its type in bit 31 (1 = MUL). A cell at
    MSB-first position x = bitrev_k(key) lies in shard row x mod 2^n_shard
    at column x >> n_shard (``parallel/sharded.py``'s layout), and the
    group's rows row0 .. row0 + rows - 1 are listed row by row: pos =
    (row - row0) 2^(k - n_shard) + column. The unsharded plan is n_shard =
    0, one row (pos = x). It depends only on the circuit, so it is made
    once per circuit, device and group."""

    order: torch.Tensor
    starts: torch.Tensor
    packed: torch.Tensor


class LayerWiring:
    """One layer's wiring on a device: input labels, gate types, and the
    plans of the two phase-table scatter-adds (phase 1 keyed on b and
    gathering at c, phase 2 keyed on c and gathering at b), each made at
    its first use per group of shard rows (:meth:`plan`)."""

    def __init__(self, b: torch.Tensor, c: torch.Tensor, is_mul: torch.Tensor, k: int):
        self.b, self.c, self.is_mul, self.k = b, c, is_mul, k  # int32 [g], int32 [g], bool [g]
        self._plans = {}

    def plan(self, phase: int, n_shard: int = 0, row0: int = 0, rows: int = 1) -> PhasePlan:
        """The :class:`PhasePlan` of ``phase`` over shard rows row0 ..
        row0 + rows - 1 of 2^n_shard (the whole table by default)."""
        key = (phase, n_shard, row0, rows)
        plan = self._plans.get(key)
        if plan is None:
            key_t, gidx = (self.b, self.c) if phase == 1 else (self.c, self.b)
            plan = self._plans[key] = phase_plan(key_t, gidx, self.is_mul, self.k, n_shard, row0, rows)
        return plan


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


def phase_plan(key: torch.Tensor, gather_idx: torch.Tensor, is_mul: torch.Tensor, k: int, n_shard: int = 0,
               row0: int = 0, rows: int = 1) -> PhasePlan:
    """The :class:`PhasePlan` of a scatter-add keyed on ``key`` over 2^k
    cells (labels < 2^k <= 2^30) for shard rows row0 .. row0 + rows - 1 of
    2^n_shard: the gates whose cell lies in those rows, :func:`scan_plan`
    keyed on their position in the group's layout, and the gather index and
    gate type permuted into its order."""
    if not 0 <= n_shard <= k or rows < 1 or not 0 <= row0 <= (1 << n_shard) - rows:
        raise ValueError(f"rows {row0}..{row0 + rows - 1} are not shard rows of 2^{n_shard} over {k} variables")
    key = key.to(torch.int64)
    x = torch.zeros_like(key)
    for j in range(k):
        x |= ((key >> j) & 1) << (k - 1 - j)
    row = (x & ((1 << n_shard) - 1)) - row0
    gates = torch.nonzero((row >= 0) & (row < rows)).reshape(-1)
    pos = (row[gates] << (k - n_shard)) | (x[gates] >> n_shard)
    order, starts = scan_plan(pos, rows << (k - n_shard))
    idx = gates[order.to(torch.int64)]
    packed = gather_idx.to(torch.int64)[idx] - (is_mul[idx].to(torch.int64) << 31)  # bit 31 of the int32
    return PhasePlan(idx.to(torch.int32), starts, packed.to(torch.int32))


def layer_wiring(b: torch.Tensor, c: torch.Tensor, is_mul: torch.Tensor, k: int) -> LayerWiring:
    """A :class:`LayerWiring` on the tensors' device (b, c int32 labels
    below 2^k, is_mul bool)."""
    return LayerWiring(b, c, is_mul, k)


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
        """Layer i's wiring on ``device``, uploaded once per circuit and
        device (its phase plans are made at their first use)."""
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
        """The forward pass on ``inputs``' device: one
        :func:`ops.forward_kernel.forward_layer` per layer (on the card one
        launch of ``csrc/forward.cu``). Returns per-layer FArrays, output
        layer first, in label order (position = gate label)."""
        out = [inputs]
        cur = inputs
        for i in reversed(range(len(self.layers))):
            w = self.device_wiring(i, inputs.device)
            cur = forward_layer(cur, w.b, w.c, w.is_mul)
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
