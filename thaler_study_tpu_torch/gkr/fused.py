"""Fused non-interactive GKR proving: each layer's rounds with no host read.

Counterpart of ``thaler_study_tpu/gkr/fused.py``. The per-layer path
(``gkr/transcript.generate_gkr_transcript``) reads each round's sums back
to the host, interpolates and hashes there: 2k host reads per layer. Here
every layer is issued from Python as a fixed sequence of launches, and its
scalars (claims, challenges, the chain's state, r_{i+1}) stay on the card:

- phase 1: the eq table of r_i over k_cur variables, the phase-1 tables
  (K2), then k rounds of K1 with the round tail as its epilogue (one
  launch each), the first also writing StartSumCheck;
- phase 2: the eq table of u with W~(u) in the same launch (kept on the
  card as K1's phase-2 scalar), the phase-2 tables (K2), k - 1 rounds of
  K1 with the round tail, the second-to-last message drawing r_{2k-2} and
  r_last, then the final K1, the line restriction (its tiles read u and c
  from the layer's challenge vector and form c - u themselves) and the
  final tail (the FinalRoundMessage, r* and r_{i+1} = u + (c - u) r*).

The tails (``ops/gkr_tail.py``) write every message into one byte buffer
on the card. After the Begin message, which the host serializes and whose
midstate it takes with the native runtime, the proof has one
device-to-host read: all layers' transcript bytes and the zero flag. The
host only slices the messages out of it. Output is byte-identical to
``generate_gkr_transcript``.

With ``mesh=`` (a ``parallel`` mesh; the JAX package runs the same layer
programs under GSPMD, ``_mesh_put``) a layer whose 2^k values divide over
the mesh (k >= n_shard = log2 of its size) has its phase tables in the
sharded layout of ``parallel/sharded.py``, and smaller layers run as
above on the mesh's first device, in the same proof (:class:`_ShardedLayer`
says how a sharded layer runs). The tail state (chain, bytes, claim,
challenges, zero flag) stays on the first device, replicated per process;
every cross-device move is counted: the reductions and gathers in
``parallel.sharded.collectives``, the challenges sent to the other
devices in ``parallel.sharded.sends``.

As in the JAX package, the fixed message lengths assume every serialized
coefficient is nonzero (arkworks drops zero terms); a zero is flagged on
the card and the proof is redone on the per-layer path.

Without ``mesh=`` the proof runs as one program, the port's form of the
JAX package's layer scan (``_scan_proof_jit``): a :class:`_Program` per
circuit, device, field and Begin length holds the state above and a static
copy of the layer values; each proof binds its inputs (one host-to-device
copy of the chain and r_0, one device-to-device copy per layer) and, after
the circuit's first proof, replays the layer loop as one CUDA graph
(``ops/graphs.py``).

Scope (``supports_fused_gkr``): Goldilocks, the empty DST, every layer with
k >= 2 variables. Every other input takes the per-layer path, on the
prover's device and mesh. Not ported: the ``interp`` line restriction and
the ``plan`` / ``segment`` scatter modes (A/B switches), and
``_pack_outputs`` (the transcript bytes are written on the card).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from .. import _build
from ..fields import FArray, FieldConfig
from ..mle.dense import bitrev_perm
from ..ops import graphs
from ..ops.cuda_round import LIBRA_PHASE1, LIBRA_PHASE2, libra_round_total, round_partials
from ..ops.gkr_tail import (
    ROUND_LEN,
    START_LEN,
    GKRChain,
    LayerTail,
    RoundTail,
    final_len,
    final_tail,
    libra_round_tail,
    midstate,
    round_tail,
)
from ..ops.sha_chain import draw_many_py
from ..parallel.sharded import _check_shards, collective, send
from .device_tables import (
    eq_table_dev,
    eq_table_dot,
    line_restrict_chal,
    lsb_to_msb,
    phase1_tables,
    phase2_tables,
    phase_tables_rows,
)
from .transcript import GKRTranscript, generate_gkr_transcript, serialize_gkr_message

# proofs routed to the per-layer path: unsupported inputs and zero flags
fallbacks = 0


def supports_fused_gkr(circuit, field: FieldConfig, dst: bytes) -> bool:
    """Goldilocks, the empty DST and k >= 2 variables in every layer's
    inputs (``thaler_study_tpu/gkr/fused.py:500``)."""
    if dst != b"" or field.backend != "goldilocks":
        return False
    return all(circuit.num_vars_at(i + 1) >= 2 for i in range(len(circuit.layers)))


def _layer_lens(k: int) -> List[int]:
    """Message lengths of one layer: StartSumCheck with the first round
    message (one tail launch), 2k - 2 more round messages, the final one."""
    return [START_LEN, ROUND_LEN] + [ROUND_LEN] * (2 * k - 2) + [final_len(k)]


class _Layer:
    """One layer's state on the card: what its round tails read and write
    (``ops/gkr_tail.LayerTail``: the chain, the transcript bytes, the zero
    flag, the running claim, the challenge vector u then c, the round
    kernel's ticket counter), the write position in the transcript bytes,
    and the proof's ping-pong buffers for the folded tables. ``w_lsb``:
    the layer's input values (label order) on the tail's device."""

    def __init__(self, circuit, i: int, chain, msgs, zero, counter, bufs, off: int, w_lsb: FArray):
        self.i, self.k, self.k_cur = i, circuit.num_vars_at(i + 1), circuit.num_vars_at(i)
        self.w_lsb = w_lsb
        self.field = self.w_lsb.field
        dev = self.w_lsb.device
        self.wiring = circuit.device_wiring(i, dev)
        self.tail = LayerTail(chain, msgs, zero, torch.empty(1, dtype=torch.int64, device=dev),
                              torch.empty(2 * self.k, dtype=torch.int64, device=dev), counter)
        self.chal, self.claim = self.tail.chal, self.tail.claim
        self.bufs, self.off = bufs, off

    def _out(self, tables, j: int):
        """Round j's fold target: the halves land in ping-pong buffer
        (j - 1) % 2 (the previous fold's output is in the other one)."""
        n = tables[0].shape[1] // 2
        return [b[(j - 1) % 2][:n].view(1, n) for b in self.bufs]

    def round(self, tables, j: int, r, skip_t1: bool, phase: int, scalars, chal_idx: int, draws: int, start=None):
        """Inner round j of a phase: K1 with the round tail as its epilogue;
        returns the folded tables (or the input tables for a round without
        a fold)."""
        tail = RoundTail(self.tail, self.off, chal_idx, draws, start)
        out = None if r is None else self._out(tables, j)
        folded, _ = libra_round_tail(tables, r, skip_t1, phase, scalars, tail, out)
        self.off += tail.length
        return folded or tables

    def phase1(self, r_i: FArray):
        """Eq table, phase-1 tables, k rounds: the challenges u go to
        chal[:k]; returns (W in MSB-first order, eq_r)."""
        a1, a2, eq_r = phase1_tables(r_i, self.w_lsb, self.wiring, self.k_cur, self.k)
        w_msb = lsb_to_msb(self.w_lsb, self.k)
        self._phase1_rounds([t.data.reshape(1, -1) for t in (w_msb, a1, a2)], 0)
        return w_msb, eq_r

    def _phase1_rounds(self, tables, j0: int) -> None:
        """Phase 1's rounds j0..k-1 on the tail's device, over ``tables`` as
        they stand before round j0 (folded at r_{j0-1} by it)."""
        for j in range(j0, self.k):
            r = None if j == 0 else self.chal[j - 1 : j]
            start = (self.i, self.k) if j == 0 else None
            tables = self.round(tables, j, r, j > 0, 1, [], j, 1, start)

    def phase2(self, w_msb: FArray, eq_r: FArray) -> FArray:
        """Eq table of u, phase-2 tables and W~(u), k - 1 rounds, the final
        round, the line restriction and the final tail: the challenges c go
        to chal[k:]; returns r_{i+1}."""
        u = FArray(self.chal[: self.k], self.field)
        b1, b2, w_u = phase2_tables(u, self.w_lsb, eq_r, self.wiring, self.k)
        return self._phase2_rounds([t.data.reshape(1, -1) for t in (b1, b2, w_msb)], 0, w_u)

    def _phase2_rounds(self, tables, j0: int, w_u: FArray) -> FArray:
        """Phase 2's rounds j0..k-2, the final round, the line restriction
        and the final tail on the tail's device; returns r_{i+1}."""
        k, field, chal = self.k, self.field, self.chal
        for j in range(j0, k - 1):
            r = None if j == 0 else chal[k + j - 1 : k + j]
            # the second-to-last message draws r_{2k-2} and r_last
            tables = self.round(tables, j, r, True, 2, [w_u.data], k + j, 1 if j < k - 2 else 2)
        r = chal[2 * k - 2 : 2 * k - 1]  # k >= 2: the last round folds
        _, partials = round_partials(tables, r, True, self._out(tables, k - 1), field, LIBRA_PHASE2, [w_u.data])
        q = line_restrict_chal(self.w_lsb, FArray(chal, field), k)  # delta = c - u in the kernel
        r_next = torch.empty(k, dtype=torch.int64, device=chal.device)
        self.off += final_tail(
            partials, self.claim, q.data, chal, k, self.tail.chain, self.tail.msgs, self.off, self.tail.zero, r_next
        )
        return FArray(r_next, field)


class _MeshState:
    """A sharded fused proof's placement: n_shard = log2 of the mesh size,
    this process's groups (device, first shard row, rows), its devices (the
    mesh's first device first), and each layer's values on each device,
    copied once per prover and mesh and cached on the prover (the JAX
    package's ``_fused_dev_cache``). The gather index of W's sharded
    MSB-first layout is cached per circuit, mesh and layer width."""

    def __init__(self, prover, mesh):
        self.n_shard = (mesh.devices.size - 1).bit_length()
        _check_shards(self.n_shard, mesh)  # a mesh size that is not a power of two raises ValueError
        self.mesh, self.primary, self.prover = mesh, mesh.primary, prover
        self.groups = mesh.layout(1 << self.n_shard)
        self.devices = list(dict.fromkeys(dev for dev, _, _ in self.groups))
        self.others = self.devices[1:]
        self._values = prover.__dict__.setdefault("_fused_dev_cache", {}).setdefault(mesh, {})
        self._index = prover.circuit.__dict__.setdefault("_fused_layout_index", {}).setdefault(mesh, {})

    def shards(self, k: int) -> bool:
        """Whether a layer of 2^k values is sharded: ``_mesh_put``'s rule
        (its leading dimension divides over the mesh and is at least the
        mesh size); a mesh of one device shards nothing."""
        return self.n_shard >= 1 and k >= self.n_shard

    def values(self, layer: int, dev) -> FArray:
        """The circuit's layer ``layer`` values (label order) on ``dev``."""
        w = self._values.get((layer, dev))
        if w is None:
            src = self.prover.layers_dev[layer]
            w = self._values[(layer, dev)] = FArray(src.data.to(dev), src.field)
        return w

    def w_msb_rows(self, layer: int, dev, row0: int, rows: int) -> torch.Tensor:
        """W of layer ``layer`` in MSB-first order, shard rows row0..row0 +
        rows - 1 of its sharded layout ([rows, 2^(k - n_shard)]): one gather
        of the values on ``dev``."""
        w = self.values(layer, dev)
        k = w.shape[0].bit_length() - 1
        key = (k, dev, row0, rows)
        idx = self._index.get(key)
        if idx is None:
            labels = bitrev_perm(k).reshape(1 << (k - self.n_shard), 1 << self.n_shard)[:, row0 : row0 + rows].T
            idx = self._index[key] = torch.from_numpy(np.ascontiguousarray(labels)).to(dev)
        return torch.index_select(w.data, 0, idx.reshape(-1)).reshape(idx.shape)


class _ShardedLayer(_Layer):
    """A layer whose phase tables are sharded over a mesh: each group's
    shard rows are one [rows, 2^(k - n_shard)] tensor per table on its
    device (row = the last n_shard variables). Per phase:

    - per device: the eq table of r_i (phase 1; r_i sent from the first
      device), the eq table of u with W~(u) (phase 2; u sent once);
    - per group: K2 over its shard rows (``phase_tables_rows``), W's rows
      gathered from the cached index;
    - L = k - n_shard sharded rounds: K1's TOTAL form over each group's
      rows, s(1) left out (``libra_round_total``: one row of sums per
      group, no claim), one reduction (``collective("sum")``) and the round
      tail over the reduced rows on the first device
      (``gkr_tail.round_tail``); the round's challenge is sent where the
      next sharded fold reads it;
    - one gather per table of the residual [rows, 2] columns ([rows, 1]
      when L = 0), reassembled in MSB-first order on the first device,
      where the remaining rounds run as in :class:`_Layer` (the first of
      them folding r_{L-1}), with the line restriction and the final tail
      (W is whole there).

    Per layer: 2L reductions, 6 gathers, and 2 + 2 max(L - 1, 0) sends
    (r_i, u, and the L - 1 challenges of each phase that a sharded fold
    reads); no host read."""

    def __init__(self, prover, ms: _MeshState, i: int, chain, msgs, zero, counter, bufs, off: int):
        super().__init__(prover.circuit, i, chain, msgs, zero, counter, bufs, off, ms.values(i + 1, ms.primary))
        self.ms = ms
        self.local = self.k - ms.n_shard
        self.chals = {dev: torch.empty(2 * self.k, dtype=torch.int64, device=dev) for dev in ms.others}

    def _chal(self, dev) -> torch.Tensor:
        """The layer's challenge vector as ``dev`` holds it."""
        return self.chals.get(dev, self.chal)

    def _send_chal(self, lo: int, hi: int) -> None:
        send(self.chal[lo:hi], [c[lo:hi] for c in self.chals.values()])

    def _sharded_rounds(self, tables, phase: int, scalars, start=None) -> None:
        """The L sharded rounds of a phase over each group's three tables
        (replaced by their folds in place)."""
        ms, k, c0 = self.ms, self.k, 0 if phase == 1 else self.k
        terms = LIBRA_PHASE1 if phase == 1 else LIBRA_PHASE2
        for j in range(self.local):
            sums = []
            for g, (dev, _, _) in enumerate(ms.groups):
                r = None if j == 0 else self._chal(dev)[c0 + j - 1 : c0 + j]
                folded, s = libra_round_total(tables[g], r, phase == 2 or j > 0, self.field, terms, scalars[g])
                tables[g] = folded or tables[g]
                sums.append(s)
            tail = RoundTail(self.tail, self.off, c0 + j, 2 if phase == 2 and j == k - 2 else 1,
                             start if j == 0 else None)
            round_tail(collective(ms.mesh, "sum", sums, self.field), tail)
            self.off += tail.length
            if j < self.local - 1:
                self._send_chal(c0 + j, c0 + j + 1)

    def _gather(self, tables) -> List[torch.Tensor]:
        """Each table's residual columns from every shard row: [1, cols x
        2^n_shard] in MSB-first order (index col x 2^n_shard + row) on the
        first device."""
        shards = 1 << self.ms.n_shard
        out = []
        for t in range(3):
            flat = collective(self.ms.mesh, "gather", [parts[t].reshape(-1) for parts in tables], self.field)
            cols = flat.shape[0] // shards
            out.append((flat.reshape(shards, cols).T.contiguous() if cols > 1 else flat).reshape(1, -1))
        return out

    def phase1(self, r_i: FArray):
        """Phase 1 sharded; returns (W's shard rows per group, (eq_r and W
        per device)) for phase 2."""
        ms, k = self.ms, self.k
        points = {ms.primary: r_i.data}
        points.update((dev, torch.empty_like(r_i.data, device=dev)) for dev in ms.others)
        send(r_i.data, [points[dev] for dev in ms.others])
        eq_r = {dev: eq_table_dev(FArray(points[dev], self.field), self.k_cur) for dev in ms.devices}
        w = {dev: ms.values(self.i + 1, dev) for dev in ms.devices}
        w_rows, tables = [], []
        for dev, row0, rows in ms.groups:
            wiring = ms.prover.circuit.device_wiring(self.i, dev)
            a1, a2 = phase_tables_rows(1, wiring, eq_r[dev], w[dev], k, ms.n_shard, row0, rows)
            w_rows.append(ms.w_msb_rows(self.i + 1, dev, row0, rows))
            tables.append([w_rows[-1], a1.data, a2.data])
        self._sharded_rounds(tables, 1, [[]] * len(tables), (self.i, k))
        self._phase1_rounds(self._gather(tables), self.local)
        return w_rows, (eq_r, w)

    def phase2(self, w_rows, state) -> FArray:
        """Phase 2 sharded; returns r_{i+1} on the first device."""
        eq_r, w = state
        ms, k = self.ms, self.k
        self._send_chal(0, k)  # u, for the other devices' eq tables
        eq_u, w_u = {}, {}
        for dev in ms.devices:
            eq_u[dev], w_u[dev] = eq_table_dot(FArray(self._chal(dev)[:k], self.field), w[dev], k)
        tables, scalars = [], []
        for (dev, row0, rows), w_part in zip(ms.groups, w_rows):
            wiring = ms.prover.circuit.device_wiring(self.i, dev)
            b1, b2 = phase_tables_rows(2, wiring, eq_r[dev], eq_u[dev], k, ms.n_shard, row0, rows)
            tables.append([b1.data, b2.data, w_part])
            scalars.append([w_u[dev].data.reshape(1)])
        self._sharded_rounds(tables, 2, scalars)
        return self._phase2_rounds(self._gather(tables), self.local, w_u[ms.primary])


class _Proof:
    """One fused proof's state on the card: the chain (its state, partial
    block and r_0 in one buffer, ``seed``, written by one copy per proof),
    the transcript bytes after the zero flag (``out``), the per-layer ticket
    counters of K1 and the ping-pong fold buffers (three tables x (half,
    quarter) of the widest layer). ``nbegin``: Begin's length, the chain's
    byte count before the first layer."""

    def __init__(self, circuit, field: FieldConfig, dev, nbegin: int):
        ks = [circuit.num_vars_at(i + 1) for i in range(len(circuit.layers))]
        self.circuit, self.field, self.dev, self.nbegin = circuit, field, dev, nbegin
        self.lens = [n for k in ks for n in _layer_lens(k)]
        self.seed = torch.zeros(96 + 8 * circuit.num_vars_at(0), dtype=torch.uint8, device=dev)
        self.chain = GKRChain(self.seed[:32].view(torch.int32), self.seed[32:96], nbegin)
        self.r0 = FArray(self.seed[96:].view(torch.int64), field)
        self.out = torch.zeros(4 + sum(self.lens), dtype=torch.uint8, device=dev)
        self.zero, self.msgs = self.out[:4].view(torch.int32), self.out[4:]
        self.counters = torch.zeros(len(ks), dtype=torch.int32, device=dev)
        half = 1 << (max(ks) - 1)
        self.bufs = [[torch.empty(half, dtype=torch.int64, device=dev),
                      torch.empty(half // 2, dtype=torch.int64, device=dev)] for _ in range(3)]

    def seed_with(self, state, rest: bytes, r0: List[int]) -> None:
        """The chain after Begin (``state``: 8 u32 words, ``rest``: the
        partial block) and r_0, in one host-to-device copy; the zero flag
        and the ticket counters back to 0."""
        host = np.zeros(self.seed.shape[0], dtype=np.uint8)
        host[:32] = np.asarray(state, dtype=np.uint32).view(np.uint8)
        host[32 : 32 + len(rest)] = np.frombuffer(rest, dtype=np.uint8)
        host[96:] = np.asarray(r0, dtype=np.uint64).view(np.uint8)
        self.seed.copy_(torch.from_numpy(host))
        self.zero.zero_()
        self.counters.zero_()

    def layers(self, layer_of, mark) -> None:
        """Every layer's launches in order: ``layer_of(i, off)`` makes layer
        i's :class:`_Layer`, its messages from byte ``off``."""
        self.chain.nbytes = self.nbegin
        r_i, off = self.r0, 0
        for i in range(len(self.circuit.layers)):
            layer = layer_of(i, off)
            w_msb, eq_r = layer.phase1(r_i)
            mark("phase1", i)
            r_i = layer.phase2(w_msb, eq_r)
            off = layer.off
            mark("phase2", i)

    def tensors(self) -> List[torch.Tensor]:
        return [self.seed, self.out, self.counters] + [b for pair in self.bufs for b in pair]


def _quiet(name: str, layer: int) -> None:
    pass


class _Program(_Proof):
    """The unsharded fused proof of one circuit on one device as one
    program: the counterpart of the JAX package's ``_scan_proof_jit``
    (``thaler_study_tpu/gkr/fused.py:398``), kept on the circuit per
    (device, field, Begin's length) as the JAX package keeps its
    ``_fused_wiring_cache``. Beside :class:`_Proof`'s state it holds a
    static copy of each layer's values (``values``), which every proof
    binds (:meth:`bind`: the seed and one device-to-device copy per layer).

    The layer loop is the same on every route. The first proof runs it
    eagerly (which fills every lazy cache: the libraries, the wiring, the
    occupancy, the ticket counter) and then, on a
    CUDA device, captures it as one CUDA graph (``ops/graphs.Graph``); every
    later proof replays it. On the CPU :meth:`run` is the eager loop over
    the plain versions. Unlike ``_scan_supported``, any layer widths: the
    graph is the circuit's own. One proof runs on a program at a time."""

    def __init__(self, circuit, field: FieldConfig, dev, nbegin: int):
        super().__init__(circuit, field, dev, nbegin)
        self.values = [FArray(torch.empty(1 << circuit.num_vars_at(i + 1), dtype=torch.int64, device=dev), field)
                       for i in range(len(circuit.layers))]
        self.graph: Optional[graphs.Graph] = None
        self.warm = False  # a proof has run the loop eagerly for this program

    def bind(self, prover, state, rest: bytes, r0: List[int]) -> None:
        """A proof's inputs: the seed, and the prover's layer values copied
        into the static ones; on the card the device's ticket counter is
        set back to 0 too (a launch that was cut leaves no ticket)."""
        self.seed_with(state, rest, r0)
        for v, w in zip(self.values, prover.layers_dev[1:]):
            v.data.copy_(w.data)
        if self.dev.type == "cuda":
            _build.ticket_counter(self.dev).zero_()

    def _layer(self, i: int, off: int) -> _Layer:
        return _Layer(self.circuit, i, self.chain, self.msgs, self.zero, self.counters[i : i + 1], self.bufs, off,
                      self.values[i])

    def loop(self, mark) -> None:
        self.layers(self._layer, mark)

    def run(self) -> None:
        """The bound proof's layers: the graph's replay, or on the CPU the
        eager loop."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self.loop(_quiet)

    def capture(self) -> None:
        self.graph = graphs.Graph(self.dev, lambda: self.loop(_quiet))

    def held_bytes(self) -> int:
        """Device bytes the program holds: its buffers, the static layer
        values and its graph's pool."""
        ts = self.tensors() + [v.data for v in self.values]
        return sum(t.numel() * t.element_size() for t in ts) + (self.graph.pool_bytes if self.graph else 0)


def _program(circuit, field: FieldConfig, dev, nbegin: int) -> _Program:
    """The circuit's fused program on ``dev`` for a Begin message of
    ``nbegin`` bytes (made at first use): every host int its launches bake
    in follows from the circuit's widths and ``nbegin``."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    programs = circuit.__dict__.setdefault("_fused_programs", {})
    key = (dev, field.name, nbegin)
    prog = programs.get(key)
    if prog is None:
        prog = programs[key] = _Program(circuit, field, dev, nbegin)
    return prog


def _prove_fused(prover, field: FieldConfig, timings: Optional[list] = None,
                 ms: Optional[_MeshState] = None, graph: bool = True) -> Optional[List[bytes]]:
    """The fused proof's messages, or None when a serialized coefficient is
    zero; sharded over ``ms`` where given, else through the circuit's
    :class:`_Program` (``graph`` False: the eager loop, no capture, the
    profiling route). ``timings``, when given, receives ("prelude" |
    "phase1" | "phase2" | "pull" | "assemble", layer, seconds) with a
    device sync after every step (which serializes the host with the card,
    so only profiling runs pass it); a program's replayed (or, on the CPU,
    warm) proof gives one ("scan_layers", -1, seconds) in place of the
    layers' entries, as the JAX package's scan does, and the first proof on
    a card a ("capture", -1, seconds) after its pull."""
    circuit = prover.circuit
    dev = prover.device if ms is None else ms.primary
    clock = [time.perf_counter()]

    def mark(name: str, layer: int) -> None:
        if timings is not None:
            for d in [dev] if ms is None else ms.devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            now = time.perf_counter()
            timings.append((name, layer, now - clock[0]))
            clock[0] = now

    # prelude: Begin; its midstate over Z_pad || Begin, hashed once on the
    # host, gives r_0 and seeds the device chain
    begin_raw = serialize_gkr_message(prover.start_protocol())
    state, rest = midstate(begin_raw)
    r0 = draw_many_py(field, state.tolist(), rest, len(begin_raw), circuit.num_vars_at(0))
    if ms is None:
        proof = _program(circuit, field, dev, len(begin_raw))
        proof.bind(prover, state, rest, r0)
        mark("prelude", -1)
        if graph and proof.warm:
            proof.run()
            mark("scan_layers", -1)
        else:
            proof.loop(mark)
    else:
        proof = _Proof(circuit, field, dev, len(begin_raw))
        proof.seed_with(state, rest, r0)
        mark("prelude", -1)

        def layer_of(i: int, off: int) -> _Layer:
            args = (proof.chain, proof.msgs, proof.zero, proof.counters[i : i + 1], proof.bufs, off)
            if ms.shards(circuit.num_vars_at(i + 1)):
                return _ShardedLayer(prover, ms, i, *args)
            return _Layer(circuit, i, *args, ms.values(i + 1, dev))

        proof.layers(layer_of, mark)

    host = proof.out.cpu().numpy()  # the one read: the zero flag and every message
    mark("pull", -1)
    if ms is None and graph and not proof.warm:
        if dev.type == "cuda":
            proof.capture()
            mark("capture", -1)
        proof.warm = True
    if host[:4].any():
        return None
    blob = host[4:].tobytes()
    cuts = np.cumsum([0] + proof.lens).tolist()
    msgs_out = [begin_raw] + [blob[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    mark("assemble", -1)
    return msgs_out


def generate_gkr_transcript_fused(
    prover, field: FieldConfig, dst: bytes = b"", timings: Optional[list] = None, mesh=None
) -> GKRTranscript:
    """Drop-in for ``generate_gkr_transcript``: the fused proof on the
    prover's device (every proof of a circuit after its first replays the
    circuit's program, :class:`_Program`), or sharded over ``mesh`` (a
    ``parallel`` mesh whose size is a power of two, else ``ValueError``;
    its first device holds the tail state and the layers too small to
    split; the eager loop, as the JAX package keeps its mesh path off the
    scan), or the per-layer path, on the prover's own device and mesh, for
    inputs outside :func:`supports_fused_gkr` and for a flagged zero
    coefficient (each counted in ``fallbacks``). ``prover`` is a fresh
    ``gkr.Prover``; the fused path reads only its circuit and forward-pass
    values. ``timings``: see :func:`_prove_fused`."""
    return _transcript(prover, field, dst, timings, mesh, graph=True)


def _transcript(prover, field: FieldConfig, dst: bytes, timings: Optional[list], mesh, graph: bool) -> GKRTranscript:
    """:func:`generate_gkr_transcript_fused`; ``graph`` False runs the
    program's layer loop eagerly (the profiling route: per-layer timings,
    no capture)."""
    global fallbacks
    ms = None if mesh is None else _MeshState(prover, mesh)
    msgs = _prove_fused(prover, field, timings, ms, graph) if supports_fused_gkr(prover.circuit, field, dst) else None
    if msgs is None:
        fallbacks += 1
        return generate_gkr_transcript(prover, field, dst)
    return GKRTranscript(msgs)
