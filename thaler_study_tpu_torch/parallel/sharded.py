"""Mesh-sharded sumcheck proving: the distributed prover core.

Counterpart of ``thaler_study_tpu/parallel/sharded.py``. The JAX package
lays a factor table out as [2^n_shard, 2^n_local] with axis 0 (the *last*
n_shard protocol variables, those of the last block) sharded over a
``jax.sharding.Mesh``, and GSPMD inserts each round's reduction. The port
keeps the layout and makes the rest explicit:

- :class:`Mesh` is an array of ``torch.device`` with axis names (and, for
  a mesh across processes, the ``torch.distributed`` group of its outer
  axis). A device may repeat: ``make_mesh(["cpu"] * 8)`` or ``[cuda:0] * 8``
  holds 8 shards on one device, the port's counterpart of the JAX tests'
  virtual 8-device CPU mesh;
- this process's shards are cut into *groups*, runs of mesh positions on
  one device: a sharded table is one [rows, 2^n_local] tensor per group
  (row i = shard row0 + i, each row a table of the local spec, MSB-first),
  a table without the last block one [1, size] copy per device;
- a round runs each group's shards in one launch where a kernel has a
  form for them (``cuda_round.round_partials`` for a product of 1 to 8
  tables: S tables of one batch folding at one challenge, the blocks'
  partials as the group's rows; ``libra_round_total`` for the LibraW
  shapes and ``modmatmul.contract_total`` for the triangle's contracted
  term: the S shard rows summed in the launch into one row), else one
  launch of the multi-block kernel per shard, each writing its row. Each
  writes s(0), s(2..D) and leaves s(1) out where the claim is known:
  s(1) = claim - s(0) holds only for the *global* s(0), so it is filled
  after the reduction (by the FS tail or the host). A term that covers no
  sharded variable is summed once, on one group of one process, by the
  multi-block kernel with its sums scaled by 2^n_shard (JAX ``_mb_sums``
  :548). A group's rows are concatenated, never added, in plain torch:
  every word of a round's rows is written by a kernel of the port;
- :func:`collective` is the one function that moves data between shards:
  the round sums' reduction (each other device's rows summed there by
  ``ops/row_sums.py`` and its D + 1 sums copied to the first device, then
  one ``all_reduce`` of 32-bit lanes across processes, exact, as JAX's
  ``sum_mod(force_lanes=True)`` makes its psum exact, split and recombined
  by the same kernel) and, when the local
  variables are exhausted, the gather of the residual [2^n_shard] tables
  after which the last rounds run replicated (a ``ProductPoly`` on the
  first device). It counts what it issues in :data:`collectives`;
  :func:`send` (the sharded fused GKR prover's challenges, first device to
  the others) counts in :data:`sends`.

Transcripts are byte-identical to the unsharded prover's: modular sums are
exact, so no order of reduction changes a value.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..fields import FArray, Felt, FieldConfig
from ..fields.farray import resolve_device, word_dtype
from ..ops import cuda_round, modmatmul, multiblock, row_sums
from ..ops.round_kernel import Merge, PolySpec, _contraction, _split, check_spec, merge_blocks, round_step
from ..protocols.factor_poly import ProductPoly
from ..sumcheck.univariate import UniPoly, interpolate_at_small_points

AXIS = "hypercube"

# what collective() issued: calls, and the field words each moved
collectives = {"reduce": 0, "reduce_words": 0, "gather": 0, "gather_words": 0}
# what send() issued: calls, and the words it moved off the first device
sends = {"send": 0, "send_words": 0}


def resolve_devices(devices) -> List[torch.device]:
    """``devices`` (names or ``torch.device``; repeats allowed) resolved; a
    CUDA device needs a card."""
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def default_devices() -> List[torch.device]:
    """Every visible CUDA device; without a card this raises (a mesh of CPU
    devices is asked for by name)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass devices=, e.g. ['cpu'] * 8, for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A device mesh: ``devices`` (a numpy object array of ``torch.device``,
    read as ``devices.size`` and ``devices.shape``) with ``axis_names``.
    ``group``: the ``torch.distributed`` group of a mesh whose outer axis
    spans processes (``multihost.make_mesh_2d``), this process holding row
    ``rank`` of it; None for a mesh of one process."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], group=None, rank: int = 0):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.group = group
        self.rank = rank

    def local_positions(self) -> range:
        """The flat mesh positions this process holds."""
        if self.group is None:
            return range(self.devices.size)
        per = self.devices.size // self.devices.shape[0]
        return range(self.rank * per, (self.rank + 1) * per)

    @property
    def primary(self) -> torch.device:
        """The first device this process holds: reductions, gathers and
        replicated rounds land there."""
        return self.devices.flat[self.local_positions()[0]]

    @property
    def owner(self) -> bool:
        """This process adds what no shard holds (a term over replicated
        tables only): the first process, or the only one."""
        return self.group is None or self.rank == 0

    def layout(self, shards: int) -> Tuple[Tuple[torch.device, int, int], ...]:
        """This process's groups for ``shards`` shard rows: (device, first
        row, rows), runs of mesh positions on one device."""
        if shards % self.devices.size:
            raise ValueError(f"{shards} shard rows do not split over {self.devices.size} mesh positions")
        per = shards // self.devices.size
        groups: List[list] = []
        for pos in self.local_positions():
            dev = self.devices.flat[pos]
            if groups and groups[-1][0] == dev and groups[-1][1] + groups[-1][2] == pos * per:
                groups[-1][2] += per
            else:
                groups.append([dev, pos * per, per])
        return tuple(tuple(g) for g in groups)

    def __repr__(self):
        return f"Mesh({dict(zip(self.axis_names, self.devices.shape))}, {len(self.local_positions())} local)"


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    """A 1-D mesh over the hypercube axis: ``devices`` (default: every
    visible CUDA device; raises without a card), repeats allowed."""
    devs = default_devices() if devices is None else resolve_devices(devices)
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return Mesh(arr, (axis,))


def _check_axis(mesh: Mesh, axis) -> None:
    if axis is not None and tuple([axis] if isinstance(axis, str) else axis) != mesh.axis_names:
        raise NotImplementedError(f"the port shards over all mesh axes {mesh.axis_names}, not {axis}")


def _check_shards(n_shard: int, mesh: Mesh) -> None:
    if n_shard < 0 or (1 << n_shard) % mesh.devices.size != 0:
        raise ValueError(
            f"2^n_shard={1 << max(n_shard, 0)} must be divisible by the mesh size {mesh.devices.size} "
            "(shard at least log2(ndev) variables)"
        )


class Sharded:
    """One factor table on a mesh: ``parts[g]`` is this process's group g's
    [rows, 2^n_local] shard rows (``sharded``), or a [1, size] copy on its
    device (a table without the last block)."""

    __slots__ = ("parts", "field", "sharded")

    def __init__(self, parts: Sequence[torch.Tensor], field: FieldConfig, sharded: bool):
        self.parts = tuple(parts)
        self.field = field
        self.sharded = sharded

    @property
    def cols(self) -> int:
        return self.parts[0].shape[1]


def shard_factor(table: FArray, mesh: Mesh, n_shard: int, axis=None) -> Sharded:
    """A 1-D internal-order table in the sharded layout: the last n_shard
    variables (its LSBs) on the rows, [L, S] transposed to [S, L], each
    group's rows copied to its device."""
    _check_axis(mesh, axis)
    _check_shards(n_shard, mesh)
    n = table.shape[0].bit_length() - 1
    if table.shape != (1 << n,) or n_shard > n:
        raise ValueError(f"a table of {table.shape[0]} entries cannot shard {n_shard} variables")
    m = table.data.reshape(1 << (n - n_shard), 1 << n_shard)
    parts = [m[:, row0 : row0 + rows].T.contiguous().to(dev) for dev, row0, rows in mesh.layout(1 << n_shard)]
    return Sharded(parts, table.field, True)


def _replicate(table: FArray, layout) -> Sharded:
    """One [1, size] copy of ``table`` per device of ``layout``."""
    copies = {}
    parts = []
    for dev, _, _ in layout:
        if dev not in copies:
            copies[dev] = table.data.reshape(1, -1).to(dev)
        parts.append(copies[dev])
    return Sharded(parts, table.field, False)


def _gather_rows(rows: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """``rows`` ([R_i, D1] each, on ``dev``) as one [sum R_i, D1] tensor:
    copies into one buffer (device-to-device copies, no arithmetic)."""
    if len(rows) == 1:
        return rows[0]
    out = torch.empty((sum(r.shape[0] for r in rows), rows[0].shape[1]), dtype=rows[0].dtype, device=dev)
    off = 0
    for r in rows:
        if r.shape[0]:
            out[off : off + r.shape[0]].copy_(r)
        off += r.shape[0]
    return out


def collective(mesh: Mesh, op: str, parts: Sequence[torch.Tensor], field: FieldConfig) -> torch.Tensor:
    """Every collective of the sharded prover.

    - ``"sum"``: ``parts`` are the groups' round-sum rows ([..., D + 1] each,
      on their devices); returns [1, R, D + 1] on the primary device whose
      rows sum, mod p, to the round sums over every shard of every process.
      The rows of a group on the primary device stay as they are (the FS
      tail and the host sum rows anyway); a group on another device sums
      its rows there (``ops/row_sums.py``, where it has more than one) and
      sends its D + 1 sums, or nothing where it has no row; in a process
      group the rows' sum (0 where it has none) goes through
      one exact ``all_reduce`` of its 32-bit lanes (R = 1), split and
      recombined by the same kernel;
    - ``"gather"``: ``parts`` are the groups' residual columns ([rows]
      words each); returns the [2^n_shard] residual table, in shard order,
      on the primary device (``all_gather`` across processes).

    Counts each call and the field words it sends off a device in
    :data:`collectives`: D + 1 per other device's group with rows and D + 1
    per ``all_reduce`` for a reduction, 2^n_shard for a gather."""
    dev = mesh.primary
    if op == "sum":
        d1 = parts[0].shape[-1]
        rows = []
        collectives["reduce"] += 1
        for p, (gdev, _, _) in zip(parts, mesh.layout(mesh.devices.size)):
            p = p.reshape(-1, d1)
            if gdev != dev:
                if p.shape[0] == 0:  # its terms run on another group: nothing to send
                    continue
                if p.shape[0] > 1:
                    p = row_sums.row_sums(p, field)
                p = p.reshape(1, d1).to(dev)
                collectives["reduce_words"] += d1
            rows.append(p)
        local = _gather_rows(rows, dev)
        if mesh.group is None:
            return local.reshape(1, -1, d1)
        collectives["reduce_words"] += d1
        lanes = row_sums.row_sums(local, field, out_lanes=True)
        dist.all_reduce(lanes, op=dist.ReduceOp.SUM, group=mesh.group)
        return row_sums.row_sums(lanes, field, in_lanes=True).reshape(1, 1, d1)
    if op == "gather":
        local = torch.cat([p.reshape(-1).to(dev) for p in parts])
        if mesh.group is not None:
            out = [torch.empty_like(local) for _ in range(dist.get_world_size(mesh.group))]
            dist.all_gather(out, local, group=mesh.group)
            local = torch.cat(out)
        collectives["gather"] += 1
        collectives["gather_words"] += local.numel()
        return local
    raise ValueError(f"collective op {op!r}: 'sum' or 'gather'")


def send(src: torch.Tensor, dsts: Sequence[torch.Tensor]) -> None:
    """Copy ``src`` (words on the primary device) into each of ``dsts``
    (one per other device of this process): the challenges the sharded
    fused GKR prover's tails draw on the first device, which the other
    devices' folds and eq tables read. Stream-ordered on both devices, no
    host sync. Counts one call, and the words moved, in :data:`sends`; with
    no other device it moves nothing and counts the call."""
    sends["send"] += 1
    for d in dsts:
        d.copy_(src, non_blocking=True)
        sends["send_words"] += src.numel()


def _row_sums(rows: torch.Tensor, field: FieldConfig) -> List[Felt]:
    """The round sums of :func:`collective`'s rows, summed on the host
    after one read of their R x (D + 1) words (the per-round classes read
    the sums anyway)."""
    cols = FArray(rows[0], field).to_u64().astype(object).sum(axis=0)
    return [Felt(int(v) % field.p, field) for v in cols]


class ShardedBlockPoly:
    """A multi-block product polynomial sharded on the trailing variables of
    its last block (the SumCheckPolynomial hot-path interface:
    ``round_univariate``, ``sum_evaluations``, ``fix_variables``).

    ``spec`` is the local spec (the last block reduced by ``n_shard``);
    ``tables`` are :class:`Sharded`, ``has_shard[k]`` whether table k covers
    the last block (sharded) or is replicated. Byte-identical transcripts to
    the local ``ProductPoly`` over the same spec and tables."""

    def __init__(self, spec_local: PolySpec, tables: Sequence[Sharded], has_shard: Sequence[bool], n_shard: int,
                 mesh: Mesh):
        self.spec = spec_local
        self.tables = tuple(tables)
        self.has_shard = tuple(has_shard)
        self.n_shard = n_shard
        self.mesh = mesh
        self._local_poly: Optional[ProductPoly] = None
        self._last_uni: Optional[UniPoly] = None

    @classmethod
    def from_internal_tables(cls, spec: PolySpec, tables: Sequence[FArray], mesh: Mesh,
                             n_shard: Optional[int] = None, axis=None) -> "ShardedBlockPoly":
        """Shard 1-D internal-order tables of a full spec (on any device)
        onto ``mesh``. ``n_shard`` defaults to log2 of the mesh size, capped
        at the last block's size."""
        last = len(spec.block_sizes) - 1
        if n_shard is None:
            n_shard = (mesh.devices.size - 1).bit_length()
        return cls._build(spec, tables, mesh, min(n_shard, spec.block_sizes[last]), axis)

    @classmethod
    def _build(cls, spec: PolySpec, tables: Sequence[FArray], mesh: Mesh, n_shard: int, axis=None):
        check_spec(spec, tables)
        _check_axis(mesh, axis)
        _check_shards(n_shard, mesh)
        last = len(spec.block_sizes) - 1
        if n_shard > spec.block_sizes[last]:
            raise ValueError(f"n_shard={n_shard} exceeds the last block's {spec.block_sizes[last]} variables")
        sizes = list(spec.block_sizes)
        sizes[last] -= n_shard
        spec_local = PolySpec(tuple(sizes), spec.table_blocks, spec.terms)
        layout = mesh.layout(1 << n_shard)
        has_shard = tuple(last in tb and n_shard > 0 for tb in spec.table_blocks)
        sharded = [shard_factor(t, mesh, n_shard) if hs else _replicate(t, layout) for t, hs in zip(tables, has_shard)]
        return cls(spec_local, sharded, has_shard, n_shard, mesh)

    @property
    def field(self) -> FieldConfig:
        return self.tables[0].field

    def num_vars(self) -> int:
        if self._local_poly is not None:
            return self._local_poly.num_vars()
        return self.spec.num_vars() + self.n_shard

    def _layout(self):
        return self.mesh.layout(1 << self.n_shard)

    def _merged(self) -> Tuple["ShardedBlockPoly", Optional[Merge]]:
        """This poly as the kernels take it, and the :class:`Merge` that
        undoes it: itself (None) where its spec has at most three blocks,
        else its spec merged down to three (``round_kernel.merge_blocks``,
        the trailing blocks, last pair first; derived again every round)
        on every group's rows. The sharded variables, the last block's
        last, stay the merged block's last; a replicated table that the
        merge broadcasts along the last block becomes sharded, its rows
        alike."""
        if len(self.spec.block_sizes) <= multiblock.MAX_BLOCKS:
            return self, None
        parts: List[list] = [[] for _ in self.tables]
        for g, (_, _, n_rows) in enumerate(self._layout()):
            spec, views, merge = merge_blocks(self.spec, [t.parts[g].reshape(-1) for t in self.tables])
            last = len(spec.block_sizes) - 1
            has_shard = tuple(last in tb and self.n_shard > 0 for tb in spec.table_blocks)
            for k, (v, hs) in enumerate(zip(views, has_shard)):
                rows = v.reshape(self.tables[k].parts[g].shape[0], -1)
                parts[k].append(rows.expand(n_rows, -1).contiguous() if hs and rows.shape[0] < n_rows else rows)
        tables = [Sharded(p, self.field, hs) for p, hs in zip(parts, has_shard)]
        return ShardedBlockPoly(spec, tables, has_shard, self.n_shard, self.mesh), merge

    def _unmerged(self, merged: Sequence[Sharded], merge: Merge) -> Tuple[Sharded, ...]:
        """A merged round's folded tables taken back to this poly's blocks
        (``Merge.unmerge``; a replicated table's first row); a table
        without block 0 as it was."""
        out = []
        for k, (t, m, tb) in enumerate(zip(self.tables, merged, self.spec.table_blocks)):
            if 0 not in tb:
                out.append(t)
                continue
            parts = [merge.unmerge(k, p.reshape(-1)).reshape(p.shape[0], -1) for p in m.parts]
            out.append(Sharded(parts if t.sharded else [p[:1] for p in parts], self.field, t.sharded))
        return tuple(out)

    def _word(self, r: Felt) -> torch.Tensor:
        """A challenge as a [1] word on the primary device."""
        return FArray.scalar(r, device=self.mesh.primary).data.reshape(1)

    # ---- the device round ------------------------------------------------

    def _kernel_shape(self, fold: bool):
        """(folded ids, scalar ids, terms, phase) where a round of this
        single-block spec runs every group's shards in one launch of the
        round kernel's batch form (a product of 1 to 8 tables, phase 0; a
        LibraW shape, phase 1 or 2), else None."""
        spec = self.spec
        if len(spec.block_sizes) != 1 or any(tb not in ((0,), ()) for tb in spec.table_blocks):
            return None
        fold_ids, scalar_ids, terms = _split(spec)
        if not fold_ids or not all(self.has_shard[k] for k in fold_ids):
            return None
        if self.tables[fold_ids[0]].cols < (4 if fold else 2):
            return None
        shape = cuda_round.takes(terms, len(fold_ids), len(scalar_ids))
        return None if shape is None else (fold_ids, scalar_ids, terms, shape[0])

    def _kernel_rows(self, shape, r, skip_t1: bool, degree: int):
        """Each group's rows of one launch: a LibraW shape's rows summed in
        the launch (one row), a product's per-block partials of every row."""
        fold_ids, scalar_ids, terms, phase = shape
        field = self.field
        new = [list(t.parts) for t in self.tables]
        rows = []
        for g, (dev, _, n_rows) in enumerate(self._layout()):
            tabs = [self.tables[k].parts[g] for k in fold_ids]
            rr = None if r is None else r.to(dev)
            if phase:
                scalars = [self.tables[k].parts[g].reshape(1) for k in scalar_ids]
                folded, s = cuda_round.libra_round_total(tabs, rr, skip_t1, field, terms, scalars)
                rows.append(s.reshape(1, 3))
            else:
                folded, partials = cuda_round.round_partials(tabs, rr, skip_t1, field=field, terms=terms)
                rows.append(partials.reshape(-1, degree + 1))
            for k, f in zip(fold_ids, folded or ()):
                new[k][g] = f
        return new, rows

    def _fold_replicated(self, new, r) -> None:
        """Fold the replicated tables over block 0 at r: once per device."""
        ids = [k for k, tb in enumerate(self.spec.table_blocks) if not self.has_shard[k] and 0 in tb]
        done = {}
        for g, (dev, _, _) in enumerate(self._layout()):
            if ids and dev not in done:
                tabs = [self.tables[k].parts[g].reshape(-1) for k in ids]
                done[dev] = multiblock.fold_tables(tabs, [t.shape[0] // 2 for t in tabs], r.to(dev), self.field)
            for i, k in enumerate(ids):
                new[k][g] = done[dev][i].reshape(1, -1)

    def _fold_sharded(self, new, r) -> None:
        """Fold the sharded tables over block 0 at r: every shard row, in
        launches of up to MAX_TABLES rows, into one [rows, L/2] tensor per
        group and table."""
        ids = [k for k, tb in enumerate(self.spec.table_blocks) if self.has_shard[k] and 0 in tb]
        for g, (dev, _, n_rows) in enumerate(self._layout()):
            pairs = []
            for k in ids:
                src = self.tables[k].parts[g]
                new[k][g] = torch.empty((n_rows, src.shape[1] // 2), dtype=src.dtype, device=dev)
                pairs += [(src[i], new[k][g][i]) for i in range(n_rows)]
            rr = r.to(dev)
            for c in range(0, len(pairs), multiblock.MAX_TABLES):
                chunk = pairs[c : c + multiblock.MAX_TABLES]
                multiblock.fold_tables([a for a, _ in chunk], [a.shape[0] // 2 for a, _ in chunk], rr, self.field,
                                       out=[b for _, b in chunk])

    def _block_rows(self, post: PolySpec, r, skip_t1: bool, degree: int, halved: bool):
        """Every group's rows of s(0..degree) over any spec, each row written
        by a kernel into the group's [rows, degree + 1] buffer: the sharded
        terms by one multi-block launch per shard (folding its sharded rows
        too where no contraction needs them folded first), the triangle's
        contracted term by one tensor-core launch per t over the group's
        shard rows as one contraction (one row), the replicated-only terms
        once (first group, first process), their sums scaled by 2^n_shard
        in the launch. ``halved``: a round (views at t) or, False, c_1
        (degree 1, the contraction's whole-grid sum in column 0)."""
        spec, field, hs = self.spec, self.field, self.has_shard
        fold = r is not None
        shards = 1 << self.n_shard
        contract, shard_terms, rep_terms = [], [], []
        for term in post.terms:
            ks = _contraction(post, term, halved, shards)
            if ks is not None and not hs[ks[0]] and hs[ks[1]] and hs[ks[2]]:
                contract.append(ks)
            elif any(hs[k] for k in term):
                shard_terms.append(term)
            else:
                rep_terms.append(term)
        new = [list(t.parts) for t in self.tables]
        in_mb = fold and bool(shard_terms) and not contract
        plan = None
        if fold:
            self._fold_replicated(new, r)
            if not in_mb:
                self._fold_sharded(new, r)
        if shard_terms:
            plan = multiblock.round_plan(spec if in_mb else post, in_mb, shard_terms, degree)
            if in_mb:  # the replicated tables come folded already
                plan = dataclasses.replace(plan, folded=tuple(f and hs[k] for k, f in enumerate(plan.folded)))
        rows = []
        for g, (dev, _, n_rows) in enumerate(self._layout()):
            rep = bool(rep_terms) and g == 0 and self.mesh.owner
            mb_rows = n_rows if plan is not None else 0
            out = torch.empty((mb_rows + len(contract) + int(rep), degree + 1), dtype=word_dtype(field), device=dev)
            if plan is not None:
                rr = r.to(dev) if in_mb else None
                if in_mb:
                    for k, f in enumerate(plan.folded):
                        if f:
                            new[k][g] = torch.empty((n_rows, plan.sizes[k]), dtype=new[k][g].dtype, device=dev)
                for i in range(n_rows):
                    tabs = [(self.tables[k].parts[g] if in_mb else new[k][g])[i] if hs[k] else new[k][g].reshape(-1)
                            for k in range(len(hs))]
                    outs = [new[k][g][i] if in_mb and plan.folded[k] else None for k in range(len(hs))]
                    multiblock.round_sums(plan, tabs, rr, field, skip_t1, None, out=outs, sums=out[i])
            for j, ks in enumerate(contract):
                self._contract_row(post, ks, new, g, n_rows, degree, skip_t1, halved, out[mb_rows + j])
            if rep:
                self._rep_row(post, rep_terms, new, g, degree, skip_t1, out[-1])
            rows.append(out)
        return new, rows

    def _contract_row(self, post, ks, new, g, n_rows, degree, skip_t1, halved, out) -> None:
        """The group's one row of sums of the triangle term f1(X,Y) f2(Y,Z)
        f3(X,Z), f1 replicated, into ``out``: sum_s sum_{x,y} f1 (f3_s
        f2_s^T) over its shard rows s, one contraction over their Z (the
        tensor-core kernel's dot form), s(1) 0 where the round leaves it
        out."""
        k1, k2, k3 = ks
        sx, sy, sz = post.block_sizes
        f1 = new[k1][g].reshape(1 << sx, 1 << sy)
        f2 = new[k2][g].reshape(n_rows, 1 << sy, 1 << sz)
        f3 = new[k3][g].reshape(n_rows, 1 << sx, 1 << sz)
        ts = [t for t in range(degree + 1) if not (skip_t1 and t == 1)] if halved else [None]
        modmatmul.contract_total(f3, f2, f1, self.field, ts, out)

    def _rep_row(self, post, rep_terms, new, g, degree, skip_t1, out) -> None:
        """s(0..degree) of the terms over replicated tables only, summed
        once over the local grid and scaled by the 2^n_shard shard rows in
        the launch, into ``out``."""
        ids = sorted({k for term in rep_terms for k in term})
        pos = {k: i for i, k in enumerate(ids)}
        sub = PolySpec(post.block_sizes, tuple(post.table_blocks[k] for k in ids),
                       tuple(tuple(pos[k] for k in term) for term in rep_terms))
        plan = multiblock.round_plan(sub, False, sub.terms, degree)
        multiblock.round_sums(plan, [new[k][g].reshape(-1) for k in ids], None, self.field, skip_t1, sums=out,
                              scale=1 << self.n_shard)

    def _round(self, r: Optional[torch.Tensor], skip_t1: bool):
        """One sharded round (the fold at r, a [1] word on the primary
        device, where given): (the new tables, :func:`collective`'s rows of
        s(0..D) with s(1) left 0 where ``skip_t1``). A spec of more than
        three blocks runs on its merged view (:meth:`_merged`)."""
        view, merge = self._merged()
        if merge is not None:
            tables, rows = view._round(r, skip_t1)
            return (self._unmerged(tables, merge) if r is not None else self.tables), rows
        fold = r is not None
        post = self.spec.after_fold() if fold else self.spec
        degree = post.degree()
        shape = self._kernel_shape(fold)
        if shape is not None:
            new, rows = self._kernel_rows(shape, r, skip_t1, degree)
        else:
            new, rows = self._block_rows(post, r, skip_t1, degree, True)
        tables = tuple(Sharded(p, self.field, t.sharded) for p, t in zip(new, self.tables))
        return tables, collective(self.mesh, "sum", rows, self.field)

    def _fold_only(self, r: torch.Tensor) -> Tuple[Sharded, ...]:
        """Every table over block 0 folded at r, no sums."""
        new = [list(t.parts) for t in self.tables]
        self._fold_replicated(new, r)
        self._fold_sharded(new, r)
        return tuple(Sharded(p, self.field, t.sharded) for p, t in zip(new, self.tables))

    def _gather_to_local(self) -> ProductPoly:
        """Residual [2^n_shard] tables (gathered) and the replicated scalars
        -> a replicated ``ProductPoly`` over the shard variables on the
        primary device (the rows' order is internal MSB-first order)."""
        field, dev = self.field, self.mesh.primary
        spec = PolySpec((self.n_shard,), tuple((0,) if hs else () for hs in self.has_shard), self.spec.terms)
        tabs = []
        for t, hs in zip(self.tables, self.has_shard):
            if hs:
                tabs.append(FArray(collective(self.mesh, "gather", [p.reshape(-1) for p in t.parts], field), field))
            else:
                tabs.append(FArray(t.parts[0].reshape(-1).to(dev), field))
        return ProductPoly(spec, tabs)

    # ---- the SumCheckPolynomial interface ------------------------------------

    def round_univariate(self, r_prev: Optional[Felt]) -> Tuple[UniPoly, "ShardedBlockPoly"]:
        """One prover round. Every round after the first knows its claim
        g_prev(r_prev): the shards leave s(1) out, and s(1) = claim - s(0)
        after the reduction."""
        if self._local_poly is not None:
            uni, new_local = self._local_poly.round_univariate(r_prev)
            return uni, self._copy_with(local=new_local)
        if r_prev is not None and self.spec.num_vars() == 1 or r_prev is None and self.spec.num_vars() == 0:
            # the local variables are exhausted: fold the last one, gather
            # the residue, continue replicated
            new = self
            if r_prev is not None:
                new = self._copy_with(tables=self._fold_only(self._word(r_prev)), spec=self.spec.after_fold())
            uni, new_local = new._gather_to_local().round_univariate(None)
            return uni, new._copy_with(local=new_local)
        skip = r_prev is not None and self._last_uni is not None and self.spec.after_fold().degree() >= 1
        tables, rows = self._round(None if r_prev is None else self._word(r_prev), skip)
        sums = _row_sums(rows, self.field)
        if skip:
            sums[1] = self._last_uni.evaluate(r_prev) - sums[0]
        uni = interpolate_at_small_points(sums, self.field)
        new = self._copy_with(tables=tables, spec=self.spec.after_fold() if r_prev is not None else None)
        new._last_uni = uni
        return uni, new

    def fix_variables(self, partial_point: Sequence[Felt]) -> "ShardedBlockPoly":
        """Fold-only state transition mirroring ``round_univariate`` (the
        resume path), the gather included."""
        new = self
        for r in partial_point:
            if new._local_poly is not None:
                new = new._copy_with(local=new._local_poly.fix_variables([r]))
                continue
            was_last = new.spec.num_vars() == 1
            new = new._copy_with(tables=new._fold_only(new._word(r)), spec=new.spec.after_fold())
            if was_last:
                new = new._copy_with(local=new._gather_to_local())
        return new

    def sum_evaluations(self) -> Felt:
        """C_1: s(0) + s(1) of a round without a fold, over every shard."""
        if self._local_poly is not None:
            return self._local_poly.sum_evaluations()
        if self.spec.num_vars() == 0:
            return self._gather_to_local().sum_evaluations()
        view, _ = self._merged()
        _, rows = view._block_rows(view.spec, None, False, 1, False)
        s = _row_sums(collective(self.mesh, "sum", rows, self.field), self.field)
        return s[0] + s[1]

    def evaluate(self, point: Sequence[Felt]) -> Optional[Felt]:
        """The oracle (tests): every table reassembled on the primary
        device and evaluated locally; a mesh of one process only."""
        if self._local_poly is not None:
            return self._local_poly.evaluate(point)
        if self.mesh.group is not None:
            raise NotImplementedError("evaluate() reassembles the tables in one process")
        dev, last = self.mesh.primary, len(self.spec.block_sizes) - 1
        sizes = list(self.spec.block_sizes)
        sizes[last] += self.n_shard
        spec = PolySpec(tuple(sizes), self.spec.table_blocks, self.spec.terms)
        flats = []
        for t, hs in zip(self.tables, self.has_shard):
            m = torch.cat([p.to(dev) for p in t.parts]) if hs else t.parts[0].to(dev)
            flats.append(FArray(m.T.contiguous().reshape(-1), self.field))
        return ProductPoly(spec, flats).evaluate(point)

    def _copy_with(self, tables=None, local=None, spec=None) -> "ShardedBlockPoly":
        new = type(self)(spec if spec is not None else self.spec, tables if tables is not None else self.tables,
                         self.has_shard, self.n_shard, self.mesh)
        new._local_poly = local if local is not None else self._local_poly
        return new


class ShardedProductPoly(ShardedBlockPoly):
    """A sharded single-block polynomial: a sum of products of full-hypercube
    factor tables, length-1 tables being scalars (blockless, replicated):
    the matmul IP's product and GKR's LibraW phases."""

    @classmethod
    def from_internal_tables(cls, tables: Sequence[FArray], mesh: Mesh, n_shard: Optional[int] = None,
                             terms: Optional[Tuple[Tuple[int, ...], ...]] = None) -> "ShardedProductPoly":
        """Shard 1-D internal-order tables (on any device) onto ``mesh``.
        ``n_shard`` defaults to log2 of the mesh size, capped at n - 1."""
        n = max(t.shape[0] for t in tables).bit_length() - 1
        if n_shard is None:
            n_shard = min((mesh.devices.size - 1).bit_length(), max(n - 1, 0))
        spec = PolySpec((n,), tuple(() if t.shape[0] == 1 else (0,) for t in tables),
                        tuple(terms) if terms is not None else (tuple(range(len(tables))),))
        return cls._build(spec, tables, mesh, n_shard)

    @property
    def terms(self) -> Tuple[Tuple[int, ...], ...]:
        return self.spec.terms


def device_rounds(poly: ShardedBlockPoly, r: torch.Tensor, claim: torch.Tensor):
    """The rounds of a whole proof with no host read, for the FS tail:
    yields round j's [1, R, D_j + 1] rows on the primary device (s(1) left
    0 after round 0), folding at ``r`` and taking the claim from ``claim``
    ([1] words there) as the tail wrote them after round j - 1. When the
    local variables are exhausted the residual tables are gathered and the
    remaining rounds run replicated through ``round_step``."""
    field = poly.field
    local = None  # (spec, tables) of the replicated rounds
    for j in range(poly.num_vars()):
        if local is None:
            spec = poly.spec
            if spec.num_vars() > (1 if j else 0):
                tables, rows = poly._round(r if j else None, j > 0)
                poly = poly._copy_with(tables=tables, spec=spec.after_fold() if j else None)
                yield rows
                continue
            if j:
                poly = poly._copy_with(tables=poly._fold_only(r), spec=spec.after_fold())
            lp = poly._gather_to_local()
            s, tables = round_step(lp.spec, lp.tables, None, FArray(claim[0], field) if j else None)
            local = (lp.spec, tables)
        else:
            s, tables = round_step(local[0], local[1], FArray(r[0], field), FArray(claim[0], field))
            local = (local[0].after_fold(), tables)
        yield s.data.reshape(1, 1, -1)
