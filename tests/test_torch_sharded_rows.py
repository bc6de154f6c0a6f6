"""The sharded round's rows summed by the port's kernels, and specs of more
than three blocks, against the JAX package and the per-row forms, on the
CPU.

- Specs of four and five variable blocks (``round_kernel.merge_blocks``:
  the last blocks merged down to three for each round, a table over one
  merged block broadcast along the other, folded through, and taken back
  to its own blocks): ``round_step`` (the sums and the unmerged tables),
  the host transcript and ``generate_transcript_device`` against the JAX
  package's round step and host loop, Goldilocks and BabyBear; the same
  specs sharded on the last block over a mesh of one device and of two
  (``ShardedBlockPoly``: the merge over every group's shard rows, a
  replicated table broadcast along the sharded block made sharded, folded
  and taken back), host loop and ``generate_transcript_device(mesh=)``;
- K1's TOTAL form (``cuda_round.libra_round_total``: a device's shard rows
  folding at one challenge, summed into one row) equal to the sum over the
  rows of the per-row form (``libra_round_sums``), both LibraW phases, with
  and without fold and skip-1; the product form folding every row at one
  [1] challenge equal to the same challenge expanded;
- the tensor-core matmul's dot form (``modmatmul.contract_total``: the
  shard rows as one contraction over K_dev = S K, one word per t written
  into the round's row, 0 where s(1) is left out; S = 1 the unsharded
  round's) equal to the sum over the rows of each row's per-tile partials
  (``contract_partials``);
- the reduction's row sums (``ops/row_sums.py``: rows to one row, 32-bit
  lanes and back) and the multi-block kernel's sums written into a row and
  scaled in the launch, against Python integers;
- the shard layout (``ops/shard_layout.py``: a group's shard rows cut out
  of a table and transposed) against the JAX package's ``shard_factor``,
  its kernel's tiles replayed in Python, and ``parallel.shard_factor`` over
  a mesh of uneven groups;
- the multi-block kernel's rows form (``round_sums`` over [rows, size]
  tables: a device's shard rows in one launch, the rows' sums added) and
  the fold's rows form (``fold_tables`` over [rows, 2h] tables) against
  each row alone.

Seeded words include p - 1 and, for Goldilocks, 2^64 - 2^32 (p - 1 is
2^64 - 2^32): the lazy accumulators' and the lanes' worst cases. The JAX
side runs eagerly (``jax.disable_jit()``) at a few small shapes. Tolerance:
exact. ``chip_smoke.py`` holds the kernels against these plain versions on
the card.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu.fiat_shamir import SumcheckInteractiveProver as JInteractiveProver  # noqa: E402
from thaler_study_tpu.fiat_shamir import generate_transcript as jgenerate  # noqa: E402
from thaler_study_tpu.ops import round_kernel as jrk  # noqa: E402
from thaler_study_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from thaler_study_tpu.parallel import shard_factor as jshard_factor  # noqa: E402
from thaler_study_tpu.protocols import ProductPoly as JProductPoly  # noqa: E402
from thaler_study_tpu.sumcheck import Prover as JProver  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import (  # noqa: E402
    SumcheckInteractiveProver,
    generate_transcript,
    generate_transcript_device,
)
from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.ops import cuda_round, modmatmul, multiblock, row_sums, shard_layout  # noqa: E402
from thaler_study_tpu_torch.ops import round_kernel as rk  # noqa: E402
from thaler_study_tpu_torch.parallel import ShardedBlockPoly, make_mesh, shard_factor, sharded  # noqa: E402
from thaler_study_tpu_torch.protocols import ProductPoly  # noqa: E402
from thaler_study_tpu_torch.sumcheck import Prover  # noqa: E402

FIELDS = [GOLDILOCKS, BABYBEAR]
_JF = {"Goldilocks": jfields.GOLDILOCKS, "BabyBear": jfields.BABYBEAR}
# (block_sizes, table_blocks, terms): four blocks, then five, each with a
# table over only one of the blocks the merge joins (broadcast), one over
# two of them, one over block 0 and a merged block (folded, then unmerged)
# and, in the five-block spec, a 0-block scalar; then four blocks whose
# last keeps a local variable when sharded, with a table over blocks 0 and
# 2 (replicated, broadcast along the sharded block 3, folded)
WIDE_SPECS = (
    ((1, 1, 1, 1), ((0, 1), (1, 2, 3), (0, 3), (2,)), ((0, 1, 2), (1, 3), (2,))),
    ((1, 1, 1, 1, 1), ((0, 4), (1, 2), (0, 2, 3, 4), (3,), ()), ((0, 1, 2), (0, 3, 4), (1,))),
    ((1, 1, 1, 2), ((0, 2), (3,), (1, 2, 3), (0, 1)), ((0, 1, 3), (2, 0), (1,))),
)


def _words(field, shape, seed):
    """Seeded words below p, the first ones p - 1 (= 2^64 - 2^32 for
    Goldilocks) and 1."""
    v = np.random.default_rng(seed).integers(0, field.p, size=shape, dtype=np.uint64)
    flat = v.reshape(-1)
    flat[: min(2, flat.size)] = [field.p - 1, 1][: min(2, flat.size)]
    return v


def _port(field, v):
    return FArray.from_ints(v, field, device="cpu")


def _wide_values(spec, field):
    return [_words(field, 1 << sum(spec[0][b] for b in tb), 40 + i) for i, tb in enumerate(spec[1])]


@functools.lru_cache(maxsize=None)
def _jax_wide(i, field_name):
    """The JAX package's host-loop transcript of WIDE_SPECS[i], and its
    round step (c_1's round, then the fold at 7 with the round's claim):
    sums and tables as integers."""
    spec, jf = WIDE_SPECS[i], _JF[field_name]
    field = GOLDILOCKS if field_name == "Goldilocks" else BABYBEAR
    with jax.disable_jit():
        tabs = [jfields.FArray.from_ints(np.array([int(x) for x in v], dtype=object), jf)
                for v in _wide_values(spec, field)]
        s0, _ = jrk.round_step(jrk.PolySpec(*spec), tabs, None)
        r = jfields.FArray.from_ints(np.array([7], dtype=object), jf).reshape(())
        s1, folded = jrk.round_step(jrk.PolySpec(*spec), tabs, r)
        step = ([int(x) for x in s0.to_ints()], [int(x) for x in s1.to_ints()],
                [[int(x) for x in t.to_ints()] for t in folded])
        want = jgenerate(JInteractiveProver(JProver(JProductPoly(jrk.PolySpec(*spec), tabs))), jf).to_bytes()
    return step, want


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_wide_specs_match_jax(field):
    """Four and five blocks: ``round_step`` without and with a fold (the
    merged views' sums, the tables returned unmerged), the host transcript
    and the device transcript equal the JAX package's, unsharded and
    sharded (2 shard rows in one group, and one row on each of two
    devices)."""
    for i, spec in enumerate(WIDE_SPECS):
        (s0_want, s1_want, folded_want), want = _jax_wide(i, field.name)
        ps = rk.PolySpec(*spec)
        tabs = [_port(field, v) for v in _wide_values(spec, field)]
        merged, views, _ = rk.merge_blocks(ps, [t.data for t in tabs])
        assert len(merged.block_sizes) == 3 and merged.block_sizes[:2] == ps.block_sizes[:2]
        assert merged.degree() == ps.degree() and merged.num_vars() == ps.num_vars()
        s0, same = rk.round_step(ps, tabs, None)
        assert [int(x) for x in s0.to_ints()] == s0_want and all(a is b for a, b in zip(same, tabs))
        s1, folded = rk.round_step(ps, tabs, FArray.from_ints([7], field, device="cpu").reshape(()))
        assert [int(x) for x in s1.to_ints()] == s1_want, spec
        assert [[int(x) for x in t.to_ints()] for t in folded] == folded_want, spec
        assert rk.sum_products(ps, tabs).item().v == (s0_want[0] + s0_want[1]) % field.p
        host = generate_transcript(SumcheckInteractiveProver(Prover(ProductPoly(ps, tabs))), field).to_bytes()
        assert host == want, spec
        assert generate_transcript_device(ProductPoly(ps, tabs), field).to_bytes() == want, spec
        for mesh in (make_mesh(["cpu"] * 2), make_mesh(["cpu", "cpu:0"])):
            sharded = ShardedBlockPoly.from_internal_tables(ps, tabs, mesh)
            assert sharded.n_shard == 1 and len(sharded.spec.block_sizes) == len(ps.block_sizes)
            assert generate_transcript(SumcheckInteractiveProver(Prover(sharded)), field).to_bytes() == want, spec
            assert sharded.sum_evaluations().v == (s0_want[0] + s0_want[1]) % field.p
            assert generate_transcript_device(ProductPoly(ps, tabs), field, mesh=mesh).to_bytes() == want, spec


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_k1_total_is_the_rows_sum(field):
    """K1's TOTAL form over 4 rows of 16 entries (one challenge, one phase-2
    scalar) equals the per-row form's sums added over the rows, with the
    same folded rows; the product form folding every row at one [1]
    challenge equals the challenge expanded per row."""
    for phase, terms, n_sc in ((1, cuda_round.LIBRA_PHASE1, 0), (2, cuda_round.LIBRA_PHASE2, 1)):
        for fold in (False, True):
            for skip in (False, True):
                tabs = [_port(field, _words(field, (4, 16), 7 * phase + j)).data for j in range(3)]
                r = _port(field, _words(field, (1,), 3)).data if fold else None
                sc = [_port(field, _words(field, (1,), 5)).data for _ in range(n_sc)]
                out = torch.empty(3, dtype=tabs[0].dtype)
                folded, s = cuda_round.libra_round_total(tabs, r, skip, field, terms, sc, total=out)
                rows_r = None if r is None else r.expand(4).contiguous()
                ref_f, ref = cuda_round.libra_round_sums(tabs, rows_r, skip, None, field, terms,
                                                         [x.expand(4).contiguous() for x in sc])
                want = [sum(int(x) for x in col) % field.p for col in FArray(ref, field).to_ints().T]
                assert s is out and [int(x) for x in FArray(s, field).to_ints()] == want, (phase, fold, skip)
                assert not skip or want[1] == 0
                assert (folded is None) == (not fold)
                if fold:
                    assert all(torch.equal(a, b) for a, b in zip(folded, ref_f))
                    one = cuda_round.round_partials(tabs[:2], r, skip, field=field)
                    many = cuda_round.round_partials(tabs[:2], rows_r, skip, field=field)
                    assert all(torch.equal(a, b) for a, b in zip(one[0] + [one[1]], many[0] + [many[1]]))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_contract_total_is_the_rows_sum(field):
    """The dot form over S = 3 shard rows (M = 5, N = 7, K = 9, off every
    tile) at t = 0, 2, 3 (s(1) left out: written 0) and without a view
    (c_1: one word and a 0) equals each row's per-tile partials summed over
    the tiles and the rows; over one row given as 2-D operands (the
    unsharded round's) it equals that row's partials summed."""
    s, m, n, k = 3, 5, 7, 9
    a = _port(field, _words(field, (s, 2 * m, k), 11)).data
    b = _port(field, _words(field, (s, n, k), 12)).data
    d = _port(field, _words(field, (2 * m, n), 13)).data

    def rows_sum(a, d, t, rows=range(s)):
        parts = [modmatmul.contract_partials(a[i].contiguous(), b[i], d, field, t) for i in rows]
        return sum(int(x) for p in parts for x in FArray(p, field).to_ints()) % field.p

    row = torch.full((4,), 5, dtype=a.dtype)
    assert modmatmul.contract_total(a, b, d, field, [0, 2, 3], row) is row
    got = [int(x) for x in FArray(row, field).to_ints()]
    assert got == [rows_sum(a, d, 0), 0, rows_sum(a, d, 2), rows_sum(a, d, 3)]
    one = torch.full((4,), 5, dtype=a.dtype)
    modmatmul.contract_total(a[1], b[1], d, field, [0, 2, 3], one)
    assert [int(x) for x in FArray(one, field).to_ints()] == [rows_sum(a, d, t, [1]) if t != 1 else 0
                                                             for t in range(4)]
    a0, d0 = a[:, :m].contiguous(), d[:m].contiguous()
    c1 = torch.full((2,), 5, dtype=a.dtype)
    modmatmul.contract_total(a0, b, d0, field, [None], c1)
    want = rows_sum(a0, d0, None)
    assert [int(x) for x in FArray(c1, field).to_ints()] == [want, 0]
    assert int(FArray(modmatmul.contract_total_plain(a0, b, d0, field), field).to_ints()) == want


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_row_sums_and_scaled_rows(field):
    """Rows to one row, a row to its 32-bit lanes and lanes summed over 3
    "processes" back to words, against Python integers; no row sums to 0;
    the multi-block kernel's sums written into a row of a buffer and scaled
    by 2^3 in the launch, against its unscaled sums times 8; a sharded
    proof whose terms are all replicated-only (one scaled row on the first
    device, none on the other, which sends nothing) equals the unsharded
    one."""
    rows = _port(field, _words(field, (37, 4), 21)).data
    ints = FArray(rows, field).to_ints().astype(object)
    total = [int(x) % field.p for x in ints.sum(axis=0)]
    got = row_sums.row_sums(rows, field)
    assert [int(x) for x in FArray(got, field).to_ints()] == total
    lanes = row_sums.row_sums(rows, field, out_lanes=True)
    assert lanes.dtype == torch.int64 and lanes.shape == (row_sums.lanes(field), 4)
    back = row_sums.row_sums(lanes * 3, field, in_lanes=True)  # an all_reduce over 3 processes
    assert [int(x) for x in FArray(back, field).to_ints()] == [3 * x % field.p for x in total]
    assert not row_sums.row_sums(rows[:0], field).any() and not row_sums.row_sums(rows[:0], field, out_lanes=True).any()
    spec = rk.PolySpec((2, 2), ((0,), (0, 1)), ((0, 1),))
    plan = multiblock.round_plan(spec, False, spec.terms, spec.degree())
    tabs = [_port(field, _words(field, 1 << (2 * j + 2), 30 + j)).data for j in range(2)]
    _, plain = multiblock.round_sums(plan, tabs, None, field)
    buf = torch.zeros((2, plan.degree + 1), dtype=tabs[0].dtype)
    _, s = multiblock.round_sums(plan, tabs, None, field, sums=buf[1], scale=8)
    assert s.data_ptr() == buf[1].data_ptr() and not buf[0].any()
    assert [int(x) for x in FArray(s, field).to_ints()] == [8 * int(x) % field.p
                                                            for x in FArray(plain, field).to_ints()]
    flat = rk.PolySpec((2, 1), ((0,), (0,)), ((0, 1),))  # no table over the last block
    tabs = [_port(field, _words(field, 4, 50 + j)) for j in range(2)]
    want = generate_transcript(SumcheckInteractiveProver(Prover(ProductPoly(flat, tabs))), field).to_bytes()
    sharded.collectives.update(dict.fromkeys(sharded.collectives, 0))
    poly = ShardedBlockPoly.from_internal_tables(flat, tabs, make_mesh(["cpu", "cpu:0"]))
    assert poly.n_shard == 1 and not any(poly.has_shard)
    assert generate_transcript(SumcheckInteractiveProver(Prover(poly)), field).to_bytes() == want
    assert sharded.collectives["reduce"] == 3 and sharded.collectives["reduce_words"] == 0  # c_1 and 2 rounds


def _replay_layout(words, n_shard, row0, rows, wb):
    """``csrc/shard_layout.cu``'s work over one group, in Python: the tiles
    of ``shard_layout.tile``, each thread's accesses (16 bytes where the
    wrapper takes that path), the shared-memory tile at its odd pitch;
    every output word written once and every staged word once per tile."""
    shards, cols = 1 << n_shard, len(words) >> n_shard
    tc, tl = shard_layout.tile(rows, cols, wb)
    vec = 16 // wb
    v = vec if rows % tc == 0 and tc % vec == 0 and tl % vec == 0 and row0 % vec == 0 else 1
    per, threads, pitch = shard_layout.TILE_BYTES // wb // 256 // v, 256, tc + 1
    out = {}
    for bx in range(cols // tl):
        for by in range(-(-rows // tc)):
            l0, c0, sm = bx * tl, by * tc, {}
            width = min(tc, rows - c0)
            for i in (v * (t + k * threads) for k in range(per) for t in range(threads)):
                if i >= tc * tl:
                    continue
                for e in range(v):
                    c = i % tc + e
                    if c < width:
                        assert i // tc * pitch + c not in sm
                        sm[i // tc * pitch + c] = words[(l0 + i // tc) * shards + row0 + c0 + c]
            for j in (v * (t + k * threads) for k in range(per) for t in range(threads)):
                c, l = j // tl, j % tl
                if j >= tc * tl or c >= width:
                    continue
                for e in range(v):
                    assert (c0 + c, l0 + l + e) not in out
                    out[c0 + c, l0 + l + e] = sm[(l + e) * pitch + c]
    assert len(out) == rows * cols
    return [[out[s_, l] for l in range(cols)] for s_ in range(rows)]


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_shard_rows_match_jax_layout(field):
    """The shard layout at S = 2, 8 and 64: ``shard_rows`` (the CPU takes
    its plain version) of the whole group and of partial ones (4 rows at
    row0 = 4, 3 rows at row0 = 1, one row) equal the rows of the JAX
    ``shard_factor``'s [S, L] layout (words at p - 1, Goldilocks's 2^64 -
    2^32, first), and the kernel's tiles replayed in Python equal them;
    ``shard_factor`` over a mesh whose device changes twice (groups of 2,
    4 and 2 rows) gives the JAX rows; a tensor on the meta device raises."""
    wb = 8 if field is GOLDILOCKS else 4
    for n_shard, cols in ((1, 256), (3, 256), (6, 128)):
        shards = 1 << n_shard
        vals = _words(field, shards * cols, 60 + n_shard)
        table = _port(field, vals)
        with jax.disable_jit():
            jt = jfields.FArray.from_ints(np.array([int(x) for x in vals], dtype=object), _JF[field.name])
            want = np.asarray(jshard_factor(jt, jmake_mesh(jax.devices()[:1]), n_shard).to_ints(), dtype=object)
        assert want.shape == (shards, cols)
        words = [int(x) for x in table.data]
        groups = {(0, shards), (0, 1), (shards - 1, 1)} | ({(4, 4), (1, 3)} if shards >= 8 else set())
        for row0, rows in sorted(groups):
            got = shard_layout.shard_rows(table.data, n_shard, row0, rows)
            assert got.shape == (rows, cols) and torch.equal(got, shard_layout.shard_rows_plain(table.data, n_shard,
                                                                                                 row0, rows))
            assert [[int(x) for x in row] for row in FArray(got, field).to_ints()] == want[row0 : row0 + rows].tolist()
            replay = _replay_layout(words, n_shard, row0, rows, wb)
            assert replay == [[int(x) for x in row] for row in got], (n_shard, row0, rows)
    mesh = make_mesh(["cpu", "cpu:0", "cpu:0", "cpu"])
    assert [(row0, rows) for _, row0, rows in mesh.layout(8)] == [(0, 2), (2, 4), (6, 2)]
    parts = shard_factor(table, mesh, 3).parts  # the S = 64 table, its last 3 variables sharded
    with jax.disable_jit():
        want = np.asarray(jshard_factor(jt, jmake_mesh(jax.devices()[:1]), 3).to_ints(), dtype=object)
    assert [[int(x) for x in row] for p in parts for row in FArray(p, field).to_ints()] == want.tolist()
    with pytest.raises(ValueError, match="cpu or cuda"):
        shard_layout.shard_rows(torch.empty(64, dtype=table.data.dtype, device="meta"), 3, 0, 8)
    with pytest.raises(ValueError, match="group"):
        shard_layout.shard_rows(table.data, 3, 6, 4)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_rows_forms_are_the_rows_rounds(field):
    """MB's rows form over 3 shard rows lying one row stride apart (views of
    a wider buffer), with a replicated table (one [size] table, row stride
    0): fold with skip-1 and a claim, skip-1 without one (s(1) 0), no fold,
    and scaled by 2^3; its folded rows and sums equal each row's
    ``round_sums_plain`` (the sums added mod p in Python ints), into a row
    of a buffer. The fold's rows form (``fold_tables`` over [3, 2h] tables
    apart by a row stride, one not folded) equals each row folded alone."""
    p, rows = field.p, 3
    spec = rk.PolySpec((2, 3), ((0,), (0, 1), (1,)), ((0, 1, 2), (1,)))  # f1(Y) replicated; f2(Y,Z), f3(Z) rows
    plan = multiblock.round_plan(spec, True, spec.terms, spec.after_fold().degree())
    plan = dataclasses.replace(plan, folded=(False,) + plan.folded[1:])  # f1 comes folded
    f1 = _port(field, _words(field, plan.sizes[0], 81)).data
    widths = [2 * n if f else n for n, f in zip(plan.sizes[1:], plan.folded[1:])]
    wide = [_port(field, _words(field, (rows, w + 5), 82 + k)).data for k, w in enumerate(widths)]
    tabs = [f1] + [x[:, :w] for x, w in zip(wide, widths)]
    assert not tabs[1].is_contiguous() and tabs[1].stride(1) == 1
    r, claim = (_port(field, _words(field, 1, s_)).data for s_ in (91, 92))
    for fold, skip, cl, scale in ((True, True, claim, None), (True, True, None, 8), (False, False, None, None)):
        pl = plan if fold else multiblock.round_plan(spec.after_fold(), False, spec.terms, plan.degree)
        ts = tabs if fold else [f1] + [t[:, : n] for t, n in zip(tabs[1:], pl.sizes[1:])]
        buf = torch.zeros((2, pl.degree + 1), dtype=f1.dtype)
        folded, s = multiblock.round_sums(pl, ts, r if fold else None, field, skip, cl, sums=buf[1], scale=scale)
        per = [multiblock.round_sums_plain(pl, [ts[0]] + [t[i] for t in ts[1:]], r if fold else None, field, skip,
                                           None, scale) for i in range(rows)]
        want = [sum(int(x) for x in col) % p for col in zip(*[FArray(ps, field).to_ints() for _, ps in per])]
        if cl is not None:
            want[1] = (int(FArray(cl, field).to_ints()[0]) - want[0]) % p
        assert s.data_ptr() == buf[1].data_ptr() and not buf[0].any()
        assert [int(x) for x in FArray(s, field).to_ints()] == want, (fold, skip, scale)
        assert not skip or cl is not None or want[1] == 0
        for k, f in enumerate(folded):
            assert (f is None) == (not fold or not pl.folded[k])
            if f is not None:
                assert f.shape == (rows, pl.sizes[k]) and all(torch.equal(f[i], pf[k]) for i, (pf, _) in
                                                              enumerate(per))
    halves = [w // 2 for w in widths] + [0]
    srcs = tabs[1:] + [wide[0]]
    out = multiblock.fold_tables(srcs, halves, r, field)
    for t, h, o in zip(srcs, halves, out):
        if not h:
            assert o is t
            continue
        assert o.shape == (rows, h)
        for i in range(rows):
            assert torch.equal(o[i], multiblock.fold_tables([t[i].contiguous()], [h], r, field)[0])
