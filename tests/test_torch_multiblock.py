"""The multi-block round kernel's order of work, replayed on the CPU.

``csrc/multiblock_round.cu`` runs only on the card; what decides its work
is Python: the plan (``multiblock.round_plan``), the split of the grid
into rows and an inner block and of the tables into row and inner tables
(``multiblock.split``), and the tiles (``multiblock.layout``). This file
replays the kernel over those, with Python ints mod p:

- per tile (rows x a span of the inner block) of each block's range, the
  row tables read and folded once per row, the staged inner tables folded
  where the span's entries change (written by the tile that owns them),
  and each term's row products per row and t;
- per thread as the kernel maps them (``tpr`` along a row, ``rpi`` rows at
  once, two points a step), each term's inner product summed along the row
  (as its value at t = 0 and slope where it is linear in t, else per t;
  t = 1 left out with skip-1), then multiplied by the row product;
- every folded entry written by its owner, exactly once, and every entry
  written;
- the last block's sum of every block's partials, and s(1) = claim - s(0)
  (0 without a claim).

It must equal ``round_sums_plain`` (itself held against the JAX package by
``test_torch_triangles.py``) in Goldilocks and BabyBear at every spec and
fold state that ``chip_smoke.py`` phase 2 holds the kernel to (the
triangle at each block transition, dense W in both phases, k = 1, k = 4, a
scalar table), fold on and off, skip-1 on and off, random words and words
at p - 1, under the default layout (one block per tile, and three blocks
walking tiles of one row) and one cut into two-point spans (one block and
three). Also:
the layout at the paths' shapes, and the wrapper's [D + 1] contract; the
rows form (a device's shard rows in one launch, the sharded prover's MB
round) replayed over three shard rows against the per-row rounds summed.
No JAX work; exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.ops import multiblock as mb  # noqa: E402
from thaler_study_tpu_torch.ops import round_kernel as rk  # noqa: E402

TRI = ((0, 1), (1, 2), (0, 2))
W_BLOCKS = ((0, 1), (0, 1), (0,), (1,))
W_TERMS = ((0, 2), (0, 3), (1, 2, 3))
# chip_smoke.py phase 2's specs and the folds before each checked round
SPECS = {
    "triangle": (rk.PolySpec((4, 4, 4), TRI, ((0, 1, 2),)), (0, 1, 2, 3, 4, 6, 7, 8, 10)),
    "dense W": (rk.PolySpec((5, 5), W_BLOCKS, W_TERMS), (0, 2, 4, 5, 8)),
    "single": None,
}
SINGLE = [(rk.single_block_spec(1, 10), (0, 3)), (rk.single_block_spec(4, 10), (0, 3)),
          (rk.PolySpec((10,), ((0,), (0,), ()), ((0, 2), (1,), (0, 1, 2))), (0, 3))]


def _folded(spec, j):
    for _ in range(j):
        spec = spec.after_fold()
    return spec


def _words(rng, field, n, fill):
    v = np.full(n, field.p - 1, dtype=np.uint64) if fill == "max" else rng.integers(0, field.p, n, dtype=np.uint64)
    if fill != "max":
        v[: min(n, 3)] = np.array([0, 1, field.p - 1], dtype=np.uint64)[: min(n, 3)]
    return FArray.from_ints(v, field, device="cpu").data


def _ints(t, field):
    return [int(x) for x in FArray(t, field).to_u64()]


def emulate(plan, lay, tables, r, claim, skip, p, blocks=None, shards=None):
    """The kernel's work over ``plan`` cut by ``lay`` and walked by
    ``blocks`` blocks (default: one per unit), in Python ints mod p
    (canonical values): (folded tables as {index: value} per table, none
    where not folded; s(0..degree)). With ``shards`` the rows form:
    ``tables[s]`` are shard row s's tables, the units are shard rows x
    tiles, the folded entries are keyed (s, index) and s sums every row."""
    sp = mb.split(plan)
    ni, nrow, nterms, deg = sp.ni, len(sp.order) - sp.ni, len(plan.counts), plan.degree
    out = {k: {} for k, f in enumerate(plan.folded) if f and r is not None}
    row_tables = tables if shards is not None else [tables]
    mask = (1 << sp.rl1) - 1
    stage_a = any(s and not m & 1 for s, m in zip(sp.staged, sp.miss))

    def owner(m, a, b):
        return ((a if m & 1 else 0) | (b if m & 2 else 0)) == 0

    def write(k, i, v):
        assert (srow, i) not in out[k], f"table {k} entry {i} of shard row {srow} written twice"
        out[k][srow, i] = v

    def entry(pos, idx, own):
        k, h, o = sp.order[pos], sp.fold[pos], sp.hi[pos]
        t = row_tables[srow][k]
        if h:
            lo = (t[idx] + r * (t[idx + h] - t[idx])) % p
            hv = (t[idx + o] + r * (t[idx + o + h] - t[idx + o])) % p if o else lo
            if own:
                write(k, idx, lo)
                if o:
                    write(k, idx + o, hv)
        else:
            lo, hv = t[idx], t[idx + o] if o else t[idx]
        return lo, (hv - lo) % p

    units = lay.tiles * len(row_tables)
    blocks = blocks or units
    per = -(-units // blocks)
    partials = []
    for blk in range(blocks):
        s = [0] * (deg + 1)
        staged, staged_key = {}, None
        for x in range(blk * per, min(blk * per + per, units)):
            srow, xt = divmod(x, lay.tiles)
            tile, span = divmod(xt, lay.spans)
            r0, j0 = tile * lay.rt, span * lay.span
            a0, b0 = r0 >> sp.rl1, r0 & mask
            rowv = {}
            for rho in range(lay.rt):
                a, b = (r0 + rho) >> sp.rl1, (r0 + rho) & mask
                for q in range(nrow):
                    pos = ni + q
                    rowv[rho, q] = entry(pos, a * sp.ra[pos] + b * sp.rb[pos],
                                         span == 0 and owner(sp.miss[pos], a, b))
            key = (srow, a0 if stage_a else 0, span)
            if any(sp.staged) and key != staged_key:  # folded again only where the span's entries change
                staged = {i: [entry(i, a0 * sp.ra[i] + b0 * sp.rb[i] + j0 + jj, False) for jj in range(lay.span)]
                          for i in range(ni) if lay.stage[i] >= 0}
                staged_key = key
            for i, vals in staged.items():  # the owner tile writes the staged entries
                if owner(sp.miss[i], a0, b0):
                    base, k = a0 * sp.ra[i] + b0 * sp.rb[i] + j0, sp.order[i]
                    for jj, (lo, dl) in enumerate(vals):
                        write(k, base + jj, lo)
                        if sp.hi[i]:
                            write(k, base + jj + sp.hi[i], (lo + dl) % p)
            rp = {}
            for rho in range(lay.rt):
                for j in range(nterms):
                    for t in range(deg + 1):
                        prod = 1
                        for q in range(nrow):
                            lo, dl = rowv[rho, q]
                            prod = prod * pow(lo + t * dl, sp.rcount[j][q], p) % p
                        rp[rho, j, t] = prod
            seen = set()
            tpr = lay.tpr
            for thread in range(mb.THREADS):
                lane, rsub = thread % tpr, thread // tpr
                if rsub >= lay.rpi:
                    continue
                for rho in range(rsub, lay.rt, lay.rpi):
                    a, b = (r0 + rho) >> sp.rl1, (r0 + rho) & mask
                    acc = [[0] * (deg + 1) for _ in range(nterms)]
                    for jj in range(2 * lane, lay.span, 2 * tpr):
                        for pt in (jj, jj + 1) if jj + 1 < lay.span else (jj,):
                            assert (rho, pt) not in seen
                            seen.add((rho, pt))
                            vals = [staged[i][pt] if i in staged else
                                    entry(i, a * sp.ra[i] + b * sp.rb[i] + j0 + pt, owner(sp.miss[i], a, b))
                                    for i in range(ni)]
                            for j in range(nterms):
                                n, m = sp.nf[j], sp.tmode[j]
                                if m < 3:  # linear in t: the value at 0 and the slope
                                    fs = [vals[i] for i in (sp.f0[j], sp.f1[j])[:n]]
                                    at0 = fs[0][0] * fs[1][0] if n == 2 else fs[0][0] if n else 1
                                    slope = (0 if m == 0 else fs[0][1] * (fs[1][0] if n == 2 else 1) if m == 1
                                             else fs[0][0] * fs[1][1])
                                for t in range(deg + 1):
                                    if not (skip and t == 1):
                                        if m < 3:
                                            acc[j][t] += at0 + t * slope
                                            continue
                                        prod = 1
                                        for (lo, dl), c in zip(vals, sp.icount[j]):
                                            prod = prod * pow(lo + t * dl, c, p)
                                        acc[j][t] += prod
                    for j in range(nterms):
                        for t in range(deg + 1):
                            if not (skip and t == 1):
                                s[t] += rp[rho, j, t] * (acc[j][t] % p)
            assert len(seen) == lay.rt * lay.span, "the threads miss points of the tile"
        partials.append([x % p for x in s])
    sums = [sum(col) % p for col in zip(*partials)]
    if skip:
        sums[1] = (claim - sums[0]) % p if claim is not None else 0
    if shards is None:
        out = {k: {i: v for (_, i), v in d.items()} for k, d in out.items()}
    return out, sums


def _check_spec(spec0, states, field, rng):
    wb = 8 if field is GOLDILOCKS else 4
    for j in states:
        spec = _folded(spec0, j)
        for fold in (False, True):
            if fold and spec.num_vars() < 2:
                continue
            post = spec.after_fold() if fold else spec
            plan = mb.round_plan(spec, fold, post.terms, post.degree())
            # (layout, blocks): the default, one tile per block; tiles of one
            # row, three blocks walking them; two-point spans, one block and
            # three
            lay = mb.layout(plan, wb)
            one_row = dataclasses.replace(lay, rt=1, rpi=1, tiles=lay.spans * mb.split(plan).rows)
            short = mb.layout(plan, wb, span_max=2)
            lays = [(lay, None), (one_row, 3), (short, 1), (short, 3)]
            for fill in ("random", "max"):
                tables = [_words(rng, field, rk._table_size(spec, k), fill) for k in range(len(spec.table_blocks))]
                r = _words(rng, field, 1, fill) if fold else None
                claim = _words(rng, field, 1, "random")
                modes = [(False, None)] + ([(True, claim), (True, None)] if plan.degree >= 1 else [])
                for skip, cl in modes:
                    where = f"{field.name} {spec} fold={fold} {fill} skip={skip} claim={cl is not None}"
                    ref_f, ref = mb.round_sums_plain(plan, tables, r, field, skip, cl)
                    want = _ints(ref, field)
                    for lay, blocks in lays if fill == "random" else lays[:1]:
                        out, sums = emulate(plan, lay, [_ints(t, field) for t in tables],
                                            None if r is None else _ints(r, field)[0],
                                            None if cl is None else _ints(cl, field)[0], skip, field.p, blocks)
                        assert sums == want, f"{where} {lay} {blocks}"
                        for k, f in enumerate(ref_f):
                            if f is None:
                                assert k not in out, where
                                continue
                            assert sorted(out[k]) == list(range(plan.sizes[k])), f"{where}: table {k} not covered"
                            assert [out[k][i] for i in range(plan.sizes[k])] == _ints(f, field), where


@pytest.mark.parametrize("field", [GOLDILOCKS, BABYBEAR], ids=lambda f: f.name)
@pytest.mark.parametrize("name", list(SPECS))
def test_kernel_order_of_work_equals_plain(name, field):
    """The replay equals round_sums_plain, folded tables and sums, at every
    phase-2 spec and fold state."""
    rng = np.random.default_rng(len(name) + field.p % 97)
    for spec0, states in SINGLE if name == "single" else [SPECS[name]]:
        _check_spec(spec0, states, field, rng)


# the sharded prover's local specs with which tables hold shard rows (the
# triangle sharded on Z: f1(X, Y) replicated; dense W sharded on c: W(b)
# replicated; a replicated table comes folded, never folded in the launch)
# and the folds before each checked round
ROWS_SPECS = (
    (rk.PolySpec((2, 2, 2), TRI, ((0, 1, 2),)), (False, True, True), (0, 1, 2, 3)),
    (rk.PolySpec((3, 2), W_BLOCKS, W_TERMS), (True, True, False, True), (0, 2, 3)),
)


@pytest.mark.parametrize("field", [GOLDILOCKS, BABYBEAR], ids=lambda f: f.name)
def test_rows_form_order_of_work(field):
    """The rows form (a device's shard rows in one launch, each row a round
    of the plan over its own tables, a replicated table read by every row):
    replayed over 3 shard rows under the rows layout and under walks whose
    blocks cross shard rows (one-row tiles, two and five blocks; two-point
    spans, three blocks), it equals round_sums_plain over the rows (each row's round,
    the sums added) and writes each row's folded entries once; the wrapper
    gives the same on the CPU and refuses a replicated table folded in the
    launch."""
    rng = np.random.default_rng(field.p % 89)
    wb, p, shards = (8 if field is GOLDILOCKS else 4), field.p, 3
    for spec0, hs, states in ROWS_SPECS:
        for j in states:
            spec = _folded(spec0, j)
            for fold in (False, True):
                if fold and spec.num_vars() < 2:
                    continue
                post = spec.after_fold() if fold else spec
                plan = mb.round_plan(spec if fold else post, fold, post.terms, post.degree())
                plan = dataclasses.replace(plan, folded=tuple(f and h for f, h in zip(plan.folded, hs)))
                sizes = [2 * n if f else n for n, f in zip(plan.sizes, plan.folded)]
                rep = [_words(rng, field, n, "random") for n in sizes]
                row_tabs = [[_words(rng, field, n, "random") if h else rep[k] for k, (n, h) in enumerate(zip(sizes, hs))]
                            for _ in range(shards)]
                stacked = [torch.stack([row[k] for row in row_tabs]) if h else rep[k] for k, h in enumerate(hs)]
                r = _words(rng, field, 1, "random") if fold else None
                claim = _words(rng, field, 1, "random")
                lay = mb.layout(plan, wb, shards=shards)
                one_row = dataclasses.replace(lay, rt=1, rpi=1, tiles=lay.spans * mb.split(plan).rows)
                short = mb.layout(plan, wb, span_max=2, shards=shards)
                lays = [(lay, None), (one_row, 2), (one_row, 5), (short, 3)]
                ints = [[_ints(t, field) for t in row] for row in row_tabs]
                for skip, cl in [(False, None)] + ([(True, claim), (True, None)] if plan.degree >= 1 else []):
                    where = f"{field.name} {spec} fold={fold} skip={skip} claim={cl is not None}"
                    ref_f, ref = mb.round_sums_plain(plan, stacked, r, field, skip, cl)
                    got_f, got = mb.round_sums(plan, stacked, r, field, skip, cl)
                    assert torch.equal(got, ref) and all((a is None) == (b is None) for a, b in zip(got_f, ref_f))
                    want = _ints(ref, field)
                    for lay_, blocks in lays:
                        out, sums = emulate(plan, lay_, ints, None if r is None else _ints(r, field)[0],
                                            None if cl is None else _ints(cl, field)[0], skip, p, blocks, shards)
                        assert sums == want, f"{where} {lay_} {blocks}"
                        for k, f in enumerate(ref_f):
                            if f is None:
                                assert k not in out, where
                                continue
                            assert len(out[k]) == shards * plan.sizes[k], f"{where}: table {k} not covered"
                            for i in range(shards):
                                assert [out[k][i, e] for e in range(plan.sizes[k])] == _ints(f[i], field), where
                if fold and not all(hs):
                    k = hs.index(False)
                    bad = dataclasses.replace(plan, folded=tuple(f or i == k for i, f in enumerate(plan.folded)))
                    tabs = [torch.cat([t, t]) if i == k else t for i, t in enumerate(stacked)]
                    with pytest.raises(ValueError, match="replicated"):
                        mb.round_sums(bad, tabs, r, field)


def test_layout_at_the_paths_shapes():
    """The tiles at the shapes the paths run: inside the grid, every point
    once, within shared memory, on a templated instantiation."""
    tri = rk.PolySpec((12, 12, 12), TRI, ((0, 1, 2),))
    tri10 = rk.PolySpec((10, 10, 10), TRI, ((0, 1, 2),))
    wide = rk.PolySpec((11, 11), W_BLOCKS, W_TERMS)
    libra = rk.PolySpec((20,), ((0,), (0,), (0,)), ((0, 1), (2,)))
    cases = [  # (spec before the round, fold, word bytes, expected tiles, degrees: c_1 and / or the round)
        (_folded(tri, 11), True, 8, 512, (2,)),  # 4096 nodes: X -> Y, grid 2^23
        (_folded(tri, 12), True, 8, 512, (2,)),  # the second Y round, grid 2^22
        (_folded(tri, 17), True, 8, 256, (2,)),  # the middle of the Y phase, grid 2^17
        (_folded(tri10, 6), True, 4, 512, (2,)),  # 1024 nodes: X 4 -> 3 bits, 3-D grid 2^22
        (_folded(tri10, 6), True, 8, 512, (2,)),
        (_folded(tri10, 9), True, 8, None, (2,)),  # X -> Y
        (tri10, False, 8, None, (1,)),  # c_1 below the threshold (3-D)
        (wide, False, 8, 512, (1, 2)),  # dense W at 8 x 2^11 gates: c_1 and the first b round
        (wide, True, 8, 512, (2,)),  # the second
        (_folded(wide, 10), True, 8, 1, (2,)),  # the b -> c round
        (libra, False, 8, None, (1,)),  # the LibraW c_1
        (rk.single_block_spec(2, 13), False, 8, None, (1,)),  # the matmul entry's c_1
        (_folded(tri, 34), True, 8, 1, (2,)),  # the last round
    ]
    for spec, fold, wb, tiles, degrees in cases:
        post = spec.after_fold() if fold else spec
        for degree in degrees:
            plan = mb.round_plan(spec, fold, post.terms, degree)
            assert mb.kernel_class(plan) != "generic", (spec, fold)
        sp, lay = mb.split(plan), mb.layout(plan, wb)
        assert lay.span * lay.spans == sp.inner and sp.rows % lay.rt == 0, (spec, lay)
        assert lay.tiles == lay.spans * (sp.rows // lay.rt) < 1 << 31
        assert lay.tpr * lay.rpi <= mb.THREADS and lay.rpi <= lay.rt
        assert lay.pipe_off * wb <= mb.SMEM_BYTES and lay.words * wb <= mb.PIPE_BYTES
        if sp.last == 2:
            assert lay.rt <= 1 << sp.rl1
        # the threads' steps cover a tile's span: 2 * tpr divides it, or one step does
        assert lay.span % (2 * lay.tpr) == 0 or lay.span <= 2 * lay.tpr
        if tiles is not None:
            assert lay.tiles == tiles, (spec, lay)
    # the triangle's first Y round folds f1 per row (a row table) and stages f3(Z)
    plan = mb.round_plan(_folded(tri, 11), True, ((0, 1, 2),), 2)
    sp = mb.split(plan)
    assert sp.order == (1, 2, 0) and sp.staged == (False, True, False) and (sp.nf, sp.f0, sp.f1) == ((2,), (0,), (1,))
    assert sp.tmode == (1,)  # f2 varies with t, f3(Z) does not: the sum is linear in t


def test_round_sums_contract():
    """round_sums returns the folded tables and s(0..D) as a [D + 1]
    tensor; with skip-1, s(1) = claim - s(0) or 0 without a claim; the
    inputs stay unchanged; bad arguments raise."""
    rng = np.random.default_rng(3)
    spec = rk.PolySpec((3, 3), W_BLOCKS, W_TERMS)
    post = spec.after_fold()
    plan = mb.round_plan(spec, True, post.terms, post.degree())
    for field in (GOLDILOCKS, BABYBEAR):
        tables = [_words(rng, field, rk._table_size(spec, k), "random") for k in range(4)]
        before = [t.clone() for t in tables]
        r, claim = _words(rng, field, 1, "random"), _words(rng, field, 1, "random")
        folded, sums = mb.round_sums(plan, tables, r, field)
        assert sums.shape == (plan.degree + 1,) and sums.dtype == tables[0].dtype
        assert [f is None for f in folded] == [False, False, False, True]
        assert all(torch.equal(a, b) for a, b in zip(tables, before))
        _, skipped = mb.round_sums(plan, tables, r, field, True, claim)
        _, open_ = mb.round_sums(plan, tables, r, field, True)
        f = FArray(sums, field)
        assert torch.equal(skipped[0], sums[0]) and torch.equal(skipped[2:], sums[2:])
        assert torch.equal(skipped[1], (FArray(claim.reshape(()), field) - f[0]).data)
        assert int(open_[1]) == 0 and torch.equal(open_[2:], sums[2:])
        with pytest.raises(ValueError):
            mb.round_sums(plan, tables, r, field, False, claim)  # a claim without skip-1
        with pytest.raises(ValueError):
            mb.round_sums(plan, tables[:3], r, field)
        with pytest.raises(ValueError):
            mb.round_sums(plan, [t[:-1] for t in tables], r, field)
