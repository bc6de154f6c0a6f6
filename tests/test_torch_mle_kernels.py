"""The plain versions of the MLE and forward-pass kernels against the JAX
package, on the CPU, and the kernels' walks replayed in Python ints.

- ``ops/mle_kernel.bitrev_plain`` against JAX ``_device_bitrev``
  (``thaler_study_tpu/mle/dense.py:44``), and the bit-reversal kernel's
  tiles (``csrc/mle.cu``) replayed index by index;
- ``fold_plain`` against JAX ``_fold_impl`` (:176) at k = 1, 3 and n, and
  ``eval_many_plain`` against JAX ``_eval_many_impl`` (:185) at P = 1 and
  5; the fold kernel's plan walked in Python ints under small plans that
  reach every branch (row chunks with the ticket's sum, middle tables,
  lanes), and the evaluation kernel's two forms (the tiny table's
  staged points; the big table's point groups, (h, v) and lane factors,
  warp and cross-warp sums, chunk partials) the same way, with the plans
  of the paths' shapes;
- ``Circuit.evaluate_device`` (``ops/forward_kernel.forward_layer_plain``
  per layer) against JAX ``Circuit.evaluate_device`` on a uniform-width and
  a mixed-width circuit;
- ``restrict_poly`` and ``MatMulG.new`` on the CPU against the JAX
  package.

Fields: Goldilocks (words at p - 1 and 2^64 - 2^32), F389 and BabyBear.
Inputs come from numpy seeds; the JAX side runs eagerly under
``jax.disable_jit()``. Tolerance: exact equality (field values). The
kernels themselves run only on a card: ``chip_smoke.py`` holds each
against these plain versions there.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu import gkr as jgkr  # noqa: E402
from thaler_study_tpu.mle import dense as jdense  # noqa: E402
from thaler_study_tpu.protocols import MatMulG as JMatMulG  # noqa: E402
from thaler_study_tpu_torch import gkr  # noqa: E402
from thaler_study_tpu_torch.fields import BABYBEAR, F389, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.mle import DenseMLE, bitrev_perm  # noqa: E402
from thaler_study_tpu_torch.ops import mle_kernel as mk  # noqa: E402
from thaler_study_tpu_torch.protocols import MatMulG  # noqa: E402

FIELDS = (GOLDILOCKS, F389, BABYBEAR)
JF = {"Goldilocks": jfields.GOLDILOCKS, "F389": jfields.F389, "BabyBear": jfields.BABYBEAR}


def _values(field, size, rng):
    """Random values below p, the edge values first: p - 1 and, over
    Goldilocks, 2^64 - 2^32 (= p - 1) and 2^63."""
    v = [int(x) for x in rng.integers(0, min(field.p, 1 << 63), size, dtype=np.uint64)]
    edge = [field.p - 1, (1 << 64) - (1 << 32), 1 << 63] if field is GOLDILOCKS else [field.p - 1, field.p - 2]
    v[: min(size, len(edge))] = edge[: min(size, len(edge))]
    return v


def _jarr(field, ints):
    return jfields.FArray.from_ints(np.array(ints, dtype=object), JF[field.name])


def _brev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _bitrev_tiles(src, n):
    """The bit-reversal kernel's walk (csrc/mle.cu): per middle m, the 32
    source rows q of 32 words into a tile, then the 32 output rows a of
    tile[brev5(b)][brev5(a)]; below n = 10 one thread per word."""
    out = [None] * (1 << n)
    if n < 10:
        for i in range(1 << n):
            out[i] = src[_brev(i, n)]
        return out
    hi, mbits = n - 5, n - 10
    for m in range(1 << mbits):
        tile = [[src[(q << hi) | (_brev(m, mbits) << 5) | tx] for tx in range(32)] for q in range(32)]
        for a in range(32):
            for tx in range(32):
                assert out[(a << hi) | (m << 5) | tx] is None  # each word written once
                out[(a << hi) | (m << 5) | tx] = tile[_brev(tx, 5)][_brev(a, 5)]
    return out


def test_bitrev_matches_jax():
    rng = np.random.default_rng(20)
    for field in FIELDS:
        for n in (0, 1, 5, 11):
            vals = _values(field, 1 << n, rng)
            got = mk.bitrev_plain(FArray.from_ints(vals, field, device="cpu"), n).to_u64()
            with jax.disable_jit():
                jt = _jarr(field, vals)
                jrev = jfields.FArray(tuple(jdense._device_bitrev(limb, n) for limb in jt.limbs), jt.field)
                want = np.asarray(jrev.to_u64(), dtype=np.uint64)
            assert np.array_equal(got, want), (field.name, n)
            assert np.array_equal(mk.bitrev(FArray.from_ints(vals, field, device="cpu"), n).to_u64(), want)
            assert np.array_equal(mk.bitrev_index(n, "cpu").numpy(), bitrev_perm(n))
    for n in (9, 10, 11, 13):  # the tiled walk against the permutation
        assert _bitrev_tiles(list(range(1 << n)), n) == [int(x) for x in bitrev_perm(n)], n


def _eq(r, bits, v, top, p):
    """prod over bit b of v of (r[top - b] or 1 - r[top - b]), mod p."""
    e = 1
    for b in range(bits):
        x = r[top - b]
        e = e * (x if (v >> b) & 1 else 1 - x) % p
    return e


def _fold_walk(table, r, k, p):
    """The fold kernel's launch (csrc/mle.cu fold_kernel) replayed in Python
    ints under ``mk.plan``: per block (tile, row chunk y) and thread (lane,
    column): the middle table's sum over its rows, times the lane's factor,
    summed over the lanes, times the chunk's factor; with 2^s > 1 chunks the
    ticket's last block sums their partials. Each row and column is read
    once."""
    n = len(table).bit_length() - 1
    pl = mk.plan(n, k)
    m, ct = 1 << (n - k), 1 << pl.ct_log
    lanes = 256 >> pl.ct_log
    out = [None] * m
    for bx in range(pl.tiles):
        partial = {}
        reads = set()
        for y in range(1 << pl.s):
            for col in range(ct):
                j = bx * ct + col
                lane_sums = []
                for lane in range(lanes):
                    if lane >= 1 << pl.c:
                        lane_sums.append(0)
                        continue
                    acc = 0
                    for h in range(1 << pl.mb):
                        row = (y << (k - pl.s)) | (h << pl.c) | lane
                        reads.add((row, j))
                        acc += _eq(r, pl.mb, h, pl.s + pl.mb - 1, p) * table[row * m + j]
                    lane_sums.append(acc % p * _eq(r, pl.c, lane, k - 1, p) % p)
                partial[(y, j)] = sum(lane_sums) % p * _eq(r, pl.s, y, pl.s - 1, p) % p
        assert len(reads) == (1 << k) * ct  # each (row, column) once
        for col in range(ct):
            j = bx * ct + col
            out[j] = sum(partial[(y, j)] for y in range(1 << pl.s)) % p
    return out


def _warp_sum(lanes, p):
    """The __shfl_xor_sync butterfly over 32 lanes: lane 0's sum."""
    for o in (16, 8, 4, 2, 1):
        lanes = [(lanes[i] + lanes[i ^ o]) % p for i in range(32)]
    return lanes[0]


def _eval_walk(table, rs, p, backend):
    """The evaluation kernel's launch (csrc/mle.cu eval_tiny_kernel /
    eval_kernel) replayed in Python ints under ``mk.eval_plan``. Tiny: tiles
    of 256 points staged in order (each coordinate read once), one fold
    chain per thread. Big: per point group and chunk y, thread tid's rows x
    = (y, h, tid, v), each word times its (h, v) factor, reduced once per
    point, times the lane factor (two 16-word halves), the warps'
    butterflies, the 8 warps' sums times the chunk's factor; the group's
    last block sums the chunks, one warp per point. The points are padded
    to groups x pb with copies of the last. Each (point, word) is read once
    per group."""
    n, P = len(table).bit_length() - 1, len(rs)
    pl = mk.eval_plan(n, P, backend)
    out = [None] * P
    if pl.tiny:
        flat = [x for r in rs for x in r]
        for p0 in range(0, P, 256):
            cnt = min(256, P - p0)
            staged = flat[p0 * n : (p0 + cnt) * n]
            for tid in range(cnt):
                v = list(table)
                for i in range(n):
                    half = 1 << (n - 1 - i)
                    v = [(v[j] + staged[tid * n + i] * (v[j + half] - v[j])) % p for j in range(half)]
                assert out[p0 + tid] is None  # each value written once
                out[p0 + tid] = v[0]
        return out
    lv, c, hb, s = pl.lv, pl.c, pl.hb, pl.s
    m, cl = n - s, min(pl.c, 4)
    assert 1 <= pl.pb <= mk.EVAL_POINTS and (pl.groups - 1) * pl.pb < P <= pl.groups * pl.pb
    rs = rs + [rs[-1]] * (pl.groups * pl.pb - P)
    out += [None] * (pl.groups * pl.pb - P)
    for g in range(pl.groups):
        p0, np_ = g * pl.pb, pl.pb
        pts = range(p0, p0 + np_)
        half = {(q, i): _eq(rs[q], cl, i, n - 1 - lv, p) if i < 16 else _eq(rs[q], c - cl, i - 16, n - 1 - lv - cl, p)
                for q in pts for i in range(32)}
        mid = {(q, i): _eq(rs[q], lv, i & ((1 << lv) - 1), n - 1, p) * _eq(rs[q], hb, i >> lv, n - 1 - lv - c, p) % p
               for q in pts for i in range(1 << (hb + lv))}
        reads = collections.Counter()
        partial = {}
        for y in range(1 << s):
            red = {}
            for warp in range(8):
                lanes = {q: [] for q in pts}
                for wl in range(32):
                    tid = warp * 32 + wl
                    acc = dict.fromkeys(pts, 0)
                    if tid < 1 << c:
                        for h in range(1 << hb):
                            for v in range(1 << lv):
                                x = (y << m) | (h << (c + lv)) | (tid << lv) | v
                                for q in pts:
                                    reads[(q, x)] += 1
                                    acc[q] += mid[(q, (h << lv) | v)] * table[x]
                    for q in pts:
                        lane = half[(q, tid & 15)] * half[(q, 16 + (tid >> 4))] if tid < 1 << c else 0
                        lanes[q].append(acc[q] % p * lane % p)
                for q in pts:
                    red[(q, warp)] = _warp_sum(lanes[q], p)
            for q in pts:
                partial[(q, y)] = sum(red[(q, w)] for w in range(8)) % p * _eq(rs[q], s, y, s - 1, p) % p
        assert len(reads) == np_ << n and set(reads.values()) == {1}, (g, n, P)
        for q in pts:
            assert out[q] is None
            out[q] = _warp_sum([sum(partial[(q, y)] for y in range(lane, 1 << s, 32)) % p for lane in range(32)], p)
    return out[:P]


# small plans that reach every branch of the kernel at n <= 10: (TARGET_BLOCKS, MID_WORDS)
SMALL_PLANS = ((512, 2048), (4, 2048), (2, 8), (1, 4))
# and of the evaluation: (EVAL_TARGET_BLOCKS, EVAL_MID_LOG, points per block
# or None for the kernel's): one chunk, chunks forced by the (h, v) table's
# size, point groups of 2 (a last group of 1)
EVAL_SMALL_PLANS = ((256, 7, None), (1, 7, None), (1, 2, 2), (64, 3, 2))


def _small_eval_plan(monkeypatch, target, mid_log, pb):
    monkeypatch.setattr(mk, "EVAL_TARGET_BLOCKS", target)
    monkeypatch.setattr(mk, "EVAL_MID_LOG", mid_log)
    if pb is not None:
        monkeypatch.setattr(mk, "EVAL_POINTS", pb)


@pytest.mark.parametrize("which", ["1", "3", "n"])
def test_fold_matches_jax(which, monkeypatch):
    rng = np.random.default_rng(21 + len(which))
    for field in FIELDS:
        for n in (3, 10):
            k = {"1": 1, "3": 3, "n": n}[which]
            vals = _values(field, 1 << n, rng)
            r = _values(field, k, rng)[::-1]
            table = FArray.from_ints(vals, field, device="cpu")
            got = mk.fold(table, FArray.from_ints(r, field, device="cpu"), k).to_u64()
            with jax.disable_jit():
                want = np.asarray(jdense._fold_impl(_jarr(field, vals), _jarr(field, r), k).to_u64(), dtype=np.uint64)
            assert np.array_equal(got, want), (field.name, n, k)
            dense = DenseMLE.from_evals_msb(table, n).fix_variables(field.felts(r))
            assert np.array_equal(dense.evals.to_u64(), want)
            if k == n:
                assert DenseMLE.from_evals_msb(table, n).evaluate(field.felts(r)).v == int(want[0])
            for target, mid in SMALL_PLANS:
                monkeypatch.setattr(mk, "TARGET_BLOCKS", target)
                monkeypatch.setattr(mk, "MID_WORDS", mid)
                walk = _fold_walk([int(x) for x in vals], r, k, field.p)
                assert [int(v) for v in walk] == [int(v) for v in want], (field.name, n, k, target, mid)
    monkeypatch.undo()
    # the matmul entry's fold (13 of 26 variables) and DenseMLE.evaluate at n = 26
    assert mk.plan(26, 13) == mk.Plan(ct_log=8, s=4, c=0, mb=9, tiles=32)
    assert mk.plan(26, 26) == mk.Plan(ct_log=0, s=9, c=8, mb=9, tiles=1)


@pytest.mark.parametrize("field", [GOLDILOCKS, BABYBEAR], ids=lambda f: f.name)
def test_fold_edge_words(field, monkeypatch):
    """The fold with every table word and every coordinate an edge word (p -
    1, and over Goldilocks also 2^64 - 2^32 and 2^63), as ``chip_smoke.py``
    feeds the kernel: ``mk.fold``, the kernel's walk under the small plans
    and JAX ``_fold_impl`` agree."""
    edge = [field.p - 1, (1 << 64) - (1 << 32), 1 << 63] if field is GOLDILOCKS else [field.p - 1, field.p - 2]
    n = 10
    vals = [edge[i % len(edge)] for i in range(1 << n)]
    for k in (1, 5, n):
        r = [edge[(i + 1) % len(edge)] for i in range(k)]
        got = mk.fold(FArray.from_ints(vals, field, device="cpu"), FArray.from_ints(r, field, device="cpu"), k)
        with jax.disable_jit():
            want = np.asarray(jdense._fold_impl(_jarr(field, vals), _jarr(field, r), k).to_u64(), dtype=np.uint64)
        assert np.array_equal(got.to_u64(), want), k
        for target, mid in SMALL_PLANS:
            monkeypatch.setattr(mk, "TARGET_BLOCKS", target)
            monkeypatch.setattr(mk, "MID_WORDS", mid)
            assert _fold_walk(vals, r, k, field.p) == [int(v) for v in want], (k, target, mid)
            monkeypatch.undo()


@pytest.mark.parametrize("points", [1, 5])
def test_eval_many_matches_jax(points, monkeypatch):
    rng = np.random.default_rng(30 + points)
    for field in FIELDS:
        for n in (1, 4, 10):
            vals = _values(field, 1 << n, rng)
            rs = [_values(field, n, rng)[::-1] for _ in range(points)]
            table = FArray.from_ints(vals, field, device="cpu")
            got = mk.eval_many(table, FArray.from_ints(sum(rs, []), field, device="cpu").reshape(points, n)).to_u64()
            with jax.disable_jit():
                jrs = _jarr(field, sum(rs, [])).reshape(points, n)
                want = np.asarray(jdense._eval_many_impl(_jarr(field, vals), jrs, n).to_u64(), dtype=np.uint64)
            assert np.array_equal(got, want), (field.name, n, points)
            felts = [field.felts(r) for r in rs]
            assert [f.v for f in DenseMLE.from_evals_msb(table, n).evaluate_many(felts)] == [int(x) for x in want]
            for target, mid_log, pb in EVAL_SMALL_PLANS:
                _small_eval_plan(monkeypatch, target, mid_log, pb)
                walk = _eval_walk([int(x) for x in vals], rs, field.p, field.backend)
                assert walk == [int(x) for x in want], (field.name, n, target, mid_log, pb)
                monkeypatch.undo()
    # the paths' shapes: GKR's restriction (21 points over 2^20: three groups
    # of 7 points, 2^7 chunks of 32 Goldilocks or 32 BabyBear words per
    # thread), the PCS's 151,321 points over 2 variables (tiny)
    assert mk.eval_plan(20, 21, "goldilocks") == mk.EvalPlan(False, groups=3, pb=7, s=7, c=8, hb=4, lv=1)
    assert mk.eval_plan(20, 21, "mont32") == mk.EvalPlan(False, groups=3, pb=7, s=7, c=8, hb=3, lv=2)
    assert mk.eval_plan(2, 151321, "mont32").tiny


@pytest.mark.parametrize("form", ["tiny", "big"])
def test_eval_walks(form, monkeypatch):
    """The evaluation kernel's walks against ``eval_many_plain`` at the
    shapes that reach each branch: the tiny form at both ends of its range
    and over several tiles of staged points; the big form just above the
    tiny one (idle lanes, partial warps), at one chunk and at chunks forced
    by the block target and by the (h, v) table's size, with point groups
    that do not divide P, and P = 1."""
    rng = np.random.default_rng(60 if form == "tiny" else 61)
    shapes = (((1, 300), (2, 600), (5, 257)) if form == "tiny" else ((6, 3), (7, 1), (11, 3), (12, 5)))
    for field in (GOLDILOCKS, BABYBEAR):
        for n, P in shapes:
            assert mk.eval_plan(n, P, field.backend).tiny == (form == "tiny")
            vals = _values(field, 1 << n, rng)
            rs = [_values(field, n, rng)[::-1] for _ in range(P)]
            want = mk.eval_many_plain(FArray.from_ints(vals, field, device="cpu"),
                                      FArray.from_ints(sum(rs, []), field, device="cpu").reshape(P, n)).to_u64()
            for target, mid_log, pb in EVAL_SMALL_PLANS if form == "big" else EVAL_SMALL_PLANS[:1]:
                _small_eval_plan(monkeypatch, target, mid_log, pb)
                walk = _eval_walk([int(x) for x in vals], rs, field.p, field.backend)
                assert walk == [int(x) for x in want], (field.name, n, P, target, mid_log, pb)
                monkeypatch.undo()
    # the branches these shapes reach
    plans = {(n, P, t, m, pb): None for n, P in shapes for t, m, pb in EVAL_SMALL_PLANS}
    for n, P, t, m, pb in plans:
        _small_eval_plan(monkeypatch, t, m, pb)
        plans[(n, P, t, m, pb)] = mk.eval_plan(n, P, "goldilocks")
        monkeypatch.undo()
    if form == "big":
        got = plans.values()
        assert {pl.s > 0 for pl in got} == {True, False} and {pl.c < 8 for pl in got} == {True, False}
        assert any(pl.groups * pl.pb > 5 for pl in got if pl.pb == 2)  # a padded last group
        assert plans[(12, 5, 1, 2, 2)].s == 2  # a target of one block, but a (h, v) table of 2^2 words


def _gate_lists(widths, seed):
    rng = np.random.default_rng(seed)
    return [[(bool(rng.random() < 0.5), int(rng.integers(widths[i + 1])), int(rng.integers(widths[i + 1])))
             for _ in range(widths[i])] for i in range(len(widths) - 1)]


def _circuit(mod, layers, n_in):
    return mod.Circuit([mod.CircuitLayer([mod.Gate(mod.GateType.MUL if m else mod.GateType.ADD, (b, c))
                                          for m, b, c in l]) for l in layers], n_in)


def test_forward_pass_matches_jax():
    for field, widths, seed in ((GOLDILOCKS, [16] * 4, 40), (BABYBEAR, [4, 16, 8, 32, 16], 41),
                                (F389, [8, 4, 16], 42)):
        layers = _gate_lists(widths, seed)
        inputs = _values(field, widths[-1], np.random.default_rng(seed))
        got = _circuit(gkr, layers, widths[-1]).evaluate_device(FArray.from_ints(inputs, field, device="cpu"))
        with jax.disable_jit():
            want = _circuit(jgkr, layers, widths[-1]).evaluate_device(_jarr(field, inputs))
        assert len(got) == len(want) == len(widths)
        for g, w in zip(got, want):
            assert np.array_equal(g.to_u64(), np.asarray(w.to_u64(), dtype=np.uint64)), (field.name, widths)


def test_restrict_poly_and_matmul_match_jax():
    rng = np.random.default_rng(50)
    for field in (GOLDILOCKS, F389):
        jf = JF[field.name]
        n = 4
        vals = _values(field, 1 << n, rng)
        b, c = _values(field, n, rng), _values(field, n, rng)[::-1]
        q = gkr.restrict_poly(field.felts(b), field.felts(c),
                              DenseMLE.from_evals_lsb(vals, n, field, device="cpu"))
        with jax.disable_jit():
            jq = jgkr.restrict_poly(jf.felts(b), jf.felts(c), jdense.DenseMLE.from_evals_lsb(jf.felts(vals), n, jf))
        assert [x.v for x in q.coeffs_dense()] == [x.v for x in jq.coeffs_dense()], field.name
        L = 2
        a_m = [int(x) for x in rng.integers(0, field.p, 1 << 2 * L, dtype=np.uint64)]
        b_m = [int(x) for x in rng.integers(0, field.p, 1 << 2 * L, dtype=np.uint64)]
        point = _values(field, 2 * L, rng)
        g = MatMulG.new(L, a_m, b_m, field.felts(point), field, device="cpu")
        with jax.disable_jit():
            jg = JMatMulG.new(L, a_m, b_m, jf.felts(point), jf)
        for t, jt in zip(g.tables, jg.tables):
            assert np.array_equal(t.to_u64(), np.asarray(jt.to_u64(), dtype=np.uint64)), field.name
