"""The port's GKR device modules against the JAX package, on the CPU.

- kernel K1's plain version (``cuda_round.round_partials_plain`` through
  ``round_kernel.round_step``) for the two LibraW specs, W A1 + A2 and
  B1 w_u + B1 Wc + B2 w_u Wc with the 0-block scalar w_u, without a fold,
  with a fold and with the claim shortcut, over Goldilocks and F389,
  against the JAX ``round_step`` (its XLA ``_fold_tables`` /
  ``_round_sums``, which the JAX LibraW rounds run); and ``ProductPoly``'s
  parity API over the same specs;
- kernel K2's plain version (``device_tables.phase_tables_plain`` through
  ``phase1_tables`` / ``phase2_tables``) and the kernel's walk over its
  static plan (``circuit.phase_plan``: runs in bit-reversed key order,
  gather index and type packed), emulated in Python ints, against the JAX
  ``phase1_tables`` / ``phase2_tables`` in the ``scan`` mode, on random
  wiring at g = 2^4 and 2^10, a wiring that puts every gate on one cell, a
  wiring with empty cells, and every input at p - 1;
- the sort plans, eq tables and host runtime, the forward pass
  (``Circuit.evaluate_device``), ``DenseMLE.evaluate_many`` and
  ``restrict_poly`` (the golden [32, 385, 383] over F389).

The JAX side runs eagerly under ``jax.disable_jit()``: no JAX program is
compiled. Inputs come from numpy seeds and reach both packages as the same
canonical integers. Tolerance: exact equality throughout (field values).
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``.

Cases loop inside a few test functions on purpose: the suite runs under
pytest-xdist ``--dist loadfile``, which starts files with more cases first;
more than 7 here would start this file ahead of the long GKR files.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu import gkr as jgkr  # noqa: E402
from thaler_study_tpu import runtime as jruntime  # noqa: E402
from thaler_study_tpu.gkr import device_tables as jdt  # noqa: E402
from thaler_study_tpu.mle.dense import DenseMLE as JDenseMLE  # noqa: E402
from thaler_study_tpu.ops import round_kernel as jrk  # noqa: E402
from thaler_study_tpu.protocols import ProductPoly as JProductPoly  # noqa: E402
from thaler_study_tpu_torch import gkr, runtime  # noqa: E402
from thaler_study_tpu_torch.fields import BABYBEAR, F389, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.gkr import device_tables as dt  # noqa: E402
from thaler_study_tpu_torch.gkr.circuit import LayerWiring, layer_wiring, scan_plan  # noqa: E402
from thaler_study_tpu_torch.mle import DenseMLE  # noqa: E402
from thaler_study_tpu_torch.ops import cuda_round  # noqa: E402
from thaler_study_tpu_torch.ops import round_kernel as rk  # noqa: E402
from thaler_study_tpu_torch.protocols import ProductPoly  # noqa: E402

PHASE1 = ((0, 1), (2,))
PHASE2 = ((0, 3), (0, 2), (1, 3, 2))


def _jf(field):
    return getattr(jfields, {"Goldilocks": "GOLDILOCKS", "F389": "F389", "BabyBear": "BABYBEAR"}[field.name])


def _values(field, rng, size) -> np.ndarray:
    """Canonical values below p with the boundary values first (0, 1,
    p - 1, p - 2, and for Goldilocks 2^63 and 2^64 - 2^32)."""
    p = field.p
    v = rng.integers(0, p, size=size, dtype=np.uint64)
    edge = [p - 1, 0, 1, p - 2] + ([1 << 63, (1 << 64) - (1 << 32)] if p > 1 << 32 else [])
    m = min(size, len(edge))
    v[:m] = np.array(edge[:m], dtype=np.uint64)
    return v


def _both(field, vals):
    """The same canonical values as a port FArray (CPU) and a JAX FArray."""
    vals = np.asarray(vals, dtype=np.uint64)
    return FArray.from_ints(vals, field, device="cpu"), jfields.FArray.from_ints(vals, _jf(field))


def _same(fa, ja) -> bool:
    return np.array_equal(fa.to_u64(), np.asarray(ja.to_u64(), dtype=np.uint64))


def _scalar_both(field, v: int):
    return FArray.scalar(field.felt(v), device="cpu"), jfields.FArray.scalar(_jf(field).felt(v))


def _specs(n):
    return {
        PHASE1: (rk.PolySpec((n,), ((0,),) * 3, PHASE1), jrk.PolySpec((n,), ((0,),) * 3, PHASE1)),
        PHASE2: (
            rk.PolySpec((n,), ((0,),) * 3 + ((),), PHASE2),
            jrk.PolySpec((n,), ((0,),) * 3 + ((),), PHASE2),
        ),
    }


@pytest.mark.parametrize("field", [GOLDILOCKS, F389], ids=["goldilocks", "f389"])
def test_libra_rounds_match_jax(field):
    """Both LibraW specs, no fold / fold / fold with the claim shortcut:
    round sums and folded tables equal to the JAX round_step; the plain
    version's per-block partials (the kernel's split) sum to the same
    sums; ProductPoly's rounds, fix_variables, evaluate, sum_evaluations
    and to_evaluations equal to the JAX ProductPoly."""
    rng = np.random.default_rng(7 if field is GOLDILOCKS else 8)
    n = 3
    p = field.p
    for terms, (spec, jspec) in _specs(n).items():
        pairs = [_both(field, _values(field, rng, 1 << n)) for _ in range(3)]
        if terms == PHASE2:
            pairs.append(_both(field, [p - 1]))  # w_u, a 0-block table
        tables = [a for a, _ in pairs]
        jtables = [b for _, b in pairs]
        r, jr = _scalar_both(field, int(rng.integers(0, p, dtype=np.uint64)))
        claim, jclaim = _scalar_both(field, p - 1)
        for mode in ("no_fold", "fold", "fold_claim"):
            with jax.disable_jit():
                if mode == "no_fold":
                    jsums, jnew = jrk.round_step(jspec, jtables, None)
                else:
                    jsums, jnew = jrk.round_step(jspec, jtables, jr, claim=jclaim if mode == "fold_claim" else None)
            sums, new = rk.round_step(
                spec, tables, None if mode == "no_fold" else r, claim=claim if mode == "fold_claim" else None
            )
            assert sums.shape == (3,), (terms, mode)
            assert _same(sums, jsums), (field.name, terms, mode)
            assert len(new) == len(jnew)
            for a, b in zip(new, jnew):
                assert _same(a, b), (field.name, terms, mode)

            # the plain version's per-block split, as the kernel writes it
            data = [t.data.reshape(1, -1) for t in tables[:3]]
            scal = [t.data.reshape(1) for t in tables[3:]]
            rr = None if mode == "no_fold" else r.data.reshape(1)
            skip = mode == "fold_claim"
            _, one = cuda_round.round_partials_plain(data, rr, skip, 1, field, terms, scal)
            _, three = cuda_round.round_partials_plain(data, rr, skip, 3, field, terms, scal)
            assert three.shape == (1, 3, 3)
            assert torch.equal(FArray(three[0], field).sum(axis=0).data, one[0, 0])

        # ProductPoly over the spec: two rounds, then the parity API
        poly, jpoly = ProductPoly(spec, tables), JProductPoly(jspec, jtables)
        with jax.disable_jit():
            for r_prev in (None, 5):
                uni, poly = poly.round_univariate(None if r_prev is None else field.felt(r_prev))
                juni, jpoly = jpoly.round_univariate(None if r_prev is None else _jf(field).felt(r_prev))
                assert [(d, c.v) for d, c in uni.terms] == [(d, c.v) for d, c in juni.terms]
            point = [field.felt(int(x)) for x in rng.integers(0, p, poly.num_vars(), dtype=np.uint64)]
            jpoint = [_jf(field).felt(f.v) for f in point]
            assert poly.evaluate(point).v == jpoly.evaluate(jpoint).v
            assert poly.sum_evaluations().v == jpoly.sum_evaluations().v
            assert [f.v for f in poly.to_evaluations()] == [f.v for f in jpoly.to_evaluations()]
            fixed, jfixed = poly.fix_variables(point[:1]), jpoly.fix_variables(jpoint[:1])
            for a, b in zip(fixed.tables, jfixed.tables):
                assert _same(a, b)


def _wirings(rng):
    """(name, k_cur, k, b, c, is_mul): random wiring at g = 2^4 and 2^10, a
    wiring with every gate on one cell (fan-in 32 on b, 32 on c), one whose
    labels leave most cells empty."""
    out = []
    for k in (4, 10):
        g = 1 << k
        out.append((f"random g=2^{k}", k, k, rng.integers(0, g, g), rng.integers(0, g, g), rng.random(g) < 0.5))
    out.append(("one cell", 5, 3, np.full(32, 5), np.full(32, 2), rng.random(32) < 0.5))
    out.append(("empty cells", 4, 5, 2 * rng.integers(0, 4, 16), 6 + 2 * rng.integers(0, 4, 16), rng.random(16) < 0.5))
    return [(name, kc, k, b.astype(np.int32), c.astype(np.int32), m) for name, kc, k, b, c, m in out]


def _layer_wiring(b, c, m, k) -> LayerWiring:
    return layer_wiring(torch.from_numpy(b), torch.from_numpy(c), torch.from_numpy(m), k)


def _oracle(phase, key, eq_r, table, gidx, is_mul, k, p):
    """The phase tables with Python ints, label order."""
    out1, out2 = [0] * (1 << k), [0] * (1 << k)
    for g, x in enumerate(key):
        e, v = int(eq_r[g]), int(table[gidx[g]])
        if phase == 1:
            out1[x] += e * v if is_mul[g] else e
            out2[x] += 0 if is_mul[g] else e * v
        else:
            (out2 if is_mul[g] else out1)[x] += e * v
    return [x % p for x in out1], [x % p for x in out2]


@pytest.mark.parametrize("field", [GOLDILOCKS, BABYBEAR], ids=["goldilocks", "babybear"])
def test_phase_tables_match_jax(field):
    """K2's plain version through phase1_tables / phase2_tables, and the
    kernel's walk over its static plan, against the JAX scan-mode builds
    (A1, A2, eq_r; B1, B2, w_u), and every input at p - 1 against the JAX
    scan_add_mod_many and Python ints."""
    rng = np.random.default_rng(11 if field is GOLDILOCKS else 12)
    p, jf = field.p, _jf(field)
    for name, k_cur, k, b, c, m in _wirings(rng):
        w_vals = _values(field, rng, 1 << k)
        w, jw = _both(field, w_vals)
        r_ints = [p - 1] + [int(x) for x in rng.integers(0, p, k_cur - 1, dtype=np.uint64)]
        u_ints = [int(x) for x in rng.integers(0, p, k - 1, dtype=np.uint64)] + [p - 1]
        wiring = _layer_wiring(b, c, m, k)
        r_arr, jr = _both(field, r_ints)
        u_arr, ju = _both(field, u_ints)
        a1, a2, eq_r = dt.phase1_tables(r_arr, w, wiring, k_cur, k)
        b1, b2, w_u = dt.phase2_tables(u_arr, w, eq_r, wiring, k)
        jb, jc, jm = jnp.asarray(b), jnp.asarray(c), jnp.asarray(m)
        b_scan = tuple(jnp.asarray(x) for x in jdt.scan_plan(b, 1 << k))
        c_scan = tuple(jnp.asarray(x) for x in jdt.scan_plan(c, 1 << k))
        with jax.disable_jit():
            ja1, ja2, jeq = jdt.phase1_tables(jr, jw, jb, jc, jm, k_cur, k, lane_bits=16, b_scan=b_scan)
            jb1, jb2, jwu = jdt.phase2_tables(ju, jw, jeq, jb, jc, jm, k, lane_bits=16, c_scan=c_scan)
            want = [jdt.lsb_to_msb(t, k) for t in (ja1, ja2, jb1, jb2)]
        assert _same(eq_r, jeq), name
        for got, exp, label in zip((a1, a2, b1, b2), want, ("a1", "a2", "b1", "b2")):
            assert got.shape == (1 << k,)
            assert _same(got, exp), (field.name, name, label)
        assert _same(w_u, jwu), (field.name, name)
        # kernel K2's walk over the static plan, on the same inputs
        eq_np, eq_u = eq_r.to_u64(), dt.eq_table_dev(u_arr, k).to_u64()
        walked = _walk(wiring.plan1, 1, eq_np, w_vals, k, p) + _walk(wiring.plan2, 2, eq_np, eq_u, k, p)
        for got, exp, label in zip(walked, want, ("a1", "a2", "b1", "b2")):
            assert np.array_equal(np.array(got, dtype=np.uint64), np.asarray(exp.to_u64())), (field.name, name, label)

        # every gate's eq weight and every table entry at p - 1
        g = len(b)
        full = np.full(g, p - 1, dtype=np.uint64)
        eq_full, jeq_full = _both(field, full)
        tab, jtab = _both(field, np.full(1 << k, p - 1, dtype=np.uint64))
        for phase, key, gidx in ((1, b, c), (2, c, b)):
            t1, t2 = dt.phase_tables(phase, wiring, eq_full, tab, k)
            with jax.disable_jit():
                prod = jeq_full * jdt.gather(jtab, jnp.asarray(gidx))
                zero = jnp.zeros_like
                pick = [
                    (jnp.where(jm, pl, el), jnp.where(jm, zero(pl), pl)) if phase == 1
                    else (jnp.where(jm, zero(pl), pl), jnp.where(jm, pl, zero(pl)))
                    for pl, el in zip(prod.limbs, jeq_full.limbs)
                ]
                vals = [jfields.FArray(tuple(x[i] for x in pick), jf) for i in (0, 1)]
                order, starts = (jnp.asarray(x) for x in jdt.scan_plan(key, 1 << k))
                j1, j2 = jdt.scan_add_mod_many(order, starts, vals, lane_bits=16)
            o1, o2 = _oracle(phase, key, full, np.full(1 << k, p - 1), gidx, m, k, p)
            for got, exp, orc in ((t1, j1, o1), (t2, j2, o2)):
                exp_msb = jdt.lsb_to_msb(exp, k)
                assert _same(got, exp_msb), (field.name, name, phase)
                assert [f.v for f in DenseMLE.from_evals_msb(got, k).to_evaluations()] == orc


def _walk(plan, phase, eq_r, table, k, p):
    """Kernel K2's walk over its static plan in Python ints: position pos
    sums the gates order[starts[pos]:starts[pos + 1]], each with the gather
    index and type unpacked from packed[]; returns the two tables in
    position (MSB-first) order."""
    order, starts, packed = (x.numpy().tolist() for x in (plan.order, plan.starts, plan.packed))
    out1, out2 = [], []
    for pos in range(1 << k):
        a1 = a2 = 0
        for s in range(starts[pos], starts[pos + 1]):
            w = packed[s]
            e, v, mul = int(eq_r[order[s]]), int(table[w & 0x7FFFFFFF]), w < 0
            if phase == 1:
                a1 += e * v if mul else e
                a2 += 0 if mul else e * v
            elif mul:
                a2 += e * v
            else:
                a1 += e * v
        out1.append(a1 % p)
        out2.append(a2 % p)
    return out1, out2


def test_phase_plan_layout_and_walk():
    """The static plan of K2 (``circuit.phase_plan``): a permutation of the
    gates whose runs are in bit-reversed key order, stable within a run,
    with the gather index and the gate type packed in that order; the
    kernel's walk over it equal to Python ints with random values and
    with every value p - 1, over Goldilocks and BabyBear, at g = 2^4 and
    2^10, one cell taking all 64 gates (a warp's run on the card) and empty
    cells. (test_phase_tables_match_jax holds the walk against JAX.)"""
    for field in (GOLDILOCKS, BABYBEAR):
        rng = np.random.default_rng(23 if field is GOLDILOCKS else 24)
        p = field.p
        wirings = _wirings(rng) + [("one cell, 64 gates", 6, 3, np.full(64, 6, dtype=np.int32),
                                    np.full(64, 1, dtype=np.int32), rng.random(64) < 0.5)]
        for name, _, k, b, c, m in wirings:
            wiring = _layer_wiring(b, c, m, k)
            g = len(b)
            rev = [int(format(x, f"0{k}b")[::-1], 2) for x in range(1 << k)]
            for phase, plan, key, gidx in ((1, wiring.plan1, b, c), (2, wiring.plan2, c, b)):
                order, starts, packed = (x.numpy() for x in (plan.order, plan.starts, plan.packed))
                assert sorted(order.tolist()) == list(range(g)), name
                assert starts[0] == 0 and starts[-1] == g and (np.diff(starts) >= 0).all()
                for pos in range(1 << k):
                    run = order[starts[pos] : starts[pos + 1]]
                    assert all(rev[key[x]] == pos for x in run) and (np.diff(run) > 0).all(), (name, pos)
                assert np.array_equal(packed & 0x7FFFFFFF, gidx[order]) and np.array_equal(packed < 0, m[order])
                for values in ("random", "p - 1"):
                    if values == "random":
                        eq_r, table = _values(field, rng, g), _values(field, rng, 1 << k)
                    else:
                        eq_r, table = np.full(g, p - 1, dtype=np.uint64), np.full(1 << k, p - 1, dtype=np.uint64)
                    orc = _oracle(phase, key, eq_r, table, gidx, m, k, p)
                    got = _walk(plan, phase, eq_r, table, k, p)
                    assert list(got) == [[o[x] for x in rev] for o in orc], (field.name, name, phase, values)


def test_plans_eq_tables_and_runtime_match_jax():
    """scan_plan, eq_table_dev and the host runtime (eq_table, mle_eval,
    wiring_eval_sparse) against the JAX package, coordinates at p - 1."""
    rng = np.random.default_rng(13)
    for name, _, k, b, c, _ in _wirings(rng):
        for key in (b, c):
            order, starts = scan_plan(torch.from_numpy(key), 1 << k)
            jorder, jstarts = jdt.scan_plan(key, 1 << k)
            assert np.array_equal(order.numpy(), jorder) and np.array_equal(starts.numpy(), jstarts), name
    for field in (GOLDILOCKS, BABYBEAR, F389):
        p = field.p
        for n in (1, 4, 7):
            r = [p - 1] + [int(x) for x in rng.integers(0, p, n - 1, dtype=np.uint64)]
            port, jr = _both(field, r)
            with jax.disable_jit():
                jt = jdt.eq_table_dev(jr, n)
            host = runtime.eq_table(r, p)
            assert _same(dt.eq_table_dev(port, n), jt), (field.name, n)
            assert np.array_equal(host, jruntime.eq_table(r, p)) and np.array_equal(host, np.asarray(jt.to_u64()))
            evals = _values(field, rng, 1 << n)
            assert runtime.mle_eval(evals, r, p) == jruntime.mle_eval(evals, r, p)
        g = 64
        b, c = rng.integers(0, 8, g).astype(np.int32), rng.integers(0, 8, g).astype(np.int32)
        sel = rng.random(g) < 0.5
        eq_r, eq_b, eq_c = (_values(field, rng, s) for s in (g, 8, 8))
        for s in (sel, ~sel):
            assert runtime.wiring_eval_sparse(eq_r, eq_b, eq_c, b, c, s, p) == jruntime.wiring_eval_sparse(
                eq_r, eq_b, eq_c, b, c, s, p
            )


def _gate_lists(widths, rng):
    """[(is_mul, b, c) per gate] per layer, output layer first; widths[-1]
    is the input count."""
    layers = []
    for i in range(len(widths) - 1):
        nxt = widths[i + 1]
        layers.append([(bool(rng.random() < 0.5), int(rng.integers(nxt)), int(rng.integers(nxt))) for _ in range(widths[i])])
    return layers


def _circuit(mod, layers, n_in):
    return mod.Circuit(
        [mod.CircuitLayer([mod.Gate(mod.GateType.MUL if m else mod.GateType.ADD, (b, c)) for m, b, c in l])
         for l in layers],
        n_in,
    )


def test_evaluate_device_matches_jax():
    """The forward pass on a mixed-width and a uniform-width circuit (the
    JAX scan path) over Goldilocks and BabyBear, inputs at p - 1 included:
    every layer equal to the JAX evaluate_device and to the host loop."""
    rng = np.random.default_rng(17)
    for field in (GOLDILOCKS, BABYBEAR):
        for widths in ([4, 8, 2, 16, 8], [8, 8, 8, 8]):
            layers = _gate_lists(widths, rng)
            inputs = _values(field, rng, widths[-1])
            circ, jcirc = _circuit(gkr, layers, widths[-1]), _circuit(jgkr, layers, widths[-1])
            inp, jinp = _both(field, inputs)
            got = circ.evaluate_device(inp)
            with jax.disable_jit():
                want = jcirc.evaluate_device(jinp)
            host = circ.evaluate(field.felts([int(x) for x in inputs]))
            assert len(got) == len(want) == len(widths)
            for i, (a, w) in enumerate(zip(got, want)):
                assert _same(a, w), (field.name, widths, i)
                assert [int(x) for x in a.to_u64()] == [f.v for f in host.layers[i]]


def test_evaluate_many_and_restrict_poly_match_jax():
    """restrict_poly's golden [32, 385, 383] over F389; evaluate_many,
    from_evals_lsb_farray and restrict_poly against the JAX package over
    Goldilocks and F389."""
    b, c = F389.felts([2, 4]), F389.felts([3, 2])
    mle = DenseMLE.from_evals_lsb(F389.felts([0, 0, 2, 5]), 2, F389, device="cpu")
    assert [co.v for co in gkr.restrict_poly(b, c, mle).coeffs_dense()] == [32, 385, 383]

    rng = np.random.default_rng(19)
    for field, sizes in ((GOLDILOCKS, (2,)), (F389, (1, 3))):
        p, jf = field.p, _jf(field)
        for n in sizes:
            vals = _values(field, rng, 1 << n)
            mle = DenseMLE.from_evals_lsb(vals, n, field, device="cpu")
            jmle = JDenseMLE.from_evals_lsb(vals, n, jf)
            lifted = DenseMLE.from_evals_lsb_farray(FArray.from_ints(vals, field, device="cpu"), n)
            assert torch.equal(lifted.evals.data, mle.evals.data)
            points = [[int(x) for x in rng.integers(0, p, n, dtype=np.uint64)] for _ in range(n + 1)] + [[p - 1] * n]
            with jax.disable_jit():
                want = jmle.evaluate_many([jf.felts(pt) for pt in points])
                b_pt, c_pt = points[0], points[1]
                jq = jgkr.restrict_poly(jf.felts(b_pt), jf.felts(c_pt), jmle)
            got = mle.evaluate_many([field.felts(pt) for pt in points])
            assert [f.v for f in got] == [f.v for f in want], (field.name, n)
            assert [mle.evaluate(field.felts(pt)).v for pt in points] == [f.v for f in got]
            q = gkr.restrict_poly(field.felts(b_pt), field.felts(c_pt), mle)
            assert [co.v for co in q.coeffs_dense()] == [co.v for co in jq.coeffs_dense()]
