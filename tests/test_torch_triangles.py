"""The port's multi-block specs and the triangle-counting IP against the JAX
package, on the CPU.

- ``round_kernel.round_step`` over multi-block specs (the plain version of
  the multi-block round kernel, and of the modular matmul where the
  triangle contraction is taken) against the JAX ``round_step`` (its XLA
  ``_fold_tables`` / ``_round_sums``): the triangle spec at every block
  transition, GKR's dense W in both phases, single-block k = 1 and k = 4
  products and a product with a scalar table; fold, claim shortcut, values
  at p - 1; ``sum_products`` (c_1), ``product_evals`` and ``fold_step``
  too;
- ``ops.modmatmul`` (C = A B^T and the contraction's per-tile partials,
  the plain version and the tensor-core kernel's digit form) against the
  JAX ``modmatmul_impl`` and ``_mxu_modmatmul_impl``;
- the contraction forced at small sizes (threshold 0) in both packages;
- ``api.prove_triangle_count`` / ``verify_triangle_count`` transcripts
  byte for byte against the JAX package's: the reference's 4-node graph
  over F389, random 8-node graphs over F1572869, Goldilocks and BabyBear
  (32 nodes cost ~3x the JAX side's eager compile time; the card holds a
  256-node proof against ``device="cpu"``); 6 Delta against brute force;
  accept and reject;
- a proof carried across packages mid-protocol (``from_jax_state``, just
  after the X -> Y block transition).

Inputs come from numpy seeds and reach both packages as the same integers.
The JAX side runs eagerly under ``jax.disable_jit()`` and compiles no JAX
program. Tolerance: exact (field values, transcript bytes). The kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.

Cases loop inside a few test functions on purpose: the suite runs under
pytest-xdist ``--dist loadfile``, which starts files with more cases first;
more than 8 here would start this file ahead of the long JAX GKR file (8
cases; ties keep the collection order). The JAX side's eager compiles are
most of the time: the round test's triangle spec has the 8-node proofs'
shapes, so they compile once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import api as japi  # noqa: E402
from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu.ops import modmatmul as jmm  # noqa: E402
from thaler_study_tpu.ops import round_kernel as jrk  # noqa: E402
from thaler_study_tpu.protocols import TriangleG as JTriangleG  # noqa: E402
from thaler_study_tpu_torch import api  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import FiatShamirTranscript, SerializationError  # noqa: E402
from thaler_study_tpu_torch.fields import BABYBEAR, F389, F1572869, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.ops import modmatmul  # noqa: E402
from thaler_study_tpu_torch.ops import round_kernel as rk  # noqa: E402
from thaler_study_tpu_torch.protocols import TriangleG, from_jax_state  # noqa: E402
from thaler_study_tpu_torch.sumcheck import SumCheckError  # noqa: E402

_JF = {"Goldilocks": "GOLDILOCKS", "F389": "F389", "BabyBear": "BABYBEAR", "F1572869": "F1572869"}
TRI = ((0, 1), (1, 2), (0, 2))


def _jf(field):
    return getattr(jfields, _JF[field.name])


def _values(rng, field, n, fill) -> np.ndarray:
    if fill == "max":
        return np.full(n, field.p - 1, dtype=np.uint64)
    v = rng.integers(0, field.p, size=n, dtype=np.uint64)
    v[: min(n, 3)] = np.array([0, 1, field.p - 1], dtype=np.uint64)[: min(n, 3)]
    return v


def _both(v, field):
    """The same values as a port FArray (CPU) and a JAX FArray."""
    return FArray.from_ints(v, field, device="cpu"), jfields.FArray.from_ints(v, _jf(field))


def _jspec(spec):
    return jrk.PolySpec(spec.block_sizes, spec.table_blocks, spec.terms)


def _folded(spec, j):
    for _ in range(j):
        spec = spec.after_fold()
    return spec


def _graph(n, seed, p=0.5):
    upper = np.triu(np.random.default_rng(seed).random((n, n)) < p, k=1)
    return upper | upper.T


def _six_delta(adj) -> int:
    a = adj.astype(np.int64)
    return int(((a @ a) * a).sum())


def _check_round(spec, field, rng, mode, fill, where, evals=False):
    tables = [_both(_values(rng, field, rk._table_size(spec, k), fill), field)
              for k in range(len(spec.table_blocks))]
    ports, jaxes = [t[0] for t in tables], [t[1] for t in tables]
    r = claim = jr = jclaim = None
    if mode != "no_fold":
        r, jr = (x.reshape(()) for x in _both(_values(rng, field, 1, fill), field))
    if mode == "fold_claim":
        claim, jclaim = (x.reshape(()) for x in _both(_values(rng, field, 1, fill), field))
    sums, folded = rk.round_step(spec, ports, r, claim=claim)
    with jax.disable_jit():
        jsums, jfolded = jrk.round_step(_jspec(spec), jaxes, jr, claim=jclaim)
    np.testing.assert_array_equal(sums.to_u64(), np.asarray(jsums.to_u64()), err_msg=where)
    assert len(folded) == len(jfolded)
    for t, jt in zip(folded, jfolded):
        np.testing.assert_array_equal(t.to_u64(), np.asarray(jt.to_u64()).reshape(-1), err_msg=where)
    if r is None:  # c_1 (and the dense evaluations) of the same tables
        with jax.disable_jit():
            jc1 = int(np.asarray(jrk.sum_products(_jspec(spec), jaxes).to_u64()).reshape(-1)[0])
            jev = np.asarray(jrk.product_evals(_jspec(spec), jaxes).to_u64()) if evals else None
        assert rk.sum_products(spec, ports).item().v == jc1, where
        if evals:
            np.testing.assert_array_equal(rk.product_evals(spec, ports).to_u64(), jev, err_msg=where)
    else:
        again = rk.fold_step(spec, ports, r)
        assert all(np.array_equal(a.to_u64(), b.to_u64()) for a, b in zip(again, folded)), where


def test_round_step_multiblock_matches_jax():
    """Every block transition of the triangle spec (3 x 3 variables: X with
    3, 2 and 1 bits left, X -> Y, Y -> Z, Z) over Goldilocks and F389; dense
    W (2 x 2) in both phases and the single-block shapes the round kernel
    does not take (k = 1, k = 4, a scalar-table product) over F389 only (the
    plain version's code is the same for both fields; Goldilocks' eager JAX
    side costs ~4x F389's); random values and values at p - 1: each start
    state with no fold, fold and fold with the claim, every later state with
    the fold and the claim (which sums over state j + 1's shapes, so every
    state's sums are checked)."""
    rng = np.random.default_rng(11)
    cases = [
        # 3 x 3 variables: the 8-node proofs below run the same shapes
        (rk.PolySpec((3, 3, 3), TRI, ((0, 1, 2),)), (0, 1, 2, 5, 6, 7)),
        (rk.PolySpec((2, 2), ((0, 1), (0, 1), (0,), (1,)), ((0, 2), (0, 3), (1, 2, 3))), (0, 1, 2)),
        (rk.single_block_spec(1, 3), (0,)),
        (rk.single_block_spec(4, 3), (0,)),
        (rk.PolySpec((3,), ((0,), (0,), ()), ((0, 2), (1,), (0, 1, 2))), (0,)),
    ]
    for field in (GOLDILOCKS, F389):
        for spec0, states in cases[: 1 if field is GOLDILOCKS else 5]:
            for j in states:
                spec = _folded(spec0, j)
                modes = ("no_fold", "fold", "fold_claim") if j == 0 else ("fold_claim",)
                for mode in modes:
                    if mode != "no_fold" and spec.num_vars() < 2:
                        continue
                    for fill in ("random", "max"):
                        _check_round(spec, field, rng, mode, fill, f"{field.name} {spec} {mode} {fill}",
                                     evals=j == 0 and fill == "random")


def test_modmatmul_matches_jax():
    """C = A B^T mod p and the contraction's partials (summed) against the
    JAX modmatmul_impl and its int8-digit form, at shapes that are not
    multiples of the kernels' tiles, random and p - 1 values: the plain
    version and the tensor-core kernel's digit form, and the partials at
    both kernels' tiles (the routed ones at the tensor-core kernel's)."""
    rng = np.random.default_rng(12)
    for field in (GOLDILOCKS, F1572869):
        for m, n, k in ((1, 1, 1), (3, 70, 5), (65, 2, 9)):
            for fill in ("random", "max"):
                a, ja = _both(_values(rng, field, 2 * m * k, fill), field)
                b, jb = _both(_values(rng, field, n * k, fill), field)
                d, jd = _both(_values(rng, field, 2 * m * n, fill), field)
                a, ja, b, jb = a.reshape(2 * m, k), ja.reshape(2 * m, k), b.reshape(n, k), jb.reshape(n, k)
                d, jd = d.reshape(2 * m, n), jd.reshape(2 * m, n)
                with jax.disable_jit():
                    jmat = jmm.modmatmul_impl(ja[:m], jb)
                    jc = np.asarray(jmat.to_u64())
                    jdot = int(np.asarray(jrk._dot_all(jd[:m], jmat).to_u64()))
                    if fill == "max" and n == 70 and field is F1572869:  # JAX's int8-digit form (2^24 up)
                        np.testing.assert_array_equal(np.asarray(jmm._mxu_modmatmul_impl(ja[:m], jb).to_u64()), jc)
                c = modmatmul.modmatmul(a[:m], b)
                np.testing.assert_array_equal(c.to_u64(), jc)
                # the tensor-core kernel's digit form (byte planes, diagonal sums, recombination)
                np.testing.assert_array_equal(modmatmul.modmatmul_digits_plain(a[:m], b).to_u64(), jc)
                tm, tn = modmatmul.TC_TILE[field.backend]
                parts = modmatmul.contract_partials(a[:m].data.contiguous(), b.data, d[:m].data.contiguous(), field)
                assert parts.shape == ((-(-m // tm)) * (-(-n // tn)),)
                assert FArray(parts, field).sum(axis=0).item().v == jdot
                tc = modmatmul.contract_partials_tc(a[:m].data.contiguous(), b.data, d[:m].data.contiguous(), field)
                assert torch.equal(tc, parts)
                cc = modmatmul.contract_partials_cc(a[:m].data.contiguous(), b.data, d[:m].data.contiguous(), field)
                assert cc.shape == ((-(-m // modmatmul.TILE)) * (-(-n // modmatmul.TILE)),)
                assert FArray(cc, field).sum(axis=0).item().v == jdot
                # the view at t = 3 equals the contraction of the tables' views
                three = FArray.from_ints([3], field, device="cpu").reshape(())
                a3, d3 = FArray.fold(a[:m], a[m:], three), FArray.fold(d[:m], d[m:], three)
                want = (d3 * modmatmul.modmatmul(a3, b)).reshape(-1).sum(axis=0).item()
                got = FArray(modmatmul.contract_partials(a.data, b.data, d.data, field, 3), field).sum(axis=0)
                assert got.item() == want


def test_contraction_forced_matches_jax(monkeypatch):
    """With the contraction threshold at 0 in both packages (every triangle
    round and c_1 through the modular matmul), the transcript of a random
    8-node graph equals the JAX package's forced run and the port's
    default run."""
    adj = _graph(8, 5)
    flat = [bool(x) for x in adj.reshape(-1)]
    claim, t = api.prove_triangle_count(adj, 8, F1572869, device="cpu")
    monkeypatch.setattr(rk, "CONTRACT_THRESHOLD", 0)
    monkeypatch.setattr(jrk, "_CONTRACT_THRESHOLD", 0)
    jrk._round_step_jit.cache_clear()
    jrk._sum_products_jit.cache_clear()
    try:
        forced = api.prove_triangle_count(adj, 8, F1572869, device="cpu")
        with jax.disable_jit():
            jclaim, jt = japi.prove_triangle_count(flat, 8, jfields.F1572869)
    finally:
        jrk._round_step_jit.cache_clear()
        jrk._sum_products_jit.cache_clear()
    assert forced[0] == claim == jclaim == _six_delta(adj) % F1572869.p
    assert forced[1].to_bytes() == t.to_bytes() == jt.to_bytes()


def _rejects(adj, n, t, field) -> bool:
    try:
        return not api.verify_triangle_count(adj, n, t, field, device="cpu")
    except (SumCheckError, SerializationError, ValueError):
        return True


REFERENCE_4 = np.array([[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]], dtype=bool)


@pytest.mark.parametrize(
    "n,field,seeds",
    [(4, F389, None), (8, F1572869, (1, 2)), (8, GOLDILOCKS, (3,)), (8, BABYBEAR, (4,))],
    ids=["ref4-f389", "rand8-f1572869", "rand8-goldilocks", "rand8-babybear"],
)
def test_triangle_transcripts_match_jax(n, field, seeds):
    """prove_triangle_count byte for byte against the JAX package, 6 Delta
    against brute force, the verifier accepts and rejects a tampered
    transcript; the reference's graph has one triangle (6 Delta = 6)."""
    graphs = [REFERENCE_4] if seeds is None else [_graph(n, s) for s in seeds]
    for adj in graphs:
        claim, t = api.prove_triangle_count(adj, n, field, device="cpu")
        with jax.disable_jit():
            jclaim, jt = japi.prove_triangle_count([bool(x) for x in adj.reshape(-1)], n, _jf(field))
        assert claim == jclaim == _six_delta(adj) % field.p
        assert t.to_bytes() == jt.to_bytes()
        assert api.verify_triangle_count(adj, n, t, field, device="cpu")
        bad = [bytearray(m) for m in t.g]
        bad[len(bad) // 2][-1] ^= 1
        assert _rejects(adj, n, FiatShamirTranscript([bytes(m) for m in bad]), field)
    if seeds is None:
        assert claim == 6


def test_state_carried_from_jax():
    """A JAX TriangleG proven to just after the X -> Y transition, carried
    into the port with from_jax_state; the remaining rounds agree with the
    JAX polynomial's at the same challenges."""
    field, n = F1572869, 8
    adj = _graph(n, 6)
    k = 3
    rng = np.random.default_rng(7)
    rs = [field.felt(int(x)) for x in rng.integers(0, field.p, 3 * k, dtype=np.uint64)]
    jfield = _jf(field)
    with jax.disable_jit():
        jg = JTriangleG.new_adj_matrix(2 * k, [bool(x) for x in adj.reshape(-1)], jfield)
        uni, jg = jg.round_univariate(None)
        for j in range(1, k + 1):
            uni, jg = jg.round_univariate(jfield.felt(rs[j - 1].v))
    assert len(jg.spec.block_sizes) == 2  # Y and Z left
    limbs = [tuple(np.asarray(x) for x in t.limbs) for t in jg.tables]
    g = from_jax_state(jg.spec, limbs, field, cls=TriangleG, device="cpu")
    assert isinstance(g, TriangleG) and g.spec.block_sizes == (k, k)
    for j in range(k + 1, 3 * k):
        uni, g = g.round_univariate(rs[j - 1])
        with jax.disable_jit():
            juni, jg = jg.round_univariate(jfield.felt(rs[j - 1].v))
        assert [(d, c.v) for d, c in uni.terms] == [(d, c.v) for d, c in juni.terms], j
