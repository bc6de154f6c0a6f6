"""The port's dense MLEs and matrix-multiplication IP against the JAX package.

- ``DenseMLE`` (``from_evals_lsb``, ``fix_variables``, ``relabel``,
  ``evaluate``, ``sum``, ``to_evaluations``) and ``bitrev_perm`` over
  Goldilocks and F389;
- ``MatMulG`` tables, and ``api.prove_matmul_entry`` transcripts, byte for
  byte at n_log = 3..5 over Goldilocks and F5, with the claim checked
  against the product computed with Python ints; the verifier accepts and
  rejects a flipped byte; the 2 x 2 book example
  (``tests/test_matmul.py``).

The port runs on CPU tensors (the plain version of the round kernel); the
JAX side runs eagerly under ``jax.disable_jit()``. Inputs come from numpy
seeds; tolerance: exact equality.

Cases loop inside a few test functions on purpose: the suite runs under
pytest-xdist ``--dist loadfile``, which starts files with more cases first;
more than 7 here would start this file ahead of the long GKR files and
lengthen the whole run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from thaler_study_tpu import api as japi  # noqa: E402
from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu.mle.dense import DenseMLE as JDenseMLE  # noqa: E402
from thaler_study_tpu.mle.dense import bitrev_perm as jbitrev_perm  # noqa: E402
from thaler_study_tpu.protocols import MatMulG as JMatMulG  # noqa: E402
from thaler_study_tpu_torch import api  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import FiatShamirTranscript, SerializationError  # noqa: E402
from thaler_study_tpu_torch.fields import F5, F389, GOLDILOCKS  # noqa: E402
from thaler_study_tpu_torch.mle import DenseMLE, bitrev_perm  # noqa: E402
from thaler_study_tpu_torch.protocols import MatMulG  # noqa: E402
from thaler_study_tpu_torch.sumcheck import SumCheckError  # noqa: E402

JFIELD = {"Goldilocks": jfields.GOLDILOCKS, "F389": jfields.F389, "F5": jfields.F5}


def _jfelts(felts):
    return [jfields.Felt(f.v, JFIELD[f.field.name]) for f in felts]


def _values(field, seed, size):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, field.p, size=size, dtype=np.uint64)
    v[:3] = [0, 1, field.p - 1]
    return v


def test_bitrev_perm_matches_jax():
    for n in range(0, 13):
        np.testing.assert_array_equal(bitrev_perm(n), jbitrev_perm(n))


def test_dense_mle_matches_jax():
    n = 6
    for field in (GOLDILOCKS, F389):
        jf = JFIELD[field.name]
        vals = _values(field, field.p % 1000, 1 << n)
        rng = np.random.default_rng(7)
        point = [field.felt(int(x)) for x in rng.integers(0, field.p, size=n, dtype=np.uint64)]
        with jax.disable_jit():
            ref = JDenseMLE.from_evals_lsb(vals, n, jf)
            for src in (vals, [int(x) for x in vals], [field.felt(int(x)) for x in vals]):
                mle = DenseMLE.from_evals_lsb(src, n, field, device="cpu")
                assert list(mle.evals.to_u64()) == list(ref.evals.to_u64())
            assert [f.v for f in mle.to_evaluations()] == [int(x) for x in vals]
            assert mle.sum().v == ref.sum().v == sum(int(x) for x in vals) % field.p
            for k in range(n + 1):
                got = mle.fix_variables(point[:k])
                want = ref.fix_variables(_jfelts(point[:k]))
                assert got.num_vars == want.num_vars == n - k
                assert list(got.evals.to_u64()) == list(want.evals.to_u64()), (field.name, k)
            assert mle.evaluate(point).v == ref.evaluate(_jfelts(point)).v
            for a, b, k in ((0, 3, 3), (1, 4, 2), (4, 0, 2), (2, 2, 3), (0, 5, 1)):
                got, want = mle.relabel(a, b, k), ref.relabel(a, b, k)
                assert list(got.evals.to_u64()) == list(want.evals.to_u64()), (field.name, a, b, k)
        with pytest.raises(ValueError):
            mle.relabel(0, 2, 3)  # overlapping blocks


def test_matmul_tables_match_jax():
    for field in (GOLDILOCKS, F5):
        for n_log in (3, 4, 5):
            a = _values(field, n_log, 1 << (2 * n_log))
            b = _values(field, n_log + 10, 1 << (2 * n_log))
            rng = np.random.default_rng(n_log)
            point = [field.felt(int(x)) for x in rng.integers(0, field.p, size=2 * n_log, dtype=np.uint64)]
            g = MatMulG.new(n_log, a, b, point, device="cpu")
            g_list = MatMulG.new(n_log, [int(x) for x in a], [field.felt(int(x)) for x in b], point, device="cpu")
            with jax.disable_jit():
                jg = JMatMulG.new(n_log, [int(x) for x in a], [int(x) for x in b], _jfelts(point))
            for t, tl, jt in zip(g.tables, g_list.tables, jg.tables):
                assert list(t.to_u64()) == list(tl.to_u64()) == list(jt.to_u64()), (field.name, n_log)


def _check_entry(field, n_log, a, b, i, j):
    n = 1 << n_log
    claim, t = api.prove_matmul_entry(n_log, a, b, i, j, field, device="cpu")
    with jax.disable_jit():
        jclaim, jt = japi.prove_matmul_entry(
            n_log, [int(x) for x in a], [int(x) for x in b], i, j, JFIELD[field.name]
        )
    want = sum(int(a[i * n + k]) * int(b[k * n + j]) for k in range(n)) % field.p
    assert claim.v == jclaim.v == want, (field.name, n_log, i, j)
    assert t.to_bytes() == jt.to_bytes(), (field.name, n_log, i, j)
    assert api.verify_matmul_entry(n_log, a, b, i, j, t, field, device="cpu")
    return t


def test_matmul_entry_matches_jax():
    for field in (GOLDILOCKS, F5):
        for n_log in (3, 4, 5):
            n = 1 << n_log
            a = _values(field, 20 + n_log, n * n)
            b = _values(field, 30 + n_log, n * n)
            for i, j in ((0, 0), (n - 1, n // 2)):
                t = _check_entry(field, n_log, a, b, i, j)
            bad = [bytearray(m) for m in t.g]
            bad[1][16] ^= 1  # lowest byte of round 1's first coefficient
            with pytest.raises((SumCheckError, SerializationError, AssertionError)):
                assert api.verify_matmul_entry(
                    n_log, a, b, i, j, FiatShamirTranscript([bytes(m) for m in bad]), field, device="cpu"
                ), "tampered transcript verified"


def test_book_example():
    """2x2 over F5 (reference example_from_book, matrix-multiplication/
    src/lib.rs:246-303): C = A*B = [[0, 4], [2, 0]]."""
    a, b = [0, 1, 2, 0], [1, 0, 0, 4]
    for i in range(2):
        for j in range(2):
            claim, _ = api.prove_matmul_entry(1, a, b, i, j, F5, device="cpu")
            assert claim.v == [[0, 4], [2, 0]][i][j]
            _check_entry(F5, 1, np.array(a, dtype=np.uint64), np.array(b, dtype=np.uint64), i, j)
