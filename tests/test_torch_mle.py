"""The port's MLE module (``thaler_study_tpu_torch.mle``) against the JAX
package's, on the CPU.

- The exported names: JAX's, and ``bitrev``.
- The reference crate's golden test, the 5 x 5 extension table of the
  evaluations [1, 2, 1, 4] over F5 (``SURVEY.md`` §4;
  multilinear-extensions/src/lib.rs:76-120), through both algorithms,
  ``vsbw_multilinear_from_evaluations`` and
  ``cti_multilinear_from_evaluations``, as ``tests/test_mle.py`` runs it.
- ``eq_weight_table`` in both index orders, ``fold_msb``,
  ``DenseMLE.to_evals_lsb_farray`` and both algorithms on random points
  (coordinates at p - 1 included) over Goldilocks and F389, equal to the
  JAX package's and to ``DenseMLE.evaluate``.

The JAX side runs eagerly under ``jax.disable_jit()``; inputs come from
numpy seeds; tolerance: exact equality (field values). On the card,
``eq_weight_table`` is the eq-table kernel, which ``chip_smoke.py`` holds
against this plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu import mle as jmle  # noqa: E402
from thaler_study_tpu_torch import mle  # noqa: E402
from thaler_study_tpu_torch.fields import F5, F389, GOLDILOCKS, FArray  # noqa: E402

JFIELD = {"Goldilocks": jfields.GOLDILOCKS, "F389": jfields.F389, "F5": jfields.F5}

BOOK = [
    [1, 2, 3, 4, 0],
    [1, 4, 2, 0, 3],
    [1, 1, 1, 1, 1],
    [1, 3, 0, 2, 4],
    [1, 0, 4, 3, 2],
]


def _jfelts(field, ints):
    return JFIELD[field.name].felts([int(x) for x in ints])


def test_book_table_both_algorithms_match_jax():
    assert set(mle.__all__) == set(jmle.__all__) | {"bitrev"}
    evals, jevals = F5.felts([1, 2, 1, 4]), _jfelts(F5, [1, 2, 1, 4])
    for i in range(5):
        for j in range(5):
            r = F5.felts([i, j])
            want = BOOK[i][j]
            assert mle.vsbw_multilinear_from_evaluations(evals, r, device="cpu").v == want
            assert mle.cti_multilinear_from_evaluations(evals, r).v == want
            with jax.disable_jit():
                assert jmle.vsbw_multilinear_from_evaluations(jevals, _jfelts(F5, [i, j])).v == want
    with pytest.raises(ValueError):
        mle.vsbw_multilinear_from_evaluations(evals, F5.felts([1]), device="cpu")


def test_mle_algorithms_match_jax():
    rng = np.random.default_rng(59)
    for field in (GOLDILOCKS, F389):
        p = field.p
        for n in (1, 3, 5):
            point = [p - 1] + [int(x) for x in rng.integers(0, p, n - 1, dtype=np.uint64)]
            evals = [int(x) for x in rng.integers(0, p, 1 << n, dtype=np.uint64)]
            evals[-1] = p - 1
            felts, jpoint = field.felts(point), _jfelts(field, point)
            with jax.disable_jit():
                for lsb in (True, False):
                    got = mle.eq_weight_table(felts, lsb_order=lsb, device="cpu").to_u64()
                    want = np.asarray(jmle.eq_weight_table(jpoint, lsb_order=lsb).to_u64(), dtype=np.uint64)
                    assert np.array_equal(got, want), (field.name, n, lsb)
                jtable = jfields.FArray.from_ints(np.array(evals, dtype=np.uint64), JFIELD[field.name])
                jr = jfields.FArray.scalar(JFIELD[field.name].felt(point[0]))
                jfold = np.asarray(jmle.fold_msb(jtable, jr).to_u64(), dtype=np.uint64)
                jd = jmle.DenseMLE.from_evals_lsb(_jfelts(field, evals), n, JFIELD[field.name])
                jlsb = np.asarray(jd.to_evals_lsb_farray().to_u64(), dtype=np.uint64)
                jvsbw = jmle.vsbw_multilinear_from_evaluations(_jfelts(field, evals), jpoint).v
            table = FArray.from_ints(evals, field, device="cpu")
            folded = mle.fold_msb(table, FArray.scalar(field.felt(point[0]), device="cpu"))
            assert np.array_equal(folded.to_u64(), jfold), (field.name, n)
            dense = mle.DenseMLE.from_evals_lsb(evals, n, field, device="cpu")
            assert np.array_equal(dense.to_evals_lsb_farray().to_u64(), jlsb)
            assert np.array_equal(jlsb, np.array(evals, dtype=np.uint64))
            vsbw = mle.vsbw_multilinear_from_evaluations(field.felts(evals), felts, device="cpu")
            cti = mle.cti_multilinear_from_evaluations(field.felts(evals), felts)
            assert vsbw.v == cti.v == jvsbw, (field.name, n)
            # big-endian evaluations: the MLE of the table in internal order
            assert vsbw.v == mle.DenseMLE.from_evals_msb(table, n).evaluate(felts).v
