"""The port's dense MLEs and matrix-multiplication IP against the JAX package.

- ``DenseMLE`` (``from_evals_lsb``, ``fix_variables``, ``relabel``,
  ``evaluate``, ``sum``, ``to_evaluations``) and ``bitrev_perm`` over
  Goldilocks and F389;
- ``MatMulG`` tables, and ``api.prove_matmul_entry`` transcripts, byte for
  byte at n_log = 3..5 over Goldilocks and F5, with the claim checked
  against the product computed with Python ints; the verifier accepts and
  rejects a flipped byte; the 2 x 2 book example
  (``tests/test_matmul.py``).
- the public surface on input outside the port's slices, as the JAX
  package answers it: ``api.run_gkr`` takes ``mesh=`` and ``n_shard=`` and
  raises ``NotImplementedError`` for either; ``fs_prove_device`` and
  ``fs_prove_device_batch`` return ``None`` for a non-empty DST and a spec
  with a degree-0 round and fuse a multi-block spec (as JAX's do);
  ``generate_transcripts_batch`` with a non-empty DST takes the per-round
  path, byte-identical to the JAX package's.

The port runs on CPU tensors (the plain version of the round kernel); the
JAX side runs eagerly under ``jax.disable_jit()``. Inputs come from numpy
seeds; tolerance: exact equality.

Cases loop inside a few test functions on purpose: the suite runs under
pytest-xdist ``--dist loadfile``, which starts files with more cases first;
more than 8 here would start this file ahead of the JAX package's long
``tests/test_gkr_fused.py`` (8 cases, earlier in collection order) and
lengthen the whole run.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import api as japi  # noqa: E402
from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu.ops import fs_kernel as jfs  # noqa: E402
from thaler_study_tpu.ops import round_kernel as jrk  # noqa: E402
from thaler_study_tpu.mle.dense import DenseMLE as JDenseMLE  # noqa: E402
from thaler_study_tpu.mle.dense import bitrev_perm as jbitrev_perm  # noqa: E402
from thaler_study_tpu.protocols import MatMulG as JMatMulG  # noqa: E402
from thaler_study_tpu_torch import api, gkr  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import FiatShamirTranscript, SerializationError  # noqa: E402
from thaler_study_tpu_torch.fields import F5, F389, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.mle import DenseMLE, bitrev_perm  # noqa: E402
from thaler_study_tpu_torch.ops import fs_kernel  # noqa: E402
from thaler_study_tpu_torch.ops import round_kernel as rk  # noqa: E402
from thaler_study_tpu_torch.protocols import BatchedProductPoly, MatMulG, generate_transcripts_batch  # noqa: E402
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


@pytest.mark.parametrize("entry", ["run_gkr", "fs_prove_device", "generate_transcripts_batch"])
def test_unsupported_input_follows_jax(entry):
    """What the public surface does with input outside the port's slices,
    against the JAX package's answer where it gives one without compiling."""
    if entry == "run_gkr":
        params = list(inspect.signature(api.run_gkr).parameters)
        assert params[:6] == list(inspect.signature(japi.run_gkr).parameters)
        for kw in ({"mesh": object()}, {"n_shard": 2}):
            with pytest.raises(NotImplementedError, match="multi-device"):
                api.run_gkr(gkr.circuit_from_book(), [3, 2, 3, 1], F389, device="cpu", **kw)
        outs, ok = api.run_gkr(gkr.circuit_from_book(), [3, 2, 3, 1], F389, seed=1, mesh=None, n_shard=None,
                               device="cpu")
        assert ok and [f.v for f in outs] == [36, 6]
        return
    vals = _values(GOLDILOCKS, 31, 2 * 16).reshape(2, 16)
    batch = [FArray.from_ints(v[None, :], GOLDILOCKS, device="cpu") for v in vals]
    spec = rk.single_block_spec(2, 4)
    if entry == "fs_prove_device":
        jtables = [jfields.FArray.from_ints(v, jfields.GOLDILOCKS) for v in vals]
        jspec = jrk.PolySpec(block_sizes=(4,), table_blocks=((0,), (0,)), terms=((0, 1),))
        assert jfs.fs_prove_device(jspec, jtables, b"tag") is None
        assert jfs.fs_prove_device_batch(jspec, [t.reshape(1, -1) for t in jtables], b"tag") is None
        assert fs_kernel.fs_prove_device(spec, [t[0] for t in batch], b"tag") is None
        assert fs_kernel.fs_prove_device_batch(spec, batch, b"tag") is None
        # a multi-block spec is fused in both packages; a degree-0 round in neither
        multi = rk.PolySpec(block_sizes=(2, 2), table_blocks=((0,), (0, 1)), terms=((0, 1),))
        flat = rk.PolySpec(block_sizes=(2, 2), table_blocks=((0,), (0,)), terms=((0, 1),))
        for s, want in ((multi, True), (flat, False)):
            js = jrk.PolySpec(s.block_sizes, s.table_blocks, s.terms)
            assert fs_kernel.supports_fused_fs(s, GOLDILOCKS, b"") == jfs.supports_fused_fs(js, jfields.GOLDILOCKS,
                                                                                          b"") == want
        assert fs_kernel.fs_prove_device(multi, [batch[0][0, :4], batch[1][0]]) is not None
        assert fs_kernel.fs_prove_device(flat, [batch[0][0, :4], batch[1][0, :4]]) is None
        assert fs_kernel.fs_prove_device(spec, [t[0] for t in batch]) is not None
        return
    # a non-empty DST: the per-round path, the JAX package's bytes
    from thaler_study_tpu.protocols import BatchedProductPoly as JBatched
    from thaler_study_tpu.protocols import generate_transcripts_batch as jgenerate_batch

    with jax.disable_jit():
        jt = jgenerate_batch(JBatched([jfields.FArray.from_ints(v, jfields.GOLDILOCKS).reshape(1, -1) for v in vals]),
                             jfields.GOLDILOCKS, b"tag")
    assert [t.to_bytes() for t in generate_transcripts_batch(BatchedProductPoly(batch), GOLDILOCKS, b"tag")] == [
        t.to_bytes() for t in jt]
    assert len(generate_transcripts_batch(BatchedProductPoly(batch), GOLDILOCKS)) == 1
