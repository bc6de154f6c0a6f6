"""The port's round step against the JAX package's ``round_kernel.round_step``.

The JAX ``round_step`` is the XLA twin of the Pallas round kernel (the JAX
tests hold the two bit for bit); the Pallas kernel itself is pathologically
slow in interpret mode on the CPU, so the reference here is the XLA path,
run with jit disabled (the same jnp code, eagerly: seconds instead of a
compile per shape). The port's side is the plain version of the CUDA round
kernel, which CPU tensors take. Inputs come from a seed via numpy and reach
both packages as the same uint32 limbs. Tolerance: exact equality of the
round sums and of the folded tables. The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.

Cases loop inside a few test functions on purpose: the suite runs under
pytest-xdist ``--dist loadfile``, which starts files with more cases first;
more than 7 here would start this file ahead of the long GKR files and
lengthen the whole run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thaler_study_tpu.fields import GOLDILOCKS as JF  # noqa: E402
from thaler_study_tpu.fields import FArray as JFArray  # noqa: E402
from thaler_study_tpu.ops import round_kernel as jrk  # noqa: E402
from thaler_study_tpu_torch import api, gkr  # noqa: E402
from thaler_study_tpu_torch.fields import F389, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.fields import goldilocks as gl  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import (  # noqa: E402
    SumcheckInteractiveProver,
    SumcheckInteractiveVerifier,
    generate_transcript,
    verify_transcript,
)
from thaler_study_tpu_torch.ops import cuda_round, fs_kernel  # noqa: E402
from thaler_study_tpu_torch.ops import round_kernel as rk  # noqa: E402
from thaler_study_tpu_torch.protocols import ProductPoly  # noqa: E402
from thaler_study_tpu_torch.sumcheck import Prover, Verifier  # noqa: E402

P = GOLDILOCKS.p
_BOUNDARY = np.array(
    [0, 1, P - 1, (1 << 32) + 1, 1 << 63, (1 << 64) - (1 << 32)], dtype=np.uint64
)


def _values(rng, shape) -> np.ndarray:
    v = rng.integers(0, P, size=shape, dtype=np.uint64)
    flat = v.reshape(-1)
    m = min(flat.size, len(_BOUNDARY))
    flat[:m] = rng.permutation(_BOUNDARY)[:m]
    return v


def _limbs(v):
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32)


def _both(v):
    """The same values as a port FArray (CPU) and a JAX FArray."""
    lo, hi = _limbs(v)
    return FArray.from_jax_limbs(lo, hi, device="cpu"), JFArray((jnp.asarray(lo), jnp.asarray(hi)), JF)


def _jax_u64(fa) -> np.ndarray:
    return np.asarray(fa.to_u64())


@pytest.mark.parametrize("k", [2, 3])
def test_round_step_matches_jax(k):
    for n in (2, 3, 8):
        for mode in ("no_fold", "fold", "fold_claim"):
            _check_round_step(k, n, mode)


def _check_round_step(k, n, mode):
    rng = np.random.default_rng(1000 * k + 10 * n + len(mode))
    spec = rk.single_block_spec(k, n)
    jspec = jrk.PolySpec(spec.block_sizes, spec.table_blocks, spec.terms)
    pairs = [_both(_values(rng, 1 << n)) for _ in range(k)]
    tables, jtables = [p[0] for p in pairs], [p[1] for p in pairs]
    r = claim = jr = jclaim = None
    if mode != "no_fold":
        r, jr = (x.reshape(()) for x in _both(_values(rng, 1)))
    if mode == "fold_claim":
        claim, jclaim = (x.reshape(()) for x in _both(_values(rng, 1)))
    sums, folded = rk.round_step(spec, tables, r, claim=claim)
    with jax.disable_jit():
        jsums, jfolded = jrk.round_step(jspec, jtables, jr, claim=jclaim)
    where = f"k={k} n={n} {mode}"
    np.testing.assert_array_equal(sums.to_u64(), _jax_u64(jsums), err_msg=where)
    assert len(folded) == len(jfolded) == k
    for t, jt in zip(folded, jfolded):
        np.testing.assert_array_equal(t.to_u64(), _jax_u64(jt), err_msg=where)
    if mode != "no_fold":
        assert folded[0].shape == (1 << (n - 1),)


def test_partials_sum_to_one_block_result():
    """The per-block split (the CUDA grid's) never changes the round sums."""
    for blocks in (1, 3, 8):
        rng = np.random.default_rng(blocks)
        tables = [torch.from_numpy(_values(rng, (3, 64)).view(np.int64)) for _ in range(2)]
        r = torch.from_numpy(_values(rng, 3).view(np.int64))
        for rr in (None, r):
            ref_folded, ref = cuda_round.round_partials_plain(tables, rr, False, 1)
            folded, parts = cuda_round.round_partials_plain(tables, rr, False, blocks)
            assert parts.shape == (3, blocks, 3)
            assert torch.equal(gl.sum_mod(parts, 1), ref[:, 0])
            if rr is not None:
                assert all(torch.equal(a, b) for a, b in zip(folded, ref_folded))


def test_round_partials_writes_out_and_keeps_inputs():
    rng = np.random.default_rng(5)
    tables = [torch.from_numpy(_values(rng, (2, 16)).view(np.int64)) for _ in range(2)]
    before = [t.clone() for t in tables]
    r = torch.from_numpy(_values(rng, 2).view(np.int64))
    out = [torch.empty((2, 8), dtype=torch.int64) for _ in range(2)]
    folded, _ = cuda_round.round_partials(tables, r, skip_t1=True, out=out)
    assert all(f is o for f, o in zip(folded, out))
    assert all(torch.equal(a, b) for a, b in zip(tables, before))
    with pytest.raises(ValueError):
        cuda_round.round_partials([tables[0][:, :6].contiguous()], r)  # 6 is no power of two


def test_product_poly_sumcheck_accepts(rng):
    n, k = 5, 3
    spec = rk.single_block_spec(k, n)
    tables = [FArray.from_ints([rng.randrange(P) for _ in range(1 << n)], GOLDILOCKS, device="cpu")
              for _ in range(k)]
    t = generate_transcript(SumcheckInteractiveProver(Prover(ProductPoly(spec, tables))), GOLDILOCKS)
    v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, tables), strict=True), GOLDILOCKS)
    assert verify_transcript(t, v, GOLDILOCKS)
    # the oracle's evaluations sum to c_1
    evals = ProductPoly(spec, tables).to_evaluations()
    assert sum(e.v for e in evals) % P == Prover(ProductPoly(spec, tables)).c_1().v


def test_outside_the_slice_raises():
    """The edges of the port: a spec of more than three blocks no longer
    raises (it is merged down to three, so ``round_step`` and the sharded
    prover take it); the fused FS prover returns None where the JAX
    package's does: a non-empty DST or a round of degree 0. Every field of
    the port and every spec of round degrees >= 1, a multi-block one too,
    are in the fused path."""
    from thaler_study_tpu_torch.parallel import ShardedBlockPoly, make_mesh

    multi = rk.PolySpec(block_sizes=(1, 2), table_blocks=((0,), (0, 1)), terms=((0, 1),))
    flat = rk.PolySpec(block_sizes=(1, 1), table_blocks=((0,), (0,)), terms=((0, 1),))  # round 1: degree 0
    wide = rk.PolySpec(block_sizes=(1, 1, 1, 1), table_blocks=((0, 1, 2, 3),), terms=((0,),))
    ones = [FArray.from_ints(list(range(1, 17)), GOLDILOCKS, device="cpu")]
    sums, _ = rk.round_step(wide, ones, None)
    assert [int(x) for x in sums.to_ints()] == [sum(range(1, 9)), sum(range(9, 17))]
    sharded = ShardedBlockPoly.from_internal_tables(wide, ones, make_mesh(["cpu"] * 2))
    assert sharded.sum_evaluations().v == sum(range(1, 17))
    spec = rk.single_block_spec(2, 2)
    batch = [FArray.from_ints([[1, 2, 3, 4]], GOLDILOCKS, device="cpu") for _ in range(2)]
    for s, field, dst in ((flat, GOLDILOCKS, b""), (spec, GOLDILOCKS, b"tag"), (spec, F389, b"tag")):
        assert not fs_kernel.supports_fused_fs(s, field, dst)
    assert fs_kernel.supports_fused_fs(spec, F389, b"") and fs_kernel.supports_fused_fs(multi, GOLDILOCKS, b"")
    assert fs_kernel.fs_prove_device_batch(flat, [batch[0][:, :2]] * 2) is None
    assert fs_kernel.fs_prove_device_batch(spec, batch, b"tag") is None
    # the triangle entry points and the dense-W prover are ported: an empty
    # graph proves 0 triangles, the book circuit's dense W runs
    claim, t = api.prove_triangle_count([False] * 16, 4, F389, device="cpu")
    assert claim == 0 and api.verify_triangle_count([False] * 16, 4, t, F389, device="cpu")
    gkr.Prover(gkr.circuit_from_book(), F389.felts([3, 2, 3, 1]), F389, use_linear=False, device="cpu")
