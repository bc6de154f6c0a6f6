"""The port's sharded prover (``thaler_study_tpu_torch/parallel``) against
the JAX package, on the CPU.

- ``ShardedProductPoly`` (Goldilocks and BabyBear, n_shard 1 and 3) and
  ``ShardedBlockPoly`` (the 16-node triangle sharded on Z, its contraction
  forced onto the batched matmul's plain version too; dense GKR W over 2 x
  2^3 variables sharded on c): per-round transcripts;
- ``fs_prove_device_sharded`` / ``generate_transcript_device(mesh=)``: a
  product, the triangle, two multi-block specs drawn from a seed (one with
  a replicated-only term), every variable of the last block sharded,
  BabyBear; ``None`` where the JAX
  package's decision gives ``None`` (a zero coefficient, a non-empty DST),
  the per-round fallback's bytes;
- ``modmatmul_batched``, ``contract_partials_tc`` per shard,
  ``contract_total`` over the shards and ``digit_planes`` over a batch (the
  tensor-core matmul's plain versions) against the JAX
  ``modmatmul_batched_impl``;
- meshes: ``make_mesh`` (no card: it raises unless given devices), the
  groups of repeated and alternating devices, ``shard_factor``'s layout
  against the JAX package's.

Every transcript is held byte for byte against the JAX package's
*unsharded* prover, run eagerly under ``jax.disable_jit()``: the JAX
package's own ``tests/test_parallel.py`` and ``test_multihost.py`` pin its
sharded transcripts to its unsharded ones, so no compiled JAX sharded
program is needed. The port's mesh is 8 shards of the CPU device
(``make_mesh(["cpu"] * 8)``), its counterpart of the JAX tests' virtual
8-device mesh. Inputs come from numpy seeds and reach both packages as the
same integers. Tolerance: exact (transcript bytes, field values). The
kernels' batch forms are held against these plain versions on the card by
``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu.fiat_shamir import SumcheckInteractiveProver as JInteractiveProver  # noqa: E402
from thaler_study_tpu.fiat_shamir import generate_transcript as jgenerate  # noqa: E402
from thaler_study_tpu.gkr import W as JW  # noqa: E402
from thaler_study_tpu.mle.dense import DenseMLE as JDenseMLE  # noqa: E402
from thaler_study_tpu.ops import fs_kernel as jfs  # noqa: E402
from thaler_study_tpu.ops import modmatmul as jmm  # noqa: E402
from thaler_study_tpu.ops.round_kernel import PolySpec as JPolySpec  # noqa: E402
from thaler_study_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from thaler_study_tpu.parallel import shard_factor as jshard_factor  # noqa: E402
from thaler_study_tpu.protocols import ProductPoly as JProductPoly  # noqa: E402
from thaler_study_tpu.protocols import TriangleG as JTriangleG  # noqa: E402
from thaler_study_tpu.sumcheck import Prover as JProver  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import (  # noqa: E402
    FiatShamirTranscript,
    SumcheckInteractiveProver,
    generate_transcript,
    generate_transcript_device,
)
from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.gkr import W  # noqa: E402
from thaler_study_tpu_torch.mle.dense import DenseMLE  # noqa: E402
from thaler_study_tpu_torch.ops import fs_kernel, modmatmul, round_kernel  # noqa: E402
from thaler_study_tpu_torch.ops.round_kernel import PolySpec  # noqa: E402
from thaler_study_tpu_torch.parallel import (  # noqa: E402
    ShardedBlockPoly,
    ShardedProductPoly,
    make_mesh,
    shard_factor,
)
from thaler_study_tpu_torch.protocols import ProductPoly, TriangleG, from_jax_state  # noqa: E402
from thaler_study_tpu_torch.sumcheck import Prover  # noqa: E402

_JF = {"Goldilocks": "GOLDILOCKS", "BabyBear": "BABYBEAR"}
N, NODES, K_W = 6, 16, 3  # product variables, triangle nodes, dense W's k
# multi-block specs drawn from random.Random(777) by the JAX fuzz's own
# procedure (tests/test_multihost.py::test_fused_sharded_random_specs), its
# 5th and 8th draws: three blocks with a replicated table in a sharded
# term; a replicated-only term (scaled by 2^n_shard) with every variable of
# the last block sharded
RANDOM_SPECS = (((2, 2, 3), ((2,), (0, 1), (0, 1, 2)), ((1, 2), (0, 1, 2))),
                ((1, 3), ((0,), (1,)), ((0, 1), (0,))))


def _jf(field):
    return getattr(jfields, _JF[field.name])


def _cpu_mesh(count=8):
    return make_mesh(["cpu"] * count)


def _values(field, n, seed, zero=False):
    if zero:
        return np.zeros(1 << n, dtype=np.uint64)
    v = np.random.default_rng(seed).integers(1, field.p, size=1 << n, dtype=np.uint64)
    v[:2] = [1, field.p - 1]
    return v


def _port(field, vals):
    return [FArray.from_ints(v, field, device="cpu") for v in vals]


def _jax(field, vals):
    return [jfields.FArray.from_ints(np.array([int(x) for x in v], dtype=object), _jf(field)) for v in vals]


def _spec_vals(spec, field, seed, zero=False):
    return [_values(field, sum(spec[0][b] for b in tb), seed + i, zero) for i, tb in enumerate(spec[1])]


@functools.lru_cache(maxsize=None)
def _jax_bytes(spec, field_name, seed, zero=False) -> bytes:
    """The JAX package's host-loop transcript of ProductPoly(spec) over the
    seed's tables (``spec`` as (block_sizes, table_blocks, terms))."""
    field = GOLDILOCKS if field_name == "Goldilocks" else BABYBEAR
    vals = _spec_vals(spec, field, seed, zero)
    with jax.disable_jit():
        poly = JProductPoly(JPolySpec(*spec), _jax(field, vals))
        return jgenerate(JInteractiveProver(JProver(poly)), _jf(field)).to_bytes()


def _product(field, n=N, seed=5, zero=False):
    spec = ((n,), ((0,), (0,)), ((0, 1),))
    return spec, _port(field, _spec_vals(spec, field, seed, zero)), _jax_bytes(spec, field.name, seed, zero)


def _adjacency():
    upper = np.triu(np.random.default_rng(16).random((NODES, NODES)) < 0.5, k=1)
    return upper | upper.T


@functools.lru_cache(maxsize=None)
def _jax_triangle() -> bytes:
    k = (NODES - 1).bit_length()
    with jax.disable_jit():
        g = JTriangleG.new_adj_matrix(2 * k, [bool(x) for x in _adjacency().reshape(-1)], jfields.GOLDILOCKS)
        return jgenerate(JInteractiveProver(JProver(g)), jfields.GOLDILOCKS).to_bytes()


def _triangle():
    k = (NODES - 1).bit_length()
    return TriangleG.new_adj_matrix(2 * k, _adjacency(), GOLDILOCKS, device="cpu"), _jax_triangle()


def _per_round(poly, field) -> bytes:
    return generate_transcript(SumcheckInteractiveProver(Prover(poly)), field).to_bytes()


@pytest.mark.parametrize("field", [GOLDILOCKS, BABYBEAR], ids=lambda f: f.name)
def test_sharded_product_poly_matches_jax(field):
    """n_shard 3 on 8 shards and 1 on 2: the transcript, c_1, a fold-only
    fast-forward and the oracle agree with the JAX package's unsharded
    prover and the port's own."""
    spec, tables, want = _product(field)
    for n_shard, count in ((3, 8), (1, 2)):
        mesh = _cpu_mesh(count)
        poly = ShardedProductPoly.from_internal_tables(tables, mesh, n_shard=n_shard)
        assert poly.num_vars() == N and poly.n_shard == n_shard and poly.has_shard == (True, True)
        assert _per_round(poly, field) == want, n_shard
        local = ProductPoly(PolySpec(*spec), tables)
        assert poly.sum_evaluations() == local.sum_evaluations()
        point = [field.felt(3 * j + 1) for j in range(N)]
        for cut in (2, N - n_shard, N - 1):
            assert poly.fix_variables(point[:cut]).evaluate(point[cut:]) == local.evaluate(point), (n_shard, cut)
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        ShardedProductPoly.from_internal_tables(tables, _cpu_mesh(), n_shard=2)


@pytest.mark.parametrize("case", ["triangle", "dense_w"])
def test_sharded_block_poly_matches_jax(case, monkeypatch):
    """The triangle sharded on Z (f1 replicated; every X round contracted on
    the batched matmul where the threshold is 0) and dense W sharded on c
    (W(b) replicated), against the JAX package's unsharded transcripts."""
    mesh = _cpu_mesh()
    if case == "triangle":
        g, want = _triangle()
        for threshold in (round_kernel.CONTRACT_THRESHOLD, 0):
            monkeypatch.setattr(round_kernel, "CONTRACT_THRESHOLD", threshold)
            poly = ShardedBlockPoly.from_internal_tables(g.spec, g.tables, mesh, n_shard=3)
            assert poly.has_shard == (False, True, True) and poly.num_vars() == 12
            assert _per_round(poly, GOLDILOCKS) == want, threshold
        return
    field = GOLDILOCKS
    rng = np.random.default_rng(33)
    lsb = [rng.integers(0, field.p, size=1 << nv, dtype=np.uint64) for nv in (2 * K_W, 2 * K_W, K_W)]
    add_i, mul_i, w_b = (DenseMLE.from_evals_lsb_farray(FArray.from_ints(v, field, device="cpu"), int(v.size).bit_length() - 1)
                         for v in lsb)
    local = W.new(add_i, mul_i, w_b, w_b)
    poly = ShardedBlockPoly.from_internal_tables(local.spec, local.tables, mesh, n_shard=3)
    assert poly.has_shard == (True, True, False, True)
    with jax.disable_jit():
        jm = [JDenseMLE.from_evals_lsb([int(x) for x in v], int(v.size).bit_length() - 1, jfields.GOLDILOCKS) for v in lsb]
        want = jgenerate(JInteractiveProver(JProver(JW.new(jm[0], jm[1], jm[2], jm[2]))), jfields.GOLDILOCKS)
    assert _per_round(poly, field) == want.to_bytes()
    assert poly.sum_evaluations() == local.sum_evaluations()


def test_fs_prove_device_sharded_matches_jax(monkeypatch):
    """The whole proof across the mesh: a product, the triangle (with its
    contraction forced too), a multi-block spec drawn from a seed, every
    last-block variable sharded, BabyBear; each the JAX host loop's
    bytes."""
    mesh = _cpu_mesh()
    cases = []
    for field in (GOLDILOCKS, BABYBEAR):
        spec, tables, want = _product(field)
        cases.append((f"product {field.name}", PolySpec(*spec), tables, want, 3))
    spec, tables, want = _product(GOLDILOCKS, n=3, seed=9)
    cases.append(("full shard", PolySpec(*spec), tables, want, 3))
    for i, rs in enumerate(RANDOM_SPECS):
        cases.append((f"random spec {i}", PolySpec(*rs), _port(GOLDILOCKS, _spec_vals(rs, GOLDILOCKS, 77)),
                      _jax_bytes(rs, "Goldilocks", 77), 3))
    g, want = _triangle()
    cases.append(("triangle", g.spec, g.tables, want, 3))
    for name, spec, tables, want, n_shard in cases:
        assert jfs.supports_fused_fs(JPolySpec(spec.block_sizes, spec.table_blocks, spec.terms), jfields.GOLDILOCKS,
                                     b"")
        field = tables[0].field
        msgs = fs_kernel.fs_prove_device_sharded(spec, tables, mesh, n_shard=n_shard)
        assert msgs is not None and FiatShamirTranscript(msgs).to_bytes() == want, name
        poly = ProductPoly(spec, tables)
        assert generate_transcript_device(poly, field, mesh=mesh, n_shard=n_shard).to_bytes() == want, name
    monkeypatch.setattr(round_kernel, "CONTRACT_THRESHOLD", 0)
    assert generate_transcript_device(g, GOLDILOCKS, mesh=mesh, n_shard=3).to_bytes() == want


def test_sharded_declines_where_jax_does():
    """A zero serialized coefficient and a non-empty DST: the sharded device
    proof returns None (the JAX package's decision: its host loop drops the
    zero coefficients, so the message lengths change; it does not cover a
    DST), and ``generate_transcript_device(mesh=)`` runs the per-round loop
    over a ShardedBlockPoly: the JAX host loop's bytes."""
    mesh = _cpu_mesh()
    spec, tables, want = _product(GOLDILOCKS, zero=True)
    spec = PolySpec(*spec)
    full = len(want)
    assert fs_kernel.fs_prove_device_sharded(spec, tables, mesh) is None
    assert generate_transcript_device(ProductPoly(spec, tables), GOLDILOCKS, mesh=mesh).to_bytes() == want
    _, _, dense = _product(GOLDILOCKS)
    assert full < len(dense)  # the JAX host loop dropped the zero coefficients
    _, tables, want = _product(GOLDILOCKS)
    dst = b"thaler-sharded"
    assert not jfs.supports_fused_fs(JPolySpec(spec.block_sizes, spec.table_blocks, spec.terms), jfields.GOLDILOCKS, dst)
    assert fs_kernel.fs_prove_device_sharded(spec, tables, mesh, dst=dst) is None


def test_batched_matmul_plain_matches_jax():
    """C[s] = A[s] B[s]^T (the plain digit form of the batched tensor-core
    kernel) against the JAX ``modmatmul_batched_impl``, Goldilocks and
    BabyBear; the contracted round sums per shard, sum f1_t (A_t[s]
    B[s]^T), at t = 0, 2 (the kernel's digit form) and their sum over the
    shards at t = 0, 2 and with no view (``contract_total``, the sharded
    round's entry), against the JAX product summed the same way; the
    batched digit planes."""
    for field in (GOLDILOCKS, BABYBEAR):
        _check_batched(field)


def _check_batched(field):
    rng = np.random.default_rng(61)
    s, m, n, k = 3, 5, 7, 9
    a = rng.integers(0, field.p, size=(s, 2 * m, k), dtype=np.uint64)
    b = rng.integers(0, field.p, size=(s, n, k), dtype=np.uint64)
    d = rng.integers(0, field.p, size=(2 * m, n), dtype=np.uint64)
    a[0, 0, :2] = field.p - 1
    pa, pb, pd = (FArray.from_ints(x, field, device="cpu") for x in (a, b, d))
    jf = _jf(field)

    def jarr(x):
        return jfields.FArray.from_ints(np.asarray(x, dtype=object), jf)

    with jax.disable_jit():  # C_lo, C_hi; C_t = C_lo + t (C_hi - C_lo) by linearity
        c_lo, c_hi = (np.asarray(jmm.modmatmul_batched_impl(jarr(x), jarr(b)).to_ints(), dtype=object)
                      for x in (a[:, :m], a[:, m:]))
    got = modmatmul.modmatmul_batched(FArray.from_ints(np.ascontiguousarray(a[:, :m]), field, device="cpu"), pb)
    assert np.array_equal(got.to_u64(), c_lo.astype(np.uint64))
    row = torch.empty(3, dtype=pa.data.dtype)
    modmatmul.contract_total(pa.data, pb.data, pd.data, field, [0, 2], row)  # the shards as one contraction
    for t in (0, 2):
        ct = (c_lo + t * (c_hi - c_lo)) % field.p
        dt = (d[:m].astype(object) + t * (d[m:].astype(object) - d[:m].astype(object))) % field.p
        want = [int((ct[i] * dt).sum() % field.p) for i in range(s)]
        parts = [modmatmul.contract_partials_tc(pa.data[i], pb.data[i], pd.data, field, t) for i in range(s)]
        assert [int(FArray(p, field).sum(axis=0).to_ints()) for p in parts] == want, t
        assert int(FArray(row[t], field).to_ints()) == sum(want) % field.p, t
    whole = torch.empty(1, dtype=pa.data.dtype)
    modmatmul.contract_total(pa.data[:, :m].contiguous(), pb.data, pd.data[:m].contiguous(), field, [None], whole)
    assert int(FArray(whole[0], field).to_ints()) == int(
        sum((c_lo[i] * d[:m].astype(object)).sum() for i in range(s)) % field.p)
    planes = modmatmul.digit_planes(pa.data, field, 2)
    assert torch.equal(planes, torch.cat([modmatmul.digit_planes_plain(pa.data[i], field, 2) for i in range(s)], 1))


def test_mesh_layout_and_shard_factor():
    """``make_mesh`` without a card raises unless given devices; a mesh of
    repeated devices is one group, alternating ones are a group per
    position, with the same transcript; ``shard_factor`` lays a table out
    as the JAX package's does; a JAX state carried across sharded."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    mesh = _cpu_mesh()
    assert mesh.devices.size == 8 and mesh.devices.shape == (8,) and mesh.axis_names == ("hypercube",)
    assert mesh.layout(16) == ((torch.device("cpu"), 0, 16),)
    mixed = make_mesh(["cpu", "cpu:0"] * 4)
    assert [(row0, rows) for _, row0, rows in mixed.layout(8)] == [(i, 1) for i in range(8)]
    spec, tables, want = _product(GOLDILOCKS)
    assert _per_round(ShardedProductPoly.from_internal_tables(tables, mixed, n_shard=3), GOLDILOCKS) == want
    assert FiatShamirTranscript(fs_kernel.fs_prove_device_sharded(PolySpec(*spec), tables, mixed)).to_bytes() == want
    jtable = _jax(GOLDILOCKS, [tables[0].to_u64()])[0]
    jsharded = jshard_factor(jtable, jmake_mesh(), 3)
    lo = np.asarray(jsharded.limbs[0]).astype(np.uint64) | (np.asarray(jsharded.limbs[1]).astype(np.uint64) << np.uint64(32))
    port = shard_factor(tables[0], mesh, 3)
    assert port.sharded and np.array_equal(torch.cat(port.parts).numpy().view(np.uint64), lo)
    carried = from_jax_state(JPolySpec(*spec), [tuple(np.asarray(l) for l in _jax(GOLDILOCKS, [t.to_u64()])[0].limbs)
                                                for t in tables], GOLDILOCKS, cls=ShardedBlockPoly, device="cpu",
                             mesh=mesh, n_shard=3)
    assert isinstance(carried, ShardedBlockPoly) and _per_round(carried, GOLDILOCKS) == want
