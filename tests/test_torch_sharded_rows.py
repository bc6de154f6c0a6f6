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
  scaled in the launch, against Python integers.

Seeded words include p - 1 and, for Goldilocks, 2^64 - 2^32 (p - 1 is
2^64 - 2^32): the lazy accumulators' and the lanes' worst cases. The JAX
side runs eagerly (``jax.disable_jit()``) at a few small shapes. Tolerance:
exact. ``chip_smoke.py`` holds the kernels against these plain versions on
the card.
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
from thaler_study_tpu.ops import round_kernel as jrk  # noqa: E402
from thaler_study_tpu.protocols import ProductPoly as JProductPoly  # noqa: E402
from thaler_study_tpu.sumcheck import Prover as JProver  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import (  # noqa: E402
    SumcheckInteractiveProver,
    generate_transcript,
    generate_transcript_device,
)
from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.ops import cuda_round, modmatmul, multiblock, row_sums  # noqa: E402
from thaler_study_tpu_torch.ops import round_kernel as rk  # noqa: E402
from thaler_study_tpu_torch.parallel import ShardedBlockPoly, make_mesh, sharded  # noqa: E402
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
