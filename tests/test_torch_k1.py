"""K1 (the round kernel's LibraW shapes) and the Fiat-Shamir and ops surface,
against the JAX package on the CPU.

- ``cuda_round.libra_round_sums`` (CPU tensors: its plain version
  ``libra_round_sums_plain``), the round finished in one launch, against
  the JAX ``round_step`` for both LibraW specs, without a fold, with a fold
  and with the claim shortcut, in Goldilocks and BabyBear, on random
  tables and on tables at p - 1; ``round_step``, which now takes it, too.
- A replay of ``csrc/round_kernel.cu``'s ``libra_round_kernel`` in Python
  ints: the grid the wrapper picks (``cuda_round.libra_blocks``, a wave
  cut short to force ragged ranges), each block's range cut into a scalar
  head, whole 16-byte groups and a scalar tail, the threads' strides,
  the lazy accumulators and their reduction (for mont32 the four-REDC
  model below), the block sums, and the last block's finish with the
  claim's s(1); every pair index visited once, every folded entry written
  once. It must equal the plain version.
- The four-REDC reduction of ``csrc/mont32.cuh`` (``m32::acc_reduce``) as a
  Python model, against (hi 2^64 + lo) R^-1 mod p in F5, F389, F1572869
  and BabyBear, up to the largest accumulator a thread can reach.
- ``fiat_shamir.resume_transcript`` at every cut, with ``verify_prefix``,
  and a tampered checkpoint; ``generate_transcript_device`` on the device
  path and on both fallbacks (a zero coefficient, a non-empty DST), byte
  for byte against the JAX package.
- ``thaler_study_tpu_torch.ops`` exports the JAX package's five names and
  importing it builds nothing.

The JAX side runs eagerly under ``jax.disable_jit()``: no JAX program is
compiled. Inputs come from numpy seeds and reach both packages as the same
canonical integers. Tolerance: exact equality throughout (field values and
bytes). The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu import ops as jops  # noqa: E402
from thaler_study_tpu.fiat_shamir import SumcheckInteractiveProver as JInteractiveProver  # noqa: E402
from thaler_study_tpu.fiat_shamir import generate_transcript as jgenerate  # noqa: E402
from thaler_study_tpu.ops import round_kernel as jrk  # noqa: E402
from thaler_study_tpu.protocols import MatMulG as JMatMulG  # noqa: E402
from thaler_study_tpu.protocols import ProductPoly as JProductPoly  # noqa: E402
from thaler_study_tpu.sumcheck import Prover as JProver  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import (  # noqa: E402
    FiatShamirTranscript,
    SerializationError,
    SumcheckInteractiveProver,
    generate_transcript,
    generate_transcript_device,
    resume_transcript,
)
from thaler_study_tpu_torch.fields import BABYBEAR, F5, F389, F1572869, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.ops import cuda_round  # noqa: E402
from thaler_study_tpu_torch.ops import fs_kernel  # noqa: E402
from thaler_study_tpu_torch.ops import round_kernel as rk  # noqa: E402
from thaler_study_tpu_torch.parallel import make_mesh  # noqa: E402
from thaler_study_tpu_torch.protocols import MatMulG, ProductPoly  # noqa: E402
from thaler_study_tpu_torch.sumcheck import Prover  # noqa: E402

PHASE1, PHASE2 = cuda_round.LIBRA_PHASE1, cuda_round.LIBRA_PHASE2
THREADS = cuda_round.THREADS
FIELDS = [GOLDILOCKS, BABYBEAR]


def _jf(field):
    return getattr(jfields, {"Goldilocks": "GOLDILOCKS", "F389": "F389", "BabyBear": "BABYBEAR"}[field.name])


def _both(field, vals):
    vals = [int(v) for v in vals]
    return FArray.from_ints(vals, field, device="cpu"), jfields.FArray.from_ints(vals, _jf(field))


def _scalar_both(field, v: int):
    return FArray.scalar(field.felt(v), device="cpu"), jfields.FArray.scalar(_jf(field).felt(v))


def _same(fa, ja) -> bool:
    return np.array_equal(fa.to_u64(), np.asarray(ja.to_u64(), dtype=np.uint64))


def _specs(n):
    return {
        PHASE1: (rk.PolySpec((n,), ((0,),) * 3, PHASE1), jrk.PolySpec((n,), ((0,),) * 3, PHASE1)),
        PHASE2: (rk.PolySpec((n,), ((0,),) * 3 + ((),), PHASE2), jrk.PolySpec((n,), ((0,),) * 3 + ((),), PHASE2)),
    }


# ---- the new wrapper against the JAX round_step ------------------------------


@pytest.mark.parametrize("field", FIELDS, ids=["goldilocks", "babybear"])
def test_libra_round_sums_match_jax(field):
    """s(0..2) and the folded tables of libra_round_sums (and its plain
    version, and round_step) equal the JAX round_step's, both specs, no
    fold / fold / fold with the claim, random tables (and tables, r and w_u
    at p - 1 in phase 2). The claim's round is the fold's with s(1) =
    claim - s(0), as the JAX round_step computes it (taken here from the JAX
    fold round's sums instead of a second JAX round: eager Goldilocks
    products cost ~40 ms each)."""
    rng = np.random.default_rng(11 if field is GOLDILOCKS else 12)
    n, p = 3, field.p
    for terms, (spec, jspec) in _specs(n).items():
        for fill in ("random",) + (("p - 1",) if terms == PHASE2 else ()):
            vals = [rng.integers(0, p, 1 << n, dtype=np.uint64) if fill == "random" else [p - 1] * (1 << n)
                    for _ in range(3)]
            pairs = [_both(field, v) for v in vals] + ([_both(field, [p - 1])] if terms == PHASE2 else [])
            tables, jtables = [a for a, _ in pairs], [b for _, b in pairs]
            r, jr = _scalar_both(field, p - 1 if fill == "p - 1" else int(rng.integers(0, p, dtype=np.uint64)))
            claim = FArray.scalar(field.felt(p - 1), device="cpu")
            for mode in ("no_fold", "fold", "fold_claim"):
                fold, with_claim = mode != "no_fold", mode == "fold_claim"
                if with_claim:
                    want = [want[0], (p - 1 - want[0]) % p, want[2]]  # the claim is p - 1
                else:
                    with jax.disable_jit():
                        jsums, jnew = jrk.round_step(jspec, jtables, jr if fold else None)
                    want = [int(x) for x in jsums.to_u64()]
                where = (field.name, terms, fill, mode)
                args = ([t.data.reshape(1, -1) for t in tables[:3]], r.data.reshape(1) if fold else None, with_claim)
                kw = dict(field=field, terms=terms, scalars=[t.data for t in tables[3:]],
                          claim=claim.data.reshape(1) if with_claim else None)
                folded, s = cuda_round.libra_round_sums(*args, None, **kw)
                pfolded, ps = cuda_round.libra_round_sums_plain(*args, **kw)
                assert s.shape == (1, 3) and torch.equal(s, ps), where
                assert FArray(s[0], field).to_u64().tolist() == want, where
                sums, new = rk.round_step(spec, tables, r if fold else None, claim=claim if with_claim else None)
                assert sums.to_u64().tolist() == want, where
                for k in range(3):
                    assert _same(new[k], jnew[k]), where
                    if fold:
                        assert torch.equal(folded[k][0], new[k].data) and torch.equal(pfolded[k][0], new[k].data)
                assert (folded is None) == (not fold)


# ---- a replay of the kernel in Python ints -----------------------------------


def _redc(t: int, p: int, pinv: int) -> int:
    """csrc/mont32.cuh m32::Field::redc: t 2^-32 mod p for t < p 2^32."""
    assert 0 <= t < p << 32
    m = (t * pinv) & 0xFFFFFFFF
    u = (t + m * p) >> 32
    return u - p if u >= p else u


def _acc_reduce_m32(p: int, lo: int, hi: int) -> int:
    """csrc/mont32.cuh m32::acc_reduce: S R^-1 mod p for S = hi 2^64 + lo,
    as redc(s0) + redc(s1 R) + redc(s2 R^2) + redc(s3 R^3) with the powers
    of R made on the host (m32::Field's constructor)."""
    pinv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    r1 = (1 << 32) % p
    r2, r3 = r1 * r1 % p, r1 * r1 * r1 % p
    m32 = 0xFFFFFFFF
    x = _redc(lo & m32, p, pinv)
    x = (x + _redc((lo >> 32) * r1, p, pinv)) % p
    x = (x + _redc((hi & m32) * r2, p, pinv)) % p
    return (x + _redc((hi >> 32) * r3, p, pinv)) % p


class _Ops:
    """The kernel's field on words (GlOps / M32Ops): Goldilocks words are
    canonical, mont32 words Montgomery (x R mod p); the accumulator sums
    raw word products, one reduction per thread and t."""

    def __init__(self, field):
        self.p = p = field.p
        self.mont = field.backend == "mont32"
        self.rinv = pow(1 << 32, -1, p) if self.mont else 1
        self.one = (1 << 32) % p if self.mont else 1

    def mul(self, a, b):
        return a * b * self.rinv % self.p

    def fold(self, lo, hi, r):
        return (lo + self.mul((hi - lo) % self.p, r)) % self.p

    def reduce(self, acc: int) -> int:
        if self.mont:
            assert acc < 1 << 128
            return _acc_reduce_m32(self.p, acc & ((1 << 64) - 1), acc >> 64)
        assert acc < 1 << 192
        return acc % self.p

    def point(self, phase, v, s):
        """The raw products of one point's terms (add_libra)."""
        if phase == 1:
            return v[0] * v[1] + v[2] * self.one
        return v[0] * ((s + v[2]) % self.p) + self.mul(v[1], s) * v[2]


def _grid(half: int, wave: int, vec: int):
    """Per block (begin, vb, ve, end) as libra_round_kernel cuts its range
    of pair indices, for the wrapper's grid (libra_blocks) at ``wave``."""
    blocks = cuda_round.libra_blocks(half, vec, wave)
    chunk = -(-half // blocks)
    out = []
    for x in range(blocks):
        begin, end = x * chunk, min(x * chunk + chunk, half)
        vb = ve = end
        if vec > 1:
            vb = min(-(-begin // vec) * vec, end)
            ve = max(end // vec * vec, vb)
        out.append((begin, vb, ve, end))
    return out


def _replay(field, tables, r, skip, phase, scalar, claim, wave, vec):
    """libra_round_kernel in Python ints over word lists: (folded tables or
    None, per-block partials, s(0..2) per proof as the last block writes
    them); asserts each pair index is visited once and each folded entry
    written once."""
    f = _Ops(field)
    p = f.p
    n = len(tables[0][0])
    fold = r is not None
    half = n // 4 if fold else n // 2
    grid = _grid(half, wave, vec)
    batch = len(tables[0])
    out = [[[None] * (n // 2) for _ in range(batch)] for _ in range(3)] if fold else None
    partials = []
    for b in range(batch):
        src = [t[b] for t in tables]
        seen = [0] * half
        row = []
        for begin, vb, ve, end in grid:
            acc = [[0, 0, 0] for _ in range(THREADS)]

            def one_point(i, tid):
                seen[i] += 1
                lo, hi = [], []
                for g in range(3):
                    if fold:
                        lo.append(f.fold(src[g][i], src[g][i + 2 * half], r[b]))
                        hi.append(f.fold(src[g][i + half], src[g][i + 3 * half], r[b]))
                        for pos, v in ((i, lo[g]), (i + half, hi[g])):
                            assert out[g][b][pos] is None, "a folded entry written twice"
                            out[g][b][pos] = v
                    else:
                        lo.append(src[g][i])
                        hi.append(src[g][i + half])
                v2 = [(h + (h - l)) % p for l, h in zip(lo, hi)]
                acc[tid][0] += f.point(phase, lo, scalar[b])
                if not skip:
                    acc[tid][1] += f.point(phase, hi, scalar[b])
                acc[tid][2] += f.point(phase, v2, scalar[b])

            for tid in range(THREADS):
                for i in range(begin + tid, vb, THREADS):  # the head
                    one_point(i, tid)
                for i in range(ve + tid, end, THREADS):  # the tail
                    one_point(i, tid)
                for q in range(vb // vec + tid, ve // vec, THREADS):  # whole 16-byte groups
                    for j in range(vec):
                        one_point(q * vec + j, tid)
            row.append([sum(f.reduce(a[t]) for a in acc) % p for t in range(3)])
        assert seen == [1] * half, "a pair index visited other than once"
        partials.append(row)
    # the last block's finish: every block's partials per proof, the claim's s(1)
    sums = []
    for b in range(batch):
        s = [sum(part[t] for part in partials[b]) % p for t in range(3)]
        if claim is not None:
            s[1] = (claim[b] - s[0]) % p
        sums.append(s)
    if fold:
        assert all(v is not None for t in out for row_ in t for v in row_), "a folded entry not written"
    return out, partials, sums


@pytest.mark.parametrize("field", FIELDS, ids=["goldilocks", "babybear"])
def test_kernel_replay_equals_plain(field):
    """The replay equals libra_round_sums_plain (s and folded tables) and
    round_partials_plain over the replay's own split (the partials), for
    both phases, fold on and off, skip-1 with and without the claim, on:
    a wave cut to 3 and 6 blocks (ragged ranges: a scalar head and tail
    around the groups), a grid of one block whose threads stride over
    several groups, the wrapper's own grid, vec off (unaligned tables), a
    half below one group; random words and words at p - 1, batch 2."""
    rng = np.random.default_rng(21 if field is GOLDILOCKS else 22)
    p, wb = field.p, 8 if field is GOLDILOCKS else 4
    v = 16 // wb
    mont = field.backend == "mont32"
    # (half, wave, words per access): 3 and 6 blocks over ranges that do not
    # start or end on a group; one block, each thread on two groups; the
    # wrapper's own grid; 16-byte accesses off over 3 blocks; halves below
    # a group
    cases = [(THREADS * v * 4, 3, v), (THREADS * v * 8, 6, v), (THREADS * v * 2, 1, v),
             (THREADS * v * 2, 1 << 20, v), (THREADS * 4, 3, 1), (1, 1, v), (2, 1, v)]
    modes = [(True, True, True), (True, False, False), (False, True, False), (False, False, False)]
    for phase, terms in ((1, PHASE1), (2, PHASE2)):
        for i, (half, wave, vec) in enumerate(cases):
            fold, skip, with_claim = modes[(i + phase) % len(modes)]
            n = half * (4 if fold else 2)
            vals = [rng.integers(0, p, (2, n), dtype=np.uint64) for _ in range(3)]
            vals[0][1, : n // 2] = p - 1
            words = [[[(int(x) << 32) % p if mont else int(x) for x in row] for row in t] for t in vals]
            r = [int(x) for x in rng.integers(0, p, 2, dtype=np.uint64)] if fold else None
            scalar = [int(x) for x in rng.integers(0, p, 2, dtype=np.uint64)]
            claim = [int(x) for x in rng.integers(0, p, 2, dtype=np.uint64)] if with_claim else None
            if vec > 1 and half % vec:
                vec = 1  # what vec_words picks below one group
            grid = _grid(half, wave, vec)
            if i < 2:  # the cut wave: every block taken, and scalar heads or tails
                assert len(grid) == wave and any(b0 < vb or ve < e for b0, vb, ve, e in grid)
            out, partials, sums = _replay(field, words, r, skip, phase, scalar, claim, wave, vec)

            def tensor(x):
                return torch.tensor(np.array(x, dtype=np.uint64).view(np.int64) if wb == 8 else np.array(x),
                                    dtype=torch.int64 if wb == 8 else torch.int32)

            tabs = [tensor(t) for t in words]
            kw = dict(field=field, terms=terms, scalars=[tensor(scalar)] if phase == 2 else [])
            rr = tensor(r) if fold else None
            folded, s = cuda_round.libra_round_sums_plain(tabs, rr, skip, claim=tensor(claim) if claim else None, **kw)
            _, parts = cuda_round.round_partials_plain(tabs, rr, skip, len(partials[0]), **kw)
            where = (field.name, phase, n, wave, vec, fold, skip, with_claim)
            assert torch.equal(s, tensor(sums)), where
            assert torch.equal(parts, tensor(partials)), where
            if fold:
                assert all(torch.equal(a, tensor(b)) for a, b in zip(folded, out)), where


def test_four_redc_reduction_in_every_mont32_field():
    """m32::acc_reduce's model equals (hi 2^64 + lo) R^-1 mod p in the four
    mont32 fields: at 0, at the largest accumulator a thread can reach (2^31
    pair indices, two products of (p - 1)^2 per point and t), at 2^128 - 1,
    at each 32-bit piece alone at its largest, and at random values."""
    rng = np.random.default_rng(31)
    for field in (F5, F389, F1572869, BABYBEAR):
        p = field.p
        rinv = pow(1 << 32, -1, p)
        top = (1 << 32) - 1
        values = [0, 1, (1 << 31) * 2 * (p - 1) ** 2, (1 << 128) - 1]
        values += [top << s for s in (0, 32, 64, 96)]
        values += [int.from_bytes(rng.bytes(16), "little") for _ in range(64)]
        for acc in values:
            assert _acc_reduce_m32(p, acc & ((1 << 64) - 1), acc >> 64) == acc * rinv % p, (field.name, acc)


# ---- C5: resume_transcript and generate_transcript_device ----------------------


def test_resume_transcript_byte_identical():
    """Every cut of a checkpoint resumes to the uninterrupted transcript,
    which equals the JAX package's; verify_prefix re-derives the prefix; a
    checkpoint whose round 0 or round 1 was tampered with is refused."""
    rng = np.random.default_rng(41)
    field, n = F389, 3
    size = 1 << n
    a = [int(x) for x in rng.integers(0, field.p, size * size)]
    b = [int(x) for x in rng.integers(0, field.p, size * size)]
    point = [int(x) for x in rng.integers(0, field.p, 2 * n)]

    def fresh():
        g = MatMulG.new(n, a, b, [field.felt(x) for x in point], field, device="cpu")
        return SumcheckInteractiveProver(Prover(g))

    with jax.disable_jit():
        jf = _jf(field)
        jfull = jgenerate(JInteractiveProver(JProver(JMatMulG.new(n, a, b, [jf.felt(x) for x in point], jf))), jf)
    full = generate_transcript(fresh(), field)
    assert full.to_bytes() == jfull.to_bytes()
    for cut in range(len(full.g) + 1):
        resumed = resume_transcript(fresh(), field, FiatShamirTranscript(full.g[:cut]))
        assert resumed.to_bytes() == full.to_bytes(), f"cut={cut}"
        checked = resume_transcript(fresh(), field, FiatShamirTranscript(full.g[:cut]), verify_prefix=True)
        assert checked.to_bytes() == full.to_bytes(), f"cut={cut} verify_prefix"
    for j in (0, 1):
        bad = list(full.g[:2])
        bad[j] = bytes([bad[j][0] ^ 1]) + bad[j][1:]
        with pytest.raises(SerializationError):
            resume_transcript(fresh(), field, FiatShamirTranscript(bad), verify_prefix=True)


def test_generate_transcript_device_matches_jax():
    """The device path (CPU tensors: the plain versions), the zero
    coefficient's fallback and the non-empty DST's fallback give the JAX
    host loop's bytes, and so does each over two CPU shards (mesh=)."""
    rng = np.random.default_rng(51)
    field, n = GOLDILOCKS, 3
    spec = rk.single_block_spec(2, n)
    jspec = jrk.PolySpec(spec.block_sizes, spec.table_blocks, spec.terms)
    for case, dst in (("device", b""), ("zero coefficient", b""), ("dst", b"thaler-tpu")):
        vals = [rng.integers(0, field.p, 1 << n, dtype=np.uint64) for _ in range(2)]
        if case == "zero coefficient":
            vals[1][:] = 0
        pairs = [_both(field, v) for v in vals]
        poly = ProductPoly(spec, [x for x, _ in pairs])
        declined = fs_kernel.fs_prove_device(spec, poly.tables, dst) is None
        assert declined == (case != "device"), case
        t = generate_transcript_device(poly, field, dst)
        with jax.disable_jit():
            jt = jgenerate(JInteractiveProver(JProver(JProductPoly(jspec, [y for _, y in pairs]))), _jf(field), dst)
        assert t.to_bytes() == jt.to_bytes(), case
        sharded = generate_transcript_device(poly, field, dst, mesh=make_mesh(["cpu"] * 2))
        assert sharded.to_bytes() == jt.to_bytes(), case


# ---- C6: the ops package's surface --------------------------------------------


def test_ops_exports_build_nothing():
    """The five names of the JAX package's ops/__init__.py, importable from
    the port's ops package in a fresh process that then has built and
    loaded no library."""
    names = ["PolySpec", "fold_step", "product_evals", "round_step", "sum_products"]
    assert sorted(jops.__all__) == names
    code = (
        "import sys\n"
        f"from thaler_study_tpu_torch.ops import {', '.join(names)}\n"
        "from thaler_study_tpu_torch import _build, ops\n"
        f"assert sorted(ops.__all__) == {names!r}\n"
        "assert not _build._loaded and not _build.build_seconds, (_build._loaded, _build.build_seconds)\n"
        "assert 'jax' not in sys.modules\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
