"""The port's mont32 fields against the JAX package: F5, F389, F1572869 and
BabyBear.

- ``backend32`` and the ``FArray`` codecs and ops, word for word (both
  packages store the Montgomery word x * 2^32 mod p), with the boundary
  words 0, 1, p - 1, p - 2 and their Montgomery images;
- ``round_step`` (no fold, fold, fold with the claim shortcut) against the
  JAX ``round_step`` for BabyBear and F1572869 at n = 12, k = 2, 3: sums
  and folded tables. The JAX ``round_step`` is the XLA twin of the Pallas
  kernel, which the JAX tests tie to it for F1572869
  (``tests/test_pallas_round.py``); the Pallas kernel in interpret mode is
  too slow for this suite;
- the plain challenge draw for every field against the host hasher;
- ``generate_transcripts_batch`` over BabyBear (B = 4, n = 2..10) and F5
  (every instance takes the zero-coefficient fallback) byte for byte
  against the JAX host ``generate_transcript``.

The port runs its plain versions (CPU tensors); the JAX side runs eagerly
under ``jax.disable_jit()`` and never compiles a fused program. Inputs come
from numpy seeds; tolerance: exact equality throughout.

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

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu.fiat_shamir import SumcheckInteractiveProver as JInteractiveProver  # noqa: E402
from thaler_study_tpu.fiat_shamir import generate_transcript as jgenerate  # noqa: E402
from thaler_study_tpu.fields import FArray as JFArray  # noqa: E402
from thaler_study_tpu.fields import backend32 as jb32  # noqa: E402
from thaler_study_tpu.ops import round_kernel as jrk  # noqa: E402
from thaler_study_tpu.protocols import ProductPoly as JProductPoly  # noqa: E402
from thaler_study_tpu.sumcheck import Prover as JProver  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import (  # noqa: E402
    FiatShamirTranscript,
    SerializationError,
    SumcheckInteractiveVerifier,
    XmdChain,
    verify_transcript,
)
from thaler_study_tpu_torch.fields import BABYBEAR, F5, F389, F1572869, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.fields import backend32 as b32  # noqa: E402
from thaler_study_tpu_torch.ops import cuda_round, fs_kernel  # noqa: E402
from thaler_study_tpu_torch.ops import round_kernel as rk  # noqa: E402
from thaler_study_tpu_torch.ops.sha_chain import ZPAD_STATE, absorb_py, draw_py  # noqa: E402
from thaler_study_tpu_torch.protocols import (  # noqa: E402
    BatchedProductPoly,
    ProductPoly,
    generate_transcripts_batch,
)
from thaler_study_tpu_torch.sumcheck import SumCheckError, Verifier  # noqa: E402

FIELDS = (F5, F389, F1572869, BABYBEAR)


def _jfield(field):
    return getattr(jfields, {"F5": "F5", "F389": "F389", "F1572869": "F1572869", "BabyBear": "BABYBEAR"}[field.name])


def _words(field, seed: int, size: int = 4096) -> np.ndarray:
    """Random Montgomery words (uint32) with the boundary words inside:
    0, 1, p - 1, p - 2 and the Montgomery images of 0, 1, p - 1, p - 2."""
    p, r = field.p, field.mont_r
    rng = np.random.default_rng(seed)
    w = rng.integers(0, p, size=size, dtype=np.uint64)
    edge = [v % p for v in (0, 1, p - 1, p - 2)]
    edge += [v * r % p for v in edge]
    edge = np.array(edge + edge[::-1], dtype=np.uint64)[:size]
    w[: len(edge)] = edge
    return w.astype(np.uint32)


def _port(words, field):
    return FArray.from_jax_limbs(words, field=field, device="cpu")


def _jax(words, field):
    return JFArray((jnp.asarray(words),), _jfield(field))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_backend32_matches_jax():
    for field in FIELDS:
        p, pinv = field.p, field.mont_pinv_neg
        a, b, r = _words(field, 1), _words(field, 2)[::-1].copy(), _words(field, 3)
        np.random.default_rng(4).shuffle(r)
        ta, tb, tr = (torch.from_numpy(x.astype(np.int32)) for x in (a, b, r))
        ja, jb, jr = (jnp.asarray(x) for x in (a, b, r))
        canon = a % np.uint32(p)  # any values < p serve as canonical inputs
        cases = [
            ("mont_mul", b32.mont_mul(p, ta, tb), jb32.mont_mul(p, pinv, ja, jb)),
            ("add", b32.add(p, ta, tb), jb32.add(p, ja, jb)),
            ("sub", b32.sub(p, ta, tb), jb32.sub(p, ja, jb)),
            ("neg", b32.neg(p, ta), jb32.neg(p, ja)),
            ("from_mont", b32.from_mont(p, ta), jb32.from_mont(p, pinv, ja)),
            ("to_mont", b32.to_mont(p, torch.from_numpy(canon.astype(np.int32))),
             jb32.to_mont(p, pinv, field.mont_r2, jnp.asarray(canon))),
            ("fold", b32.fold(p, ta, tb, tr), jb32.add(p, ja, jb32.mont_mul(p, pinv, jb32.sub(p, jb, ja), jr))),
        ]
        for name, got, want in cases:
            assert got.dtype == torch.int32, name
            np.testing.assert_array_equal(_u32(got), np.asarray(want), err_msg=f"{field.name} {name}")
        for size in (1, 3, 64, 65, 4096):
            got = int(b32.sum_mod(p, ta[:size], 0))
            assert got == int(jb32.sum_mod(p, ja[:size], 0)), (field.name, size)
            got = int(b32.dot_mod(p, ta[:size], tb[:size]))
            assert got == int(jb32.dot_mod(p, pinv, ja[:size], jb[:size])), (field.name, size)
        rows = ta.reshape(8, 512)
        np.testing.assert_array_equal(_u32(b32.sum_mod(p, rows, 1)), np.asarray(jb32.sum_mod(p, jnp.asarray(a).reshape(8, 512), 1)))


def test_farray_codecs_and_ops_match_jax():
    for field in FIELDS:
        p = field.p
        jf = _jfield(field)
        vals = [0, 1, 2, p - 1, p - 2, p, p + 3, 7 * p + 1, (1 << 32) - 1, (1 << 64) - 1]
        port = FArray.from_ints(vals, field, device="cpu")
        ref = JFArray.from_ints(vals, jf)
        assert port.data.dtype == torch.int32
        np.testing.assert_array_equal(_u32(port.data), np.asarray(ref.limbs[0]), err_msg=field.name)
        assert [int(x) for x in port.to_ints()] == [v % p for v in vals]
        assert list(port.to_u64()) == [v % p for v in vals]
        assert [f.v for f in port.to_felts()] == [f.v for f in ref.to_felts()]
        arr = np.array(vals[:-1], dtype=np.uint64)
        np.testing.assert_array_equal(
            _u32(FArray.from_ints(arr, field, device="cpu").data), np.asarray(JFArray.from_ints(arr, jf).limbs[0])
        )
        felts = [field.felt(v) for v in vals]
        assert torch.equal(FArray.from_felts(felts, device="cpu").data, port.data)
        assert FArray.scalar(field.felt(p - 1), device="cpu").item().v == p - 1
        assert FArray.scalar(field.felt(3), device="cpu").shape == ()
        assert not FArray.zeros((2, 3), field, device="cpu").data.any()
        # the JAX package's limb carried across unchanged, both ways
        words = _words(field, 5)
        assert np.array_equal(_u32(_port(words, field).data), words)
        with pytest.raises(ValueError):
            FArray.from_jax_limbs(np.array([p], np.uint32), field=field, device="cpu")
        with pytest.raises(TypeError):
            FArray.from_jax_limbs(words, words, field=field, device="cpu")
        a, b = _port(words, field), _port(words[::-1].copy(), field)
        ja, jb = _jax(words, field), _jax(words[::-1].copy(), field)
        r = field.felt(123456789)
        for name, got, want in (
            ("add", a + b, ja + jb),
            ("sub", a - b, ja - jb),
            ("mul", a * b, ja * jb),
            ("neg", -a, -ja),
            ("felt", a * r, ja * jfields.Felt(r.v, jf)),
            ("fold", FArray.fold(a, b, r), JFArray.fold(ja, jb, jfields.Felt(r.v, jf))),
        ):
            np.testing.assert_array_equal(_u32(got.data), np.asarray(want.limbs[0]), err_msg=f"{field.name} {name}")
        assert a.sum().item().v == ja.sum().item().v
        assert a.to_felts() == [field.felt(f.v) for f in ja.to_felts()]


def test_round_step_matches_jax():
    for field in (BABYBEAR, F1572869):
        for k in (2, 3):
            for mode in ("no_fold", "fold", "fold_claim"):
                _check_round_step(field, k, 12, mode)


def _check_round_step(field, k, n, mode):
    seed = 1000 * k + 10 * n + len(mode) + field.p % 97
    spec = rk.single_block_spec(k, n)
    jspec = jrk.PolySpec(spec.block_sizes, spec.table_blocks, spec.terms)
    words = [_words(field, seed + i, 1 << n) for i in range(k)]
    tables, jtables = [_port(w, field) for w in words], [_jax(w, field) for w in words]
    r = claim = jr = jclaim = None
    if mode != "no_fold":
        w = _words(field, seed + 10, 8)[5:6]
        r, jr = _port(w, field).reshape(()), _jax(w, field).reshape(())
    if mode == "fold_claim":
        w = _words(field, seed + 11, 8)[6:7]
        claim, jclaim = _port(w, field).reshape(()), _jax(w, field).reshape(())
    sums, folded = rk.round_step(spec, tables, r, claim=claim)
    with jax.disable_jit():
        jsums, jfolded = jrk.round_step(jspec, jtables, jr, claim=jclaim)
    where = f"{field.name} k={k} n={n} {mode}"
    np.testing.assert_array_equal(_u32(sums.data), np.asarray(jsums.limbs[0]), err_msg=where)
    assert len(folded) == len(jfolded) == k
    for t, jt in zip(folded, jfolded):
        np.testing.assert_array_equal(_u32(t.data), np.asarray(jt.limbs[0]), err_msg=where)


def test_plain_round_partials_and_draw():
    """The per-block split (the CUDA grid's) never changes mont32 round
    sums; the plain draw equals the host hasher for every field and fill."""
    for field in FIELDS:
        for blocks in (1, 3, 8):
            words = [_words(field, blocks + i, 3 * 64).reshape(3, 64).astype(np.int32) for i in range(3)]
            tables = [torch.from_numpy(w) for w in words]
            r = torch.from_numpy(_words(field, 9, 3).astype(np.int32))
            for rr in (None, r):
                ref_folded, ref = cuda_round.round_partials_plain(tables, rr, False, 1, field)
                folded, parts = cuda_round.round_partials_plain(tables, rr, False, blocks, field)
                assert parts.shape == (3, blocks, 4) and parts.dtype == torch.int32
                assert torch.equal(b32.sum_mod(field.p, parts, 1), ref[:, 0])
                if rr is not None:
                    assert all(torch.equal(a, b) for a, b in zip(folded, ref_folded))
        with pytest.raises(ValueError):  # an int64 table is not a mont32 word tensor
            cuda_round.round_partials([tables[0].to(torch.int64)] * 2, field=field)
    for field in FIELDS + (GOLDILOCKS,):
        chain = XmdChain(field)
        state, buf, nbytes = list(ZPAD_STATE), bytearray(64), 0
        rng = np.random.default_rng(field.p % 1000)
        for size in (72, 1, 50, 63, 64, 129, 7, 44):
            msg = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            chain.absorb(msg)
            absorb_py(state, buf, nbytes, msg)
            nbytes += size
            assert draw_py(field, state, buf, nbytes) == chain.draw(1)[0].v, (field.name, size)


def _jax_transcripts(field, words, n, k):
    """The JAX package's host-loop transcript of each instance, jit disabled."""
    spec = rk.single_block_spec(k, n)
    jspec = jrk.PolySpec(spec.block_sizes, spec.table_blocks, spec.terms)
    jf = _jfield(field)
    with jax.disable_jit():
        return [
            jgenerate(JInteractiveProver(JProver(JProductPoly(jspec, [_jax(w[b], field) for w in words]))), jf)
            for b in range(words[0].shape[0])
        ]


def _batch(field, seed, batch, n, k):
    words = [_words(field, seed + i, batch << n).reshape(batch, 1 << n) for i in range(k)]
    np.random.default_rng(seed).shuffle(words[0], axis=1)  # spread the boundary words over the batch
    return words


def test_babybear_batch_matches_jax():
    field, batch = BABYBEAR, 4
    for n in range(2, 11):
        k = 3 if n in (3, 7) else 2
        words = _batch(field, 100 + n, batch, n, k)
        tables = [_port(w, field) for w in words]
        port = generate_transcripts_batch(BatchedProductPoly(tables), field)
        ref = _jax_transcripts(field, words, n, k)
        fused = fs_kernel.fs_prove_device_batch(rk.single_block_spec(k, n), tables)
        for b in range(batch):
            assert port[b].to_bytes() == ref[b].to_bytes(), f"n={n} instance {b}"
            assert fused[b] is not None and len(fused[b][0]) == 4 + 8 + 12 * (k + 1)
    # the last batch: verified, and one flipped byte rejected
    spec = rk.single_block_spec(k, n)
    inst = [FArray(t.data[0], field) for t in tables]
    v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, inst)), field)
    assert verify_transcript(port[0], v, field)
    bad = [bytearray(m) for m in port[0].g]
    bad[1][16] ^= 1  # lowest byte of round 1's first coefficient
    v = SumcheckInteractiveVerifier(Verifier(n, ProductPoly(spec, inst)), field)
    with pytest.raises((SumCheckError, SerializationError, AssertionError)):
        assert verify_transcript(FiatShamirTranscript([bytes(m) for m in bad]), v, field)


def test_f5_batch_falls_back_like_jax():
    field, batch = F5, 4
    for n, k in ((3, 2), (5, 3)):
        words = _batch(field, 200 + n, batch, n, k)
        tables = [_port(w, field) for w in words]
        fused = fs_kernel.fs_prove_device_batch(rk.single_block_spec(k, n), tables)
        port = generate_transcripts_batch(BatchedProductPoly(tables), field)
        ref = _jax_transcripts(field, words, n, k)
        assert any(m is None for m in fused)  # zero coefficients are common in F5
        for b in range(batch):
            assert port[b].to_bytes() == ref[b].to_bytes(), f"n={n} instance {b}"
            if fused[b] is not None:
                assert fused[b] == port[b].g
