"""The port's batched prover beyond the fused 2/3-factor product, and its
fused FS prover over every spec, against the JAX package on the CPU.

- ``generate_transcripts_batch`` with a non-empty DST (the per-round path:
  ``BatchedProductPoly.c_1`` / ``round_batch``), with ``degree=`` below and
  above the number of factors, and at k = 1 and k = 4 (the fused path),
  byte for byte against the JAX package's per-instance host loop or its own
  per-round path;
- ``generate_transcript_device`` (``fs_prove_device_batch``'s loop over
  ``round_step`` and the FS tail) over the triangle spec at 8 and 16 nodes,
  the mixed-degree 2-block spec of the JAX package's
  ``tests/test_fs_kernel.py`` and a k = 1 product, against the JAX host
  loop; ``supports_fused_fs`` against the JAX package's decision;
- the FS tail's plain version at round degrees 1 and 5, every kind of
  buffer fill, against the JAX package's serialization and hasher.

Inputs come from numpy seeds and reach both packages as the same integers.
The JAX side runs eagerly under ``jax.disable_jit()`` (its host loop, never
a compiled whole-proof program). Tolerance: exact (transcript bytes, field
values). The CUDA kernels themselves are held against these plain versions
on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import api as japi  # noqa: E402
from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu.fiat_shamir import DefaultFieldHasher as JHasher  # noqa: E402
from thaler_study_tpu.fiat_shamir import SumcheckInteractiveProver as JInteractiveProver  # noqa: E402
from thaler_study_tpu.fiat_shamir import generate_transcript as jgenerate  # noqa: E402
from thaler_study_tpu.fiat_shamir.serialize import serialize_c1_and_poly as jser_c1  # noqa: E402
from thaler_study_tpu.fiat_shamir.serialize import serialize_unipoly as jser  # noqa: E402
from thaler_study_tpu.ops import fs_kernel as jfs  # noqa: E402
from thaler_study_tpu.ops.round_kernel import PolySpec as JPolySpec  # noqa: E402
from thaler_study_tpu.protocols import BatchedProductPoly as JBatched  # noqa: E402
from thaler_study_tpu.protocols import ProductPoly as JProductPoly  # noqa: E402
from thaler_study_tpu.protocols import generate_transcripts_batch as jgenerate_batch  # noqa: E402
from thaler_study_tpu.sumcheck import Prover as JProver  # noqa: E402
from thaler_study_tpu.sumcheck.univariate import interpolate_at_small_points as jinterp  # noqa: E402
from thaler_study_tpu_torch import api  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import (  # noqa: E402
    SerializationError,
    SumcheckInteractiveProver,
    SumcheckInteractiveVerifier,
    generate_transcript,
    generate_transcript_device,
    verify_transcript,
)
from thaler_study_tpu_torch.fields import BABYBEAR, F5, F389, F1572869, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.fields.farray import tensor_u64, u64_tensor  # noqa: E402
from thaler_study_tpu_torch.ops import fs_kernel  # noqa: E402
from thaler_study_tpu_torch.ops.round_kernel import PolySpec, single_block_spec  # noqa: E402
from thaler_study_tpu_torch.ops.sha_chain import ZPAD_STATE, DevChain, absorb_py  # noqa: E402
from thaler_study_tpu_torch.protocols import (  # noqa: E402
    BatchedProductPoly,
    ProductPoly,
    TriangleG,
    generate_transcripts_batch,
)
from thaler_study_tpu_torch.sumcheck import Prover, SumCheckError, Verifier  # noqa: E402

DST = b"batch-proofs-v16"  # 16 bytes
_JF = {"Goldilocks": "GOLDILOCKS", "F5": "F5", "F389": "F389", "F1572869": "F1572869", "BabyBear": "BABYBEAR"}


def _jf(field):
    return getattr(jfields, _JF[field.name])


def _jspec(spec):
    return JPolySpec(spec.block_sizes, spec.table_blocks, spec.terms)


def _values(rng, field, shape):
    v = rng.integers(1, field.p, size=shape, dtype=np.uint64)
    v.reshape(-1)[:2] = [1, field.p - 1]
    return v


def _batch(field, k, n, batch, seed):
    """The same [B, 2^n] factor values as a port BatchedProductPoly (CPU),
    per-instance port tables and per-instance JAX tables."""
    vals = [_values(np.random.default_rng(seed + i), field, (batch, 1 << n)) for i in range(k)]
    port = [FArray.from_ints(v, field, device="cpu") for v in vals]
    jinst = [[jfields.FArray.from_ints(v[b], _jf(field)) for v in vals] for b in range(batch)]
    return port, jinst


def _jax_host(spec, jtables, field, dst=b""):
    with jax.disable_jit():
        return jgenerate(JInteractiveProver(JProver(JProductPoly(_jspec(spec), jtables))), _jf(field), dst)


def _accepts(t, spec, tables, field, dst=b""):
    v = SumcheckInteractiveVerifier(Verifier(spec.num_vars(), ProductPoly(spec, tables)), field)
    try:
        return verify_transcript(t, v, field, dst)
    except (SumCheckError, SerializationError):
        return False


def test_dst_batch_matches_jax():
    """A non-empty DST: the per-round path, byte-identical to the JAX
    package's per-instance host loop with that DST; accepted with the DST,
    rejected without it."""
    n, k, batch = 4, 2, 3
    for field, seed in ((GOLDILOCKS, 1), (F389, 2), (BABYBEAR, 3)):
        spec = single_block_spec(k, n)
        port, jinst = _batch(field, k, n, batch, seed)
        poly = BatchedProductPoly(port)
        assert fs_kernel.fs_prove_device_batch(spec, port, DST) is None
        assert not fs_kernel.supports_fused_fs(spec, field, DST) and not jfs.supports_fused_fs(
            _jspec(spec), _jf(field), DST)
        ts = generate_transcripts_batch(poly, field, DST)
        for b in range(batch):
            assert ts[b].to_bytes() == _jax_host(spec, jinst[b], field, DST).to_bytes(), (field.name, b)
            inst = [FArray(t.data[b], field) for t in port]
            assert _accepts(ts[b], spec, inst, field, DST)
            assert not _accepts(ts[b], spec, inst, field)


def test_degree_below_and_above_k_matches_jax():
    """``degree=`` other than k: the first degree + 1 round sums, or s(0..k)
    extended by interpolation, byte-identical to the JAX package's own
    per-round batched prover (empty DST and a non-empty one)."""
    n, k, batch = 4, 2, 2
    for field, degree, dst in ((GOLDILOCKS, 1, b""), (GOLDILOCKS, 4, DST), (F1572869, 3, b""), (F5, 4, b"")):
        port, jinst = _batch(field, k, n, batch, 10 + degree)
        ts = generate_transcripts_batch(BatchedProductPoly(port, degree=degree), field, dst)
        with jax.disable_jit():
            jpoly = JBatched(JBatched.stack(jinst).tables, degree=degree)
            jts = jgenerate_batch(jpoly, _jf(field), dst)
        for b in range(batch):
            assert ts[b].to_bytes() == jts[b].to_bytes(), (field.name, degree, b)


def test_c1_and_round_batch_match_jax():
    """c_1 and two rounds of ``round_batch`` (round polynomials and the
    folded tables) against the JAX package's, k = 3."""
    n, k, batch = 3, 3, 2
    for field in (GOLDILOCKS, BABYBEAR):
        port, jinst = _batch(field, k, n, batch, 20)
        poly = BatchedProductPoly(port)
        with jax.disable_jit():
            jpoly = JBatched.stack(jinst)
            jc1 = jpoly.c_1()
            junis, jnext = jpoly.round_batch(None)
            jr = [jfields.Felt(7 + b, _jf(field)) for b in range(batch)]
            junis1, jnext1 = jnext.round_batch(jr)
        assert [c.v for c in poly.c_1()] == [c.v for c in jc1]
        unis, nxt = poly.round_batch(None)
        unis1, nxt1 = nxt.round_batch([field.felt(7 + b) for b in range(batch)])
        for got, want in ((unis, junis), (unis1, junis1)):
            assert [[(d, c.v) for d, c in u.terms] for u in got] == [[(d, c.v) for d, c in u.terms] for u in want]
        for t, jt in zip(nxt1.tables, jnext1.tables):
            np.testing.assert_array_equal(t.to_u64(), np.asarray(jt.to_u64()))


@pytest.mark.parametrize("k", [1, 4], ids=["k1", "k4"])
def test_fused_batch_k_matches_jax(k):
    """k = 1 and k = 4 through ``generate_transcripts_batch`` (the fused
    path: the round kernel's and the FS tail's plain versions), every
    instance fused and byte-identical to the JAX host loop and accepted."""
    n, batch = 4, 2
    for field, seed in ((GOLDILOCKS, 30 + k), (BABYBEAR, 40 + k)):
        spec = single_block_spec(k, n)
        port, jinst = _batch(field, k, n, batch, seed)
        fused = fs_kernel.fs_prove_device_batch(spec, port)
        assert all(m is not None for m in fused)
        ts = generate_transcripts_batch(BatchedProductPoly(port), field)
        for b in range(batch):
            assert ts[b].g == fused[b]
            assert ts[b].to_bytes() == _jax_host(spec, jinst[b], field).to_bytes(), (field.name, b)
            assert _accepts(ts[b], spec, [FArray(t.data[b], field) for t in port], field)


def test_device_transcript_triangle_matches_jax():
    """``generate_transcript_device`` over the triangle spec: the fused loop
    over ``round_step`` and the FS tail. 8 nodes byte-identical to the JAX
    package's triangle transcript (its host loop; the fused path covers the
    spec in both packages); 8 and 16 nodes byte-identical to the port's host
    loop and accepted (the JAX side's eager run of 16 nodes takes ~40 s of
    CPU, and ``tests/test_torch_triangles.py`` holds the port's host loop to
    the JAX package's)."""
    for n_nodes, field, seed in ((8, GOLDILOCKS, 5), (16, BABYBEAR, 6)):
        upper = np.triu(np.random.default_rng(seed).random((n_nodes, n_nodes)) < 0.5, k=1)
        adj = upper | upper.T
        k = (n_nodes - 1).bit_length()
        g = TriangleG.new_adj_matrix(2 * k, adj, field, device="cpu")
        assert fs_kernel.supports_fused_fs(g.spec, field, b"")
        assert jfs.supports_fused_fs(_jspec(g.spec), _jf(field), b"")
        t = generate_transcript_device(g, field)
        assert fs_kernel.fs_prove_device(g.spec, g.tables) == t.g  # fused, no fallback
        host = generate_transcript(SumcheckInteractiveProver(Prover(g)), field)
        assert t.to_bytes() == host.to_bytes(), n_nodes
        assert api.verify_triangle_count(adj, n_nodes, t, field, device="cpu")
        if n_nodes == 8:
            with jax.disable_jit():
                _, jt = japi.prove_triangle_count([bool(x) for x in adj.reshape(-1)], n_nodes, _jf(field))
            assert t.to_bytes() == jt.to_bytes()


def test_device_transcript_mixed_degree_and_k1_match_jax():
    """The mixed-degree 2-block spec (degree 2 over block 0, 1 over block
    1) and a k = 1 product through ``generate_transcript_device``, and the
    mixed spec as a batch of two, byte-identical to the JAX host loop;
    ``supports_fused_fs`` equal to the JAX package's on every spec here."""
    rng = np.random.default_rng(7)
    mixed = PolySpec(block_sizes=(2, 3), table_blocks=((0,), (0, 1)), terms=((0, 1),))
    k1 = single_block_spec(1, 5)
    flat = PolySpec(block_sizes=(2, 1), table_blocks=((0,), (0,)), terms=((0, 1),))  # a degree-0 round
    scalar = PolySpec(block_sizes=(3,), table_blocks=((0,), ()), terms=((0, 1), (0,)))
    for spec in (mixed, k1, flat, scalar, single_block_spec(2, 3)):
        for field in (GOLDILOCKS, F389):
            for dst in (b"", DST):
                assert fs_kernel.supports_fused_fs(spec, field, dst) == jfs.supports_fused_fs(
                    _jspec(spec), _jf(field), dst), (spec, field.name, dst)
    for spec, field in ((mixed, GOLDILOCKS), (mixed, F1572869), (k1, GOLDILOCKS), (k1, BABYBEAR)):
        sizes = [1 << sum(spec.block_sizes[b] for b in tb) for tb in spec.table_blocks]
        vals = [_values(rng, field, (2, s)) for s in sizes]
        batch = fs_kernel.fs_prove_device_batch(spec, [FArray.from_ints(v, field, device="cpu") for v in vals])
        for b in range(2):
            port = [FArray.from_ints(v[b], field, device="cpu") for v in vals]
            jtables = [jfields.FArray.from_ints(v[b], _jf(field)) for v in vals]
            t = generate_transcript_device(ProductPoly(spec, port), field)
            want = _jax_host(spec, jtables, field)
            assert t.to_bytes() == want.to_bytes(), (spec, field.name, b)
            assert batch[b] == t.g
            assert _accepts(t, spec, port, field)


def test_fs_tail_plain_degrees_match_jax():
    """The FS tail's plain version at round degrees 1 and 5: the message
    bytes, the chain state, the next challenge and the next claim, against
    the JAX package's serialization, interpolation and hasher over the
    whole transcript, at fills 0, 1, 55, 56, 63 and rounds 0 / middle / last."""
    rng = np.random.default_rng(8)
    # F5 takes degree 1 only: points 0..5 are not distinct mod 5
    for field, degrees in ((GOLDILOCKS, (1, 5)), (F5, (1,)), (F389, (1, 5)), (BABYBEAR, (5,))):
        jf = _jf(field)
        w = torch.int64 if field.backend == "goldilocks" else torch.int32
        mont = field.mont_r if field.backend == "mont32" else 1
        for degree in degrees:
            vinv = fs_kernel.interp_tensor(field, degree, "cpu")
            for fill, round_idx in ((0, 0), (1, 3), (55, 0), (56, 3), (63, 4)):
                prefix = rng.integers(0, 256, size=64 * 3 + fill, dtype=np.uint8).tobytes()
                sums = [int(x) for x in rng.integers(1, field.p, size=degree + 1, dtype=np.uint64)]
                claim = (sums[0] + sums[1]) % field.p
                state, buf = list(ZPAD_STATE), bytearray(64)
                absorb_py(state, buf, 0, prefix)
                chain = DevChain(torch.from_numpy(np.array([state], dtype=np.uint32).view(np.int32)),
                                 torch.tensor([list(buf)], dtype=torch.uint8), len(prefix))
                parts = u64_tensor(np.array([[[s * mont % field.p for s in sums]]], dtype=np.uint64), "cpu", w)
                cl = u64_tensor(np.array([claim * mont % field.p], dtype=np.uint64), "cpu", w)
                r, c1, zero = torch.zeros(1, dtype=w), torch.zeros(1, dtype=w), torch.zeros(1, dtype=torch.int32)
                coeffs = torch.zeros((1, degree + 1), dtype=w)
                m = fs_kernel._msg_len(round_idx, degree, field.byte_size)
                msgs = torch.zeros((1, len(prefix) + m), dtype=torch.uint8)
                draw = round_idx < 4
                fs_kernel.fs_tail(parts, chain, cl, r, c1, coeffs, msgs, zero, vinv, round_idx, 0, draw, field)
                uni = jinterp([jf.felt(s) for s in sums], jf)
                want = jser_c1(jf.felt(claim), uni) if round_idx == 0 else jser(uni)
                got = msgs[0, len(prefix):].numpy().tobytes()
                assert got == want, (field.name, degree, fill, round_idx)
                if draw:
                    jr = JHasher(jf).hash_to_field(prefix + want, 1)[0]
                    assert int(tensor_u64(r)[0]) * pow(mont, -1, field.p) % field.p == jr.v
                    assert int(tensor_u64(cl)[0]) * pow(mont, -1, field.p) % field.p == uni.evaluate(jr).v
