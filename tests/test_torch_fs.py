"""The port's Fiat-Shamir layer and whole batched prover against the JAX
package.

- Host layer: the golden transcripts (``tests/data/fs_golden.json``)
  replayed through the port's ``SparseMultiPoly`` + ``generate_transcript``;
  the port's hasher and SHA-256 chain against the JAX hasher and hashlib.
- The slice as a whole: the port's ``fs_prove_device_batch`` (CPU tensors,
  so the plain versions of both kernels) at n = 4, B = 2, byte for byte
  against the JAX package's transcripts; then a batch with an all-zero
  factor in one instance through the port's ``generate_transcripts_batch``.

The JAX side is its host loop (``ProductPoly`` + ``generate_transcript``)
with jit disabled: seconds on the CPU, where compiling the JAX fused
``fs_prove_device_batch`` costs about half a minute. The JAX package's own
tests hold that fused prover, and its per-instance fallback, byte for byte
to the same host loop (``tests/test_fs_kernel.py``).

Inputs come from a seed via numpy; tolerance: byte-identical transcripts.

Cases loop inside a few test functions on purpose: the suite runs under
pytest-xdist ``--dist loadfile``, which starts files with more cases first;
more than 7 here would start this file ahead of the long GKR files and
lengthen the whole run.
"""

import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thaler_study_tpu.fiat_shamir import DefaultFieldHasher as JHasher  # noqa: E402
from thaler_study_tpu.fiat_shamir import SumcheckInteractiveProver as JInteractiveProver  # noqa: E402
from thaler_study_tpu.fiat_shamir import generate_transcript as jgenerate  # noqa: E402
from thaler_study_tpu.fields import GOLDILOCKS as JF  # noqa: E402
from thaler_study_tpu.fields import FArray as JFArray  # noqa: E402
from thaler_study_tpu.ops.round_kernel import PolySpec as JPolySpec  # noqa: E402
from thaler_study_tpu.protocols import ProductPoly as JProductPoly  # noqa: E402
from thaler_study_tpu.sumcheck import Prover as JProver  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import (  # noqa: E402
    DefaultFieldHasher,
    FiatShamirTranscript,
    SerializationError,
    SumcheckInteractiveProver,
    SumcheckInteractiveVerifier,
    XmdChain,
    generate_transcript,
    verify_transcript,
)
from thaler_study_tpu_torch.fields import GOLDILOCKS, FArray, FieldConfig  # noqa: E402
from thaler_study_tpu_torch.ops import fs_kernel  # noqa: E402
from thaler_study_tpu_torch.ops.round_kernel import single_block_spec  # noqa: E402
from thaler_study_tpu_torch.ops.sha256 import H0, digest_bytes, py_compress  # noqa: E402
from thaler_study_tpu_torch.ops.sha_chain import ZPAD_STATE, absorb_py, draw_gl_py  # noqa: E402
from thaler_study_tpu_torch.protocols import (  # noqa: E402
    BatchedProductPoly,
    ProductPoly,
    generate_transcripts_batch,
)
from thaler_study_tpu_torch.sumcheck import (  # noqa: E402
    Prover,
    SparseMultiPoly,
    SumCheckError,
    Verifier,
)

P = GOLDILOCKS.p
N_VARS, BATCH = 4, 2
_GOLDEN = os.path.join(os.path.dirname(__file__), "data", "fs_golden.json")


def _golden_cases():
    with open(_GOLDEN) as f:
        return json.load(f)["cases"]


def test_golden_transcripts_through_the_port():
    cases = _golden_cases()
    assert cases
    for case in cases:
        field = FieldConfig(case["p"])
        terms = [(field.felt(c), [(v, p) for v, p in t]) for c, t in case["terms"]]
        g = SparseMultiPoly(case["num_vars"], terms, field)
        transcript = generate_transcript(SumcheckInteractiveProver(Prover(g)), field)
        assert [m.hex() for m in transcript.g] == case["messages_hex"], case["name"]
        v = SumcheckInteractiveVerifier(Verifier(case["num_vars"], g), field)
        assert verify_transcript(transcript, v, field), case["name"]


def test_hasher_and_chain_match_jax():
    for p in (5, 389, 1572869, P):
        field = FieldConfig(p)
        port, ref = DefaultFieldHasher(field), JHasher(field)
        chain = XmdChain(field)
        rng = np.random.default_rng(p % 1000)
        running = b""
        for size in (0, 1, 55, 56, 63, 64, 65, 130):
            msg = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            running += msg
            chain.absorb(msg)
            want = [f.v for f in ref.hash_to_field(running, 2)]
            assert [f.v for f in port.hash_to_field(running, 2)] == want, (p, size)
            assert [f.v for f in chain.draw(2)] == want, (p, size)


def test_py_compress_matches_hashlib():
    msg = bytes(range(256)) * 3
    padded = msg + b"\x80" + bytes((55 - len(msg)) % 64) + (8 * len(msg)).to_bytes(8, "big")
    state = list(H0)
    for off in range(0, len(padded), 64):
        py_compress(state, padded[off : off + 64])
    assert digest_bytes(state) == hashlib.sha256(msg).digest()


def test_plain_device_chain_matches_xmd_chain():
    """absorb_py / draw_gl_py — the FS tail kernel's plain chain — draw the
    same challenges as the host XmdChain at every buffer fill."""
    chain = XmdChain(GOLDILOCKS)
    state, buf, nbytes = list(ZPAD_STATE), bytearray(64), 0
    rng = np.random.default_rng(3)
    for size in (72, 1, 50, 63, 64, 129, 7):
        msg = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        chain.absorb(msg)
        absorb_py(state, buf, nbytes, msg)
        nbytes += size
        assert buf[nbytes % 64 :] == bytes(64 - nbytes % 64)
        assert draw_gl_py(state, buf, nbytes) == chain.draw(1)[0].v


def _batch_values(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, P, size=(BATCH, 1 << N_VARS), dtype=np.uint64) for _ in range(2)]


def _limbs(v):
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32)


def _jax_transcripts(values, jspec):
    """The JAX package's host-loop transcript of each instance, jit disabled."""
    out = []
    with jax.disable_jit():
        for b in range(BATCH):
            tables = [JFArray(tuple(jnp.asarray(x) for x in _limbs(v[b])), JF) for v in values]
            out.append(jgenerate(JInteractiveProver(JProver(JProductPoly(jspec, tables))), JF))
    return out


def _port_tables(values):
    return [FArray.from_jax_limbs(*_limbs(v), device="cpu") for v in values]


def _spec():
    spec = single_block_spec(2, N_VARS)
    return spec, JPolySpec(spec.block_sizes, spec.table_blocks, spec.terms)


def test_fs_prove_device_batch_matches_jax():
    values = _batch_values(42)
    spec, jspec = _spec()
    port = fs_kernel.fs_prove_device_batch(spec, _port_tables(values))
    ref = _jax_transcripts(values, jspec)
    assert len(port) == BATCH
    for b in range(BATCH):
        assert port[b] is not None
        assert [m.hex() for m in port[b]] == [m.hex() for m in ref[b].g], f"instance {b}"
        inst = [FArray(t.data[b], GOLDILOCKS) for t in _port_tables(values)]
        assert fs_kernel.fs_prove_device(spec, inst) == port[b]  # a batch of one
        v = SumcheckInteractiveVerifier(Verifier(N_VARS, ProductPoly(spec, inst)), GOLDILOCKS)
        assert verify_transcript(FiatShamirTranscript(port[b]), v, GOLDILOCKS)


def test_zero_instance_falls_back_like_jax():
    values = _batch_values(43)
    values[0][1] = 0  # instance 1: an all-zero factor forces zero coefficients
    spec, jspec = _spec()
    assert fs_kernel.fs_prove_device_batch(spec, _port_tables(values))[1] is None
    port = generate_transcripts_batch(BatchedProductPoly(_port_tables(values)), GOLDILOCKS)
    ref = _jax_transcripts(values, jspec)
    for b in range(BATCH):
        assert port[b].to_bytes() == ref[b].to_bytes(), f"instance {b}"
        inst = [FArray(t.data[b], GOLDILOCKS) for t in _port_tables(values)]
        v = SumcheckInteractiveVerifier(Verifier(N_VARS, ProductPoly(spec, inst)), GOLDILOCKS)
        assert verify_transcript(port[b], v, GOLDILOCKS)


def test_tampered_transcript_is_rejected():
    values = _batch_values(44)
    spec, _ = _spec()
    t = generate_transcripts_batch(BatchedProductPoly(_port_tables(values)), GOLDILOCKS)[0]
    msg = bytearray(t.g[1])
    msg[8 + 8] ^= 1  # lowest byte of round 1's first coefficient
    bad = FiatShamirTranscript([t.g[0], bytes(msg)] + t.g[2:])
    inst = [FArray(x.data[0], GOLDILOCKS) for x in _port_tables(values)]
    v = SumcheckInteractiveVerifier(Verifier(N_VARS, ProductPoly(spec, inst)), GOLDILOCKS)
    with pytest.raises((SumCheckError, SerializationError, AssertionError)):
        assert verify_transcript(bad, v, GOLDILOCKS), "tampered transcript verified"
