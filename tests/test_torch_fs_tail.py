"""The FS tail's transcript bytes, over every buffer fill and every field of
the port.

- ``fs_tail_plain`` (the CPU path of ``fs_tail``) for F5, F389, F1572869,
  BabyBear and Goldilocks, over every ``nbytes % 64`` from 0 to 63, degree
  2 and 3, round 0 / middle / last (the round turns with the fill):
  - the bytes it writes into ``msgs`` are the messages ``absorb_py``
    hashed, and the rest of the buffer is untouched;
  - the message is the round polynomial: it evaluates to the round sums,
    its coefficients are the ``coeffs`` row, and the zero flag is set
    exactly when a coefficient is zero;
  - the chain it leaves finishes to ``hashlib``'s SHA-256 of
    Z_pad || transcript, and its challenge and next claim are those of the
    port's hashlib ``XmdChain`` over the same transcript;
- ``fs_prove_device_batch`` on CPU tensors (both plain versions, then
  ``split_transcripts`` over the transcript bytes) at n = 3, byte for byte
  against the JAX package's host loop under ``jax.disable_jit()``, for the
  five fields;
- the wrapper's checks of the byte buffer.

Inputs come from numpy seeds; tolerance: exact equality throughout. The
cases loop inside few test functions (at most 7): the suite runs under
pytest-xdist ``--dist loadfile``, which starts files with more cases first.
"""

import hashlib

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
from thaler_study_tpu.ops import round_kernel as jrk  # noqa: E402
from thaler_study_tpu.protocols import ProductPoly as JProductPoly  # noqa: E402
from thaler_study_tpu.sumcheck import Prover as JProver  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import XmdChain  # noqa: E402
from thaler_study_tpu_torch.fields import BABYBEAR, F5, F389, F1572869, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.fields.farray import tensor_u64, u64_tensor, word_dtype  # noqa: E402
from thaler_study_tpu_torch.ops import fs_kernel  # noqa: E402
from thaler_study_tpu_torch.ops import round_kernel as rk  # noqa: E402
from thaler_study_tpu_torch.ops.sha256 import digest_bytes, py_compress  # noqa: E402
from thaler_study_tpu_torch.ops.sha_chain import ZPAD_STATE, DevChain, absorb_py  # noqa: E402

FIELDS = (F5, F389, F1572869, BABYBEAR, GOLDILOCKS)
N_ROUNDS, BATCH, BLOCKS = 4, 3, 3
ROUNDS = (0, 2, N_ROUNDS - 1)  # round 0, a middle round, the last round (no draw)


def _jfield(field):
    return getattr(jfields, {"F5": "F5", "F389": "F389", "F1572869": "F1572869",
                             "BabyBear": "BABYBEAR", "Goldilocks": "GOLDILOCKS"}[field.name])


def _words(field, values: np.ndarray) -> torch.Tensor:
    """Canonical values < p (uint64) as the field's device words."""
    if field.backend == "mont32":
        values = np.array([int(v) * field.mont_r % field.p for v in values.reshape(-1)],
                          dtype=np.uint64).reshape(values.shape)
    return u64_tensor(values, "cpu", word_dtype(field))


def _canonical(field, t: torch.Tensor) -> list:
    rinv = pow(field.mont_r, -1, field.p) if field.backend == "mont32" else 1
    return [int(x) * rinv % field.p for x in tensor_u64(t).reshape(-1)]


def _finish(state, buf, nbytes) -> bytes:
    """SHA-256 digest of the chain's Z_pad || transcript (nbytes bytes)."""
    st = list(state)
    tail = bytes(buf[: nbytes % 64]) + b"\x80"
    tail += bytes((56 - len(tail)) % 64) + (8 * (64 + nbytes)).to_bytes(8, "big")
    for off in range(0, len(tail), 64):
        py_compress(st, tail[off : off + 64])
    return digest_bytes(st)


def _run_tail_case(field, degree, fill, rng, absorbed):
    p, bs, d1 = field.p, field.byte_size, degree + 1
    round_idx = ROUNDS[fill % 3]
    draw = round_idx < N_ROUNDS - 1
    nbytes = 64 * (1 + fill % 3) + fill
    m = fs_kernel._msg_len(round_idx, degree, bs)
    where = f"{field.name} degree={degree} fill={fill} round={round_idx}"

    prefixes = [rng.integers(0, 256, size=nbytes, dtype=np.uint8).tobytes() for _ in range(BATCH)]
    states, bufs = [], []
    for prefix in prefixes:
        st, buf = list(ZPAD_STATE), bytearray(64)
        absorb_py(st, buf, 0, prefix)
        states.append(st)
        bufs.append(list(buf))
    chain = DevChain(torch.from_numpy(np.array(states, dtype=np.uint32).view(np.int32)),
                     torch.tensor(bufs, dtype=torch.uint8), nbytes)
    sums = rng.integers(0, p, size=(BATCH, BLOCKS, d1), dtype=np.uint64)
    sums[1] = 0  # proof 1: every round sum zero -> zero coefficients
    claims_in = rng.integers(0, p, size=BATCH, dtype=np.uint64)
    claims_in[1] = 0
    claim = _words(field, claims_in)
    r = _words(field, np.zeros(BATCH, dtype=np.uint64))
    c1 = torch.zeros(BATCH, dtype=word_dtype(field))
    coeffs = torch.zeros((BATCH, d1 * N_ROUNDS), dtype=word_dtype(field))
    msgs0 = torch.from_numpy(rng.integers(0, 256, size=(BATCH, nbytes + m + 7), dtype=np.uint8))
    msgs = msgs0.clone()
    any_zero = torch.zeros(BATCH, dtype=torch.int32)
    vinv = fs_kernel.interp_tensor(field, degree, "cpu")

    absorbed.clear()
    fs_kernel.fs_tail(_words(field, sums), chain, claim, r, c1, coeffs, msgs, any_zero, vinv,
                      round_idx, d1 * round_idx, draw, field)
    assert chain.nbytes == nbytes + m, where
    assert len(absorbed) == BATCH and all(len(x) == m for x in absorbed), where
    rows, flags = msgs.numpy(), any_zero.tolist()
    coef = tensor_u64(coeffs)[:, d1 * round_idx : d1 * (round_idx + 1)].tolist()
    states = chain.state.numpy().view(np.uint32).tolist()
    for b in range(BATCH):
        msg = absorbed[b]
        assert rows[b, nbytes : nbytes + m].tobytes() == msg, where
        assert np.array_equal(np.delete(rows[b], np.s_[nbytes : nbytes + m]),
                              np.delete(msgs0.numpy()[b], np.s_[nbytes : nbytes + m])), where

        # the message is the round polynomial g over the round sums
        body = msg[bs:] if round_idx == 0 else msg
        assert int.from_bytes(body[:8], "little") == d1, where
        terms = [body[8 + t * (8 + bs) : 8 + (t + 1) * (8 + bs)] for t in range(d1)]
        assert [int.from_bytes(x[:8], "little") for x in terms] == list(range(d1)), where
        c = [int.from_bytes(x[8:], "little") for x in terms]
        assert c == coef[b], where
        assert flags[b] == int(0 in c), where
        g = [sum(ci * pow(t, i, p) for i, ci in enumerate(c)) % p for t in range(d1)]
        s = [sum(int(x) for x in sums[b, :, e]) % p for e in range(d1)]
        if round_idx == 0:
            assert int.from_bytes(msg[:bs], "little") == (g[0] + g[1]) % p == int(tensor_u64(c1)[b]), where
        else:
            assert (g[0] + g[1]) % p == int(claims_in[b]), where
            s[1] = g[1]
        assert g == s, where

        # the chain: the transcript so far, and the draw from it
        transcript = prefixes[b] + msg
        want = hashlib.sha256(bytes(64) + transcript).digest()
        assert _finish(states[b], bytes(chain.buf[b].tolist()), nbytes + m) == want, where
        assert chain.buf[b, (nbytes + m) % 64 :].eq(0).all(), where
        if draw:
            xmd = XmdChain(field)
            xmd.absorb(transcript)
            rv = xmd.draw(1)[0].v
            assert _canonical(field, r)[b] == rv, where
            assert _canonical(field, claim)[b] == sum(ci * pow(rv, i, p) for i, ci in enumerate(c)) % p, where
    assert flags[1] == 1, where


@pytest.mark.parametrize("field", FIELDS, ids=[f.name for f in FIELDS])
def test_plain_tail_bytes_and_chain_every_fill(field, monkeypatch):
    absorbed = []
    absorb = fs_kernel.absorb_py

    def recording_absorb(state, buf, nbytes, msg):
        absorbed.append(bytes(msg))
        absorb(state, buf, nbytes, msg)

    monkeypatch.setattr(fs_kernel, "absorb_py", recording_absorb)
    rng = np.random.default_rng(field.p % 1000)
    for degree in (2, 3):
        for fill in range(64):
            _run_tail_case(field, degree, fill, rng, absorbed)


def _tables(field, values):
    """Port FArrays and per-instance JAX FArrays of canonical values."""
    if field.backend == "goldilocks":
        lo = [(v & np.uint64(0xFFFFFFFF)).astype(np.uint32) for v in values]
        hi = [(v >> np.uint64(32)).astype(np.uint32) for v in values]
        port = [FArray.from_jax_limbs(a, b, device="cpu") for a, b in zip(lo, hi)]
        jax_side = [[JFArray((jnp.asarray(a[i]), jnp.asarray(b[i])), jfields.GOLDILOCKS) for a, b in zip(lo, hi)]
                    for i in range(values[0].shape[0])]
    else:
        words = [(v * np.uint64(field.mont_r) % np.uint64(field.p)).astype(np.uint32) for v in values]
        port = [FArray.from_jax_limbs(w, field=field, device="cpu") for w in words]
        jax_side = [[JFArray((jnp.asarray(w[i]),), _jfield(field)) for w in words]
                    for i in range(values[0].shape[0])]
    return port, jax_side


def test_batch_slicing_matches_jax():
    n, batch = 3, 2
    for field in FIELDS:
        fused_count = 0
        for k in (2, 3):
            rng = np.random.default_rng(190000 + 1000 * k + field.p % 1000)  # one F5 instance without zeros
            values = [rng.integers(1, field.p, size=(batch, 1 << n), dtype=np.uint64) for _ in range(k)]
            port_tables, jax_tables = _tables(field, values)
            spec = rk.single_block_spec(k, n)
            jspec = jrk.PolySpec(spec.block_sizes, spec.table_blocks, spec.terms)
            fused = fs_kernel.fs_prove_device_batch(spec, port_tables)
            with jax.disable_jit():
                ref = [jgenerate(JInteractiveProver(JProver(JProductPoly(jspec, t))), _jfield(field))
                       for t in jax_tables]
            lens = [fs_kernel._msg_len(j, k, field.byte_size) for j in range(n)]
            assert len(fused) == batch
            for b in range(batch):
                where = f"{field.name} k={k} instance {b}"
                if fused[b] is None:  # a zero coefficient: arkworks drops its term
                    assert [len(m) for m in ref[b].g] != lens, where
                    continue
                assert [len(m) for m in fused[b]] == lens, where
                assert fused[b] == list(ref[b].g), where
                fused_count += 1
        assert fused_count, field.name
    # split_transcripts alone: flags and slices
    lens = [3, 1, 2]
    host = np.arange(2 * 10, dtype=np.uint8).reshape(2, 10)
    host[:, 6:] = 0
    host[1, 8] = 1
    assert fs_kernel.split_transcripts(host, lens) == [[bytes([0, 1, 2]), bytes([3]), bytes([4, 5])], None]


def test_tail_checks_the_byte_buffer():
    field, degree, batch = BABYBEAR, 2, 2
    m = fs_kernel._msg_len(1, degree, field.byte_size)
    w = word_dtype(field)

    def call(msgs, nbytes=64):
        chain = DevChain.fresh(batch, "cpu")
        chain.nbytes = nbytes
        fs_kernel.fs_tail(torch.zeros((batch, 1, degree + 1), dtype=w), chain, torch.zeros(batch, dtype=w),
                          torch.zeros(batch, dtype=w), torch.zeros(batch, dtype=w),
                          torch.zeros((batch, 3), dtype=w), msgs, torch.zeros(batch, dtype=torch.int32),
                          fs_kernel.interp_tensor(field, degree, "cpu"), 1, 0, True, field)
        return chain

    assert call(torch.zeros((batch, 64 + m), dtype=torch.uint8)).nbytes == 64 + m
    for bad in (torch.zeros((batch, 63 + m), dtype=torch.uint8),  # one byte short
                torch.zeros((batch, 64 + m), dtype=torch.int32),
                torch.zeros((batch + 1, 64 + m), dtype=torch.uint8),
                torch.zeros((batch, 2 * (64 + m)), dtype=torch.uint8)[:, ::2]):
        with pytest.raises(ValueError):
            call(bad)
