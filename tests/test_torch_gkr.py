"""The port's GKR prover and verifier against the JAX package, on the CPU.

- ``generate_gkr_transcript`` byte for byte against the JAX package's, on
  the book circuit over F389, a 5-layer circuit over Goldilocks and over
  BabyBear, and a mixed-width circuit over F1572869; the port's
  ``verify_gkr_transcript`` accepts them and rejects tampered transcripts
  and wrong inputs;
- ``resume_gkr_transcript`` byte-identical at every cut of the book
  circuit (fold-only fast-forward, and ``verify_prefix``);
- ``api.run_gkr`` (the interactive protocol) against the JAX ``run_gkr``;
- the bulk ``Begin`` codec against the JAX package's, and the entry points
  of later slices, which raise.

Both packages build their circuits from the same plain gate lists, with
inputs drawn from a numpy seed. The port runs with ``device="cpu"``, which
takes the plain versions of the round kernel (K1) and the phase-table
kernel (K2); the JAX side runs eagerly under ``jax.disable_jit()`` and
compiles no JAX program. Tolerance: exact (transcript bytes).

Cases loop inside a few test functions on purpose: the suite runs under
pytest-xdist ``--dist loadfile``, which starts files with more cases first;
more than 7 here would start this file ahead of the long GKR files.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from thaler_study_tpu import api as japi  # noqa: E402
from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu import gkr as jgkr  # noqa: E402
from thaler_study_tpu_torch import api, gkr  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import SerializationError  # noqa: E402
from thaler_study_tpu_torch.fields import BABYBEAR, F389, F1572869, GOLDILOCKS, FeltVector  # noqa: E402
from thaler_study_tpu_torch.sumcheck import SumCheckError  # noqa: E402

_JF = {"Goldilocks": "GOLDILOCKS", "F389": "F389", "BabyBear": "BABYBEAR", "F1572869": "F1572869"}


def _jf(field):
    return getattr(jfields, _JF[field.name])


def _gate_lists(widths, seed):
    """[(is_mul, b, c) per gate] per layer, output layer first; widths[-1]
    is the input count."""
    rng = np.random.default_rng(seed)
    layers = []
    for i in range(len(widths) - 1):
        nxt = widths[i + 1]
        layers.append([(bool(rng.random() < 0.5), int(rng.integers(nxt)), int(rng.integers(nxt))) for _ in range(widths[i])])
    return layers


def _circuit(mod, layers, n_in):
    return mod.Circuit(
        [mod.CircuitLayer([mod.Gate(mod.GateType.MUL if m else mod.GateType.ADD, (b, c)) for m, b, c in l])
         for l in layers],
        n_in,
    )


BOOK = ([[(True, 0, 1), (True, 2, 3)], [(True, 0, 0), (True, 1, 1), (True, 1, 2), (True, 3, 3)]], 4)


def _case(name):
    """(field, gate lists, input count, inputs) of a named circuit."""
    if name == "book":
        return F389, BOOK[0], BOOK[1], [3, 2, 3, 1]
    field, widths, seed = {
        "five-goldilocks": (GOLDILOCKS, [4, 2, 4, 4, 2, 4], 21),
        "five-babybear": (BABYBEAR, [8, 8, 8, 8, 8, 8], 22),
        "mixed-f1572869": (F1572869, [2, 16, 4, 8, 4], 23),
    }[name]
    rng = np.random.default_rng(seed + 100)
    inputs = [field.p - 1] + [int(x) for x in rng.integers(0, min(field.p, 1 << 62), widths[-1] - 1)]
    return field, _gate_lists(widths, seed), widths[-1], inputs


@functools.lru_cache(maxsize=None)
def _jax_transcript(name, dst=b"") -> bytes:
    field, layers, n_in, inputs = _case(name)
    jf = _jf(field)
    circuit = _circuit(jgkr, layers, n_in)
    with jax.disable_jit():
        return jgkr.generate_gkr_transcript(jgkr.Prover(circuit, jf.felts(inputs), jf), jf, dst).to_bytes()


def _port(name):
    field, layers, n_in, inputs = _case(name)
    return field, _circuit(gkr, layers, n_in), field.felts(inputs)


def _prover(circuit, inputs, field):
    return gkr.Prover(circuit, inputs, field, device="cpu")


def _accepts(t, circuit, inputs, field) -> bool:
    try:
        return gkr.verify_gkr_transcript(t, gkr.Verifier(circuit, field), inputs, field)
    except (gkr.GKRError, SumCheckError, SerializationError, ValueError):
        return False


def _check_transcript(name):
    """Byte identity with the JAX package, acceptance, and rejection of a
    flipped byte in each kind of message and of wrong inputs."""
    field, circuit, inputs = _port(name)
    t = gkr.generate_gkr_transcript(_prover(circuit, inputs, field), field)
    assert t.to_bytes() == _jax_transcript(name), name
    assert _accepts(t, circuit, inputs, field)
    again = gkr.GKRTranscript.from_bytes(t.to_bytes())
    assert all(gkr.serialize_gkr_message(gkr.deserialize_gkr_message(m, field)) == m for m in again.g)
    kinds = {}
    for i, m in enumerate(t.g):
        kinds.setdefault(m[0], i)
    assert sorted(kinds) == [0, 1, 2, 3]
    for i in kinds.values():
        bad = [bytearray(m) for m in t.g]
        bad[i][-1] ^= 1
        assert not _accepts(gkr.GKRTranscript([bytes(m) for m in bad]), circuit, inputs, field), (name, i)
    wrong = list(inputs)
    wrong[-1] = wrong[-1] + field.one()
    assert not _accepts(t, circuit, wrong, field)
    return field, circuit, inputs, t


def test_book_circuit_transcript_matches_jax():
    """Also under a non-empty DST: the challenge chain is host code and
    takes any DST, as the JAX package's does."""
    field, circuit, inputs, t = _check_transcript("book")
    outs = gkr.deserialize_gkr_message(t.g[0], field).circuit_outputs
    assert [f.v for f in outs] == [36, 6]
    dst = b"thaler-study-gkr"
    tagged = gkr.generate_gkr_transcript(_prover(circuit, inputs, field), field, dst)
    assert tagged.to_bytes() == _jax_transcript("book", dst) != t.to_bytes()
    assert gkr.verify_gkr_transcript(tagged, gkr.Verifier(circuit, field), inputs, field, dst)
    assert not _accepts(tagged, circuit, inputs, field)


@pytest.mark.parametrize("name", ["five-goldilocks", "five-babybear"])
def test_five_layer_transcripts_match_jax(name):
    field, circuit, inputs, t = _check_transcript(name)
    assert len(circuit.layers) == 5
    assert len(t.g) == 1 + sum(1 + 2 * circuit.num_vars_at(i + 1) for i in range(5))


def test_mixed_width_transcript_matches_jax():
    field, circuit, inputs, t = _check_transcript("mixed-f1572869")
    assert len({circuit.num_vars_at(i) for i in range(len(circuit.layers) + 1)}) > 2


def test_resume_every_cut_of_the_book_circuit():
    """Fold-only resume at every cut, and verify_prefix at every cut, give
    the JAX package's bytes; a foreign prefix is detected."""
    field, circuit, inputs = _port("book")
    want = _jax_transcript("book")
    full = gkr.GKRTranscript.from_bytes(want)
    for cut in range(len(full.g) + 1):
        for verify_prefix in (False, True):
            got = gkr.resume_gkr_transcript(
                _prover(circuit, inputs, field), field, gkr.GKRTranscript(full.g[:cut]), verify_prefix=verify_prefix
            )
            assert got.to_bytes() == want, (cut, verify_prefix)
    other = gkr.generate_gkr_transcript(_prover(circuit, field.felts([1, 2, 3, 4]), field), field)
    with pytest.raises(SerializationError):
        gkr.resume_gkr_transcript(
            _prover(circuit, inputs, field), field, gkr.GKRTranscript(other.g[:3]), verify_prefix=True
        )


def test_run_gkr_matches_jax():
    """The interactive protocol (api.run_gkr, SeededRng challenges) on the
    book circuit and the BabyBear 5-layer circuit: the same outputs and
    decision as the JAX run_gkr; the entry points of later slices raise."""
    for name, seed in (("book", 0), ("five-babybear", 3)):
        field, layers, n_in, inputs = _case(name)
        outs, ok = api.run_gkr(_circuit(gkr, layers, n_in), inputs, field, seed=seed, device="cpu")
        with jax.disable_jit():
            jouts, jok = japi.run_gkr(_circuit(jgkr, layers, n_in), inputs, _jf(field), seed=seed)
        assert ok and jok
        assert [f.v for f in outs] == [f.v for f in jouts], name

    field, circuit, inputs = _port("book")
    with pytest.raises(NotImplementedError, match="multi-block"):
        gkr.Prover(circuit, inputs, field, use_linear=False, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-device"):
        gkr.Prover(circuit, inputs, field, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        api.prove_triangle_count(np.zeros((4, 4), dtype=np.int64), 4, field, device="cpu")


def test_begin_codec_matches_jax():
    """The bulk Begin codec (u64-LE count, then the elements) against the
    JAX package's for Goldilocks and F389 outputs at the boundary values;
    decoding gives a FeltVector and rejects a non-canonical element or a
    trailing byte."""
    rng = np.random.default_rng(29)
    for field in (GOLDILOCKS, F389):
        p = field.p
        vals = rng.integers(0, p, 1000, dtype=np.uint64)
        vals[:3] = [p - 1, 0, 1]
        msg = gkr.Begin(circuit_outputs=FeltVector(vals.copy(), field))
        raw = gkr.serialize_gkr_message(msg)
        jmsg = jgkr.Begin(circuit_outputs=jfields.FeltVector(vals.copy(), _jf(field)))
        assert raw == jgkr.serialize_gkr_message(jmsg)
        assert raw == gkr.serialize_gkr_message(gkr.Begin(circuit_outputs=field.felts([int(v) for v in vals])))
        back = gkr.deserialize_gkr_message(raw, field)
        assert isinstance(back.circuit_outputs, FeltVector)
        assert np.array_equal(np.asarray(back.circuit_outputs.ints, dtype=np.uint64), vals)
        bad = bytearray(raw)
        bad[9 : 9 + field.byte_size] = b"\xff" * field.byte_size
        with pytest.raises(ValueError):
            gkr.deserialize_gkr_message(bytes(bad), field)
        with pytest.raises(SerializationError):
            gkr.deserialize_gkr_message(raw + b"\x00", field)
