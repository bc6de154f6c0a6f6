"""The port's dense-W GKR prover (``gkr.Prover(..., use_linear=False)``)
against the JAX package, on the CPU.

- ``generate_gkr_transcript`` with the dense W (a two-block spec on the
  plain version of the multi-block round kernel) byte for byte against the
  JAX package's ``Prover(use_linear=False)`` run and against the port's own
  LibraW run, on the book circuit over F389 and a 5-layer circuit over
  BabyBear; accepted, and rejected when tampered (Goldilocks: the state
  test below; ``chip_smoke.py`` holds Goldilocks dense-W transcripts on
  the card against the port's LibraW run on the CPU);
- the host runtime's ``wiring_scatter`` and the dense wiring tables
  (``Circuit.add_i_ext`` / ``mul_i_ext``) against the JAX package's;
- ``gkr.W`` built from a JAX ``W``'s state (``from_jax_state``) after one
  block transition, its remaining rounds against the JAX polynomial's.

Both packages build their circuits from the same plain gate lists, with
inputs drawn from a numpy seed. The JAX side runs eagerly under
``jax.disable_jit()``. Tolerance: exact (transcript bytes, field values).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu import gkr as jgkr  # noqa: E402
from thaler_study_tpu import runtime as jruntime  # noqa: E402
from thaler_study_tpu_torch import gkr, runtime  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import SerializationError  # noqa: E402
from thaler_study_tpu_torch.fields import BABYBEAR, F389, GOLDILOCKS  # noqa: E402
from thaler_study_tpu_torch.protocols import from_jax_state  # noqa: E402
from thaler_study_tpu_torch.sumcheck import SumCheckError  # noqa: E402

_JF = {"Goldilocks": "GOLDILOCKS", "F389": "F389", "BabyBear": "BABYBEAR"}
BOOK = ([[(True, 0, 1), (True, 2, 3)], [(True, 0, 0), (True, 1, 1), (True, 1, 2), (True, 3, 3)]], 4)


def _jf(field):
    return getattr(jfields, _JF[field.name])


def _circuit(mod, layers, n_in):
    return mod.Circuit(
        [mod.CircuitLayer([mod.Gate(mod.GateType.MUL if m else mod.GateType.ADD, (b, c)) for m, b, c in l])
         for l in layers],
        n_in,
    )


def _case(name):
    """(field, gate lists output layer first, input count, inputs)."""
    if name == "book":
        return F389, BOOK[0], BOOK[1], [3, 2, 3, 1]
    field, widths, seed = {"five-goldilocks": (GOLDILOCKS, [4, 2, 4, 4, 2, 4], 31),
                           "five-babybear": (BABYBEAR, [8, 4, 8, 8, 4, 8], 32)}[name]
    rng = np.random.default_rng(seed)
    layers = [[(bool(rng.random() < 0.5), int(rng.integers(nxt)), int(rng.integers(nxt))) for _ in range(w)]
              for w, nxt in zip(widths[:-1], widths[1:])]
    inputs = [field.p - 1] + [int(x) for x in rng.integers(0, min(field.p, 1 << 62), widths[-1] - 1)]
    return field, layers, widths[-1], inputs


def _accepts(t, circuit, inputs, field) -> bool:
    try:
        return gkr.verify_gkr_transcript(t, gkr.Verifier(circuit, field), inputs, field)
    except (gkr.GKRError, SumCheckError, SerializationError, ValueError):
        return False


@pytest.mark.parametrize("name", ["book", "five-babybear"])
def test_dense_w_transcripts_match_jax(name):
    field, layers, n_in, inputs = _case(name)
    circuit, felts = _circuit(gkr, layers, n_in), field.felts(inputs)
    dense = gkr.generate_gkr_transcript(gkr.Prover(circuit, felts, field, use_linear=False, device="cpu"), field)
    libra = gkr.generate_gkr_transcript(gkr.Prover(circuit, felts, field, device="cpu"), field)
    jf = _jf(field)
    with jax.disable_jit():
        jt = jgkr.generate_gkr_transcript(
            jgkr.Prover(_circuit(jgkr, layers, n_in), jf.felts(inputs), jf, use_linear=False), jf)
    assert dense.to_bytes() == jt.to_bytes() == libra.to_bytes()
    assert _accepts(dense, circuit, felts, field)
    bad = [bytearray(m) for m in dense.g]
    bad[len(bad) // 2][-1] ^= 1
    assert not _accepts(gkr.GKRTranscript([bytes(m) for m in bad]), circuit, felts, field)


def test_wiring_scatter_matches_jax():
    """The dense wiring grid from the host runtime and the add~/mul~ tables
    fixed at r_i, against the JAX package's, on every layer of a 5-layer
    circuit (Goldilocks) and the book circuit (F389)."""
    rng = np.random.default_rng(40)
    for name in ("book", "five-goldilocks"):
        field, layers, n_in, _ = _case(name)
        circuit, jcircuit = _circuit(gkr, layers, n_in), _circuit(jgkr, layers, n_in)
        jf = _jf(field)
        for i in range(len(layers)):
            k_next = circuit.num_vars_at(i + 1)
            b, c, mul = circuit._wiring[i]
            w = rng.integers(0, field.p, size=len(b), dtype=np.uint64)
            for sel in (mul, ~mul):
                np.testing.assert_array_equal(runtime.wiring_scatter(b, c, sel, w, k_next, field.p),
                                              jruntime.wiring_scatter(b, c, sel, w, k_next, field.p))
            r = [field.felt(int(x)) for x in rng.integers(0, field.p, circuit.num_vars_at(i), dtype=np.uint64)]
            jr = [jf.felt(x.v) for x in r]
            for port, jax_ in ((circuit.add_i_ext(r, i, device="cpu"), jcircuit.add_i_ext(jr, i)),
                               (circuit.mul_i_ext(r, i, device="cpu"), jcircuit.mul_i_ext(jr, i))):
                assert port.num_vars == jax_.num_vars == 2 * k_next
                np.testing.assert_array_equal(port.evals.to_u64(), np.asarray(jax_.evals.to_u64()))


def test_w_from_jax_state():
    """A JAX W (layer 0 of the 5-layer Goldilocks circuit) proven past its
    b -> c block transition, carried into the port's gkr.W; the remaining
    rounds agree at the same challenges."""
    field, layers, n_in, inputs = _case("five-goldilocks")
    jf = _jf(field)
    jcircuit = _circuit(jgkr, layers, n_in)
    rng = np.random.default_rng(41)
    with jax.disable_jit():
        jprover = jgkr.Prover(jcircuit, jf.felts(inputs), jf, use_linear=False)
        r0 = [jf.felt(int(x)) for x in rng.integers(0, field.p, jcircuit.num_vars_at(0), dtype=np.uint64)]
        jprover.start_round(0, r0)
        jw = jprover.prover.g
        k = jw.w_b_num_vars
        rs = [int(x) for x in rng.integers(0, field.p, 2 * k, dtype=np.uint64)]
        _, jw = jw.round_univariate(None)
        for j in range(1, k + 1):
            _, jw = jw.round_univariate(jf.felt(rs[j - 1]))
    limbs = [tuple(np.asarray(x) for x in t.limbs) for t in jw.tables]
    w = from_jax_state(jw.spec, limbs, field, cls=gkr.W, device="cpu")
    assert isinstance(w, gkr.W) and w.w_b_num_vars == k and len(w.spec.block_sizes) == 1
    for j in range(k + 1, 2 * k):
        uni, w = w.round_univariate(field.felt(rs[j - 1]))
        with jax.disable_jit():
            juni, jw = jw.round_univariate(jf.felt(rs[j - 1]))
        assert [(d, c.v) for d, c in uni.terms] == [(d, c.v) for d, c in juni.terms], j
