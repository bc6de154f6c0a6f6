"""The port's one-program forms against the JAX package, on the CPU.

The JAX package runs a whole fused GKR proof (``gkr/fused.py``
``_scan_proof_jit``) and B whole sumcheck proofs (``ops/fs_kernel.py``
``_fs_prove_batch_jit``) as one XLA program each. The port's counterparts
are programs that hold their state on the device and, on a card, replay
their launches as one CUDA graph: ``gkr.fused._Program`` (one per circuit,
device, field and Begin length, kept on the circuit) and
``ops.fs_kernel._BatchProgram`` (one per k, n, field, B and device, kept in
``fs_kernel.programs``). On the CPU a program runs its loop eagerly over
the plain versions, so these cases exercise what every proof does around
the replay: the bind of a proof's inputs and the reset of the state a
previous proof left.

- two proofs with different inputs through one fused program, on a
  uniform and a mixed-width circuit, each byte-identical to the JAX
  package's host ``generate_gkr_transcript``;
- a proof after the program's zero flag was set to 1 by hand: the same
  bytes, no fallback;
- the ``timings`` names of a program's warm proof against the JAX
  package's scan branch (its layer program replaced by zeros of its output
  shapes: the names come from its host code, and the program would cost
  a minute eagerly);
- two batch dispatches with different tables through one batch program,
  Goldilocks and BabyBear at k = 2, each instance byte-identical to the
  JAX package's host loop, with the program's chains and zero flags
  spoiled by hand between them, and equal to the eager route.

The JAX side runs under ``jax.disable_jit()`` (its host loops, never a
compiled program). Inputs come from numpy seeds whose serialized
coefficients are all nonzero. Tolerance: exact (bytes). The replays
themselves run only on the card: ``chip_smoke.py`` holds them against the
eager loop and ``device="cpu"``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu import gkr as jgkr  # noqa: E402
from thaler_study_tpu.fiat_shamir import SumcheckInteractiveProver as JInteractiveProver  # noqa: E402
from thaler_study_tpu.fiat_shamir import generate_transcript as jgenerate  # noqa: E402
from thaler_study_tpu.gkr import fused as jfused  # noqa: E402
from thaler_study_tpu.ops.round_kernel import PolySpec as JPolySpec  # noqa: E402
from thaler_study_tpu.protocols import ProductPoly as JProductPoly  # noqa: E402
from thaler_study_tpu.sumcheck import Prover as JProver  # noqa: E402
from thaler_study_tpu_torch import gkr  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import FiatShamirTranscript  # noqa: E402
from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.gkr import fused  # noqa: E402
from thaler_study_tpu_torch.ops import fs_kernel, graphs  # noqa: E402
from thaler_study_tpu_torch.ops.round_kernel import single_block_spec  # noqa: E402

F = GOLDILOCKS
JF = jfields.GOLDILOCKS
CPU = torch.device("cpu")
SCAN_KEYS = ["prelude", "scan_layers", "pull", "assemble"]


def _gate_lists(widths, seed):
    """[(is_mul, b, c) per gate] per layer, output layer first."""
    rng = np.random.default_rng(seed)
    return [[(bool(rng.random() < 0.5), int(rng.integers(widths[i + 1])), int(rng.integers(widths[i + 1])))
             for _ in range(widths[i])] for i in range(len(widths) - 1)]


def _circuit(mod, layers, n_in):
    return mod.Circuit(
        [mod.CircuitLayer([mod.Gate(mod.GateType.MUL if m else mod.GateType.ADD, (b, c)) for m, b, c in l])
         for l in layers],
        n_in,
    )


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return [F.p - 1] + [int(x) for x in rng.integers(0, 1 << 62, n - 1)]


def _prove(circuit, inputs, timings=None):
    return gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, F.felts(inputs), F, device="cpu"), F,
                                             timings=timings)


def _the_program(circuit):
    (prog,) = circuit._fused_programs.values()
    return prog


@pytest.mark.parametrize("widths,seed", [([4, 4, 4], 5), ([4, 8, 4], 30)], ids=["uniform", "mixed"])
def test_fused_program_two_proofs_match_jax(widths, seed):
    """The first proof fills the circuit's program (eager, per-layer
    timings), the second runs through it (one "scan_layers" entry); both
    byte-identical to the JAX package with their own inputs."""
    layers = _gate_lists(widths, seed)
    circuit = _circuit(gkr, layers, widths[-1])
    jcircuit = _circuit(jgkr, layers, widths[-1])
    f0 = fused.fallbacks
    for j, inputs in enumerate([_inputs(widths[-1], seed + 100), _inputs(widths[-1], seed + 200)]):
        timings = []
        t = _prove(circuit, inputs, timings)
        with jax.disable_jit():
            want = jgkr.generate_gkr_transcript(jgkr.Prover(jcircuit, JF.felts(inputs), JF), JF).to_bytes()
        assert t.to_bytes() == want, j
        names = [name for name, _, _ in timings]
        assert names == (SCAN_KEYS if j else ["prelude"] + ["phase1", "phase2"] * len(layers) + ["pull", "assemble"])
        assert _the_program(circuit).warm
    assert fused.fallbacks == f0, "a proof fell back to the per-layer path"
    assert len(circuit._fused_programs) == 1


def test_stale_zero_flag_does_not_leak():
    """A zero flag, ticket counters and chain bytes left set by hand on the
    program are reset by the next proof's bind: the same bytes as before,
    no fallback. A CUDA graph is refused off the card."""
    widths = [4, 4, 4]
    circuit = _circuit(gkr, _gate_lists(widths, 5), widths[-1])
    inputs = _inputs(widths[-1], 105)
    f0 = fused.fallbacks
    first = _prove(circuit, inputs).to_bytes()
    prog = _the_program(circuit)
    prog.zero.fill_(1)
    prog.counters.fill_(3)
    prog.chain.buf.fill_(0xAB)
    assert _prove(circuit, inputs).to_bytes() == first
    assert fused.fallbacks == f0 and _the_program(circuit) is prog
    assert int(prog.zero[0]) == 0 and int(prog.counters.abs().sum()) == 0
    with pytest.raises(ValueError):
        graphs.Graph(CPU, lambda: None)


def test_warm_proof_timings_match_jax_scan(monkeypatch):
    """A program's warm proof reports the JAX package's scan names, in its
    order. The JAX package runs its scan branch with the layer program
    replaced by zeros of the program's outputs (c_1, the phase rounds'
    coefficient limbs, p, q and the zero flags, per layer)."""
    widths = [4, 4, 4]
    layers = _gate_lists(widths, 5)
    circuit = _circuit(gkr, layers, widths[-1])
    _prove(circuit, _inputs(widths[-1], 105))
    timings = []
    _prove(circuit, _inputs(widths[-1], 205), timings)
    port = [name for name, _, _ in timings]

    def zeros_program(num_layers, k, g, field, lane_bits=8):
        u32 = jnp.uint32
        shapes = [(2,), (k, 3), (k, 3), (k, 3), (k, 3), (3,), (3,), (k + 1,), (k + 1,)]
        return lambda *args: tuple(jnp.zeros((num_layers,) + s, u32) for s in shapes) + (
            jnp.zeros((num_layers,), jnp.bool_),)

    monkeypatch.setattr(jfused, "_scan_proof_jit", zeros_program)
    jcircuit = _circuit(jgkr, layers, widths[-1])
    jtimings = []
    with jax.disable_jit():
        jfused.generate_gkr_transcript_fused(jgkr.Prover(jcircuit, JF.felts(_inputs(widths[-1], 205)), JF), JF,
                                             timings=jtimings)
    assert [name for name, _, _ in jtimings] == port == SCAN_KEYS


@pytest.mark.parametrize("field", [GOLDILOCKS, BABYBEAR], ids=["goldilocks", "babybear"])
def test_batch_program_two_dispatches_match_jax(field):
    """Two dispatches of B = 2 proofs of a 2-factor product (n = 4: rounds
    2 and 3 are the program's own) with different tables through one batch
    program; between them the program's chains and zero flags are spoiled
    by hand. Every instance byte-identical to the JAX host loop; the eager
    route gives the same messages."""
    n, batch, k = 4, 2, 2
    spec = single_block_spec(k, n)
    jfield = jfields.GOLDILOCKS if field is GOLDILOCKS else jfields.BABYBEAR
    jspec = JPolySpec(spec.block_sizes, spec.table_blocks, spec.terms)
    key = (k, n, field.name, batch, CPU)
    prog = None
    for d, seed in enumerate((61, 62)):
        vals = [np.random.default_rng(seed + 10 * i).integers(1, field.p, size=(batch, 1 << n), dtype=np.uint64)
                for i in range(k)]
        tables = [FArray.from_ints(v, field, device="cpu") for v in vals]
        if prog is not None:
            prog.state.any_zero.fill_(1)
            prog.state.chain.buf.fill_(7)
            prog.state.chain.state.fill_(-1)
        got = fs_kernel.fs_prove_device_batch(spec, tables)
        assert prog is None or fs_kernel.programs[key] is prog
        prog = fs_kernel.programs[key]
        assert fs_kernel._prove_batch(spec, tables, b"", graph=False) == got
        for b in range(batch):
            jt = [jfields.FArray.from_ints(v[b], jfield) for v in vals]
            with jax.disable_jit():
                want = jgenerate(JInteractiveProver(JProver(JProductPoly(jspec, jt))), jfield)
            assert FiatShamirTranscript(got[b]).to_bytes() == want.to_bytes(), (d, b)
