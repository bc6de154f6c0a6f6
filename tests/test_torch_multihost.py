"""The port's multi-process meshes (``thaler_study_tpu_torch/parallel``)
against the JAX package, on the CPU.

- ``make_mesh_2d`` shapes (1 x 8, 2 x 4, 8 x 1) against the JAX package's,
  ``mesh_axis_spec``, ``init_distributed``'s arguments;
- the same bytes on every mesh shape: ``fs_prove_device_sharded`` and the
  per-round ``ShardedProductPoly`` over a 2-factor product (n = 6), the
  per-round ``ShardedBlockPoly`` and ``generate_transcript_device(mesh=)``
  over a 2-block spec, on 8 shards of the CPU device, and on 2 x 4 with
  alternating devices (one group per position: the reduction's
  cross-device path);
- the sharded per-layer GKR prover (``gkr.Prover(mesh=)``) and
  ``api.run_gkr(mesh=, n_shard=)`` against the JAX package's unsharded
  ``generate_gkr_transcript`` and ``run_gkr`` (BabyBear, 2 layers of 16
  gates);
- the collective contract (the port's counterpart of the JAX
  ``test_sharded_fused_collective_contract``): one exact reduction per
  sharded round, which sends D + 1 words off each device but the first
  and across processes, one gather of 2^n_shard words per sharded table at
  the transition, nothing table-sized moved;
- two ``gloo`` processes on a 2 x 4 mesh (one DCN row each): the round
  sums' all-reduce across processes gives the JAX bytes computed in the
  parent, and the sharded fused GKR prover the parent's unsharded bytes;
  the spawn, rendezvous and proofs have one 60 s deadline.

The JAX side runs its unsharded prover eagerly under ``jax.disable_jit()``
(its own tests pin its sharded transcripts to the unsharded ones). Inputs
come from numpy seeds. Tolerance: exact (transcript bytes, field values).
"""

import functools
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import api as japi  # noqa: E402
from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu import gkr as jgkr  # noqa: E402
from thaler_study_tpu.fiat_shamir import SumcheckInteractiveProver as JInteractiveProver  # noqa: E402
from thaler_study_tpu.fiat_shamir import generate_transcript as jgenerate  # noqa: E402
from thaler_study_tpu.ops.round_kernel import PolySpec as JPolySpec  # noqa: E402
from thaler_study_tpu.parallel import make_mesh_2d as jmake_mesh_2d  # noqa: E402
from thaler_study_tpu.protocols import ProductPoly as JProductPoly  # noqa: E402
from thaler_study_tpu.sumcheck import Prover as JProver  # noqa: E402
from thaler_study_tpu_torch import api, gkr  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import (  # noqa: E402
    FiatShamirTranscript,
    SumcheckInteractiveProver,
    generate_transcript,
    generate_transcript_device,
)
from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.ops import fs_kernel  # noqa: E402
from thaler_study_tpu_torch.ops.round_kernel import PolySpec, single_block_spec  # noqa: E402
from thaler_study_tpu_torch.parallel import (  # noqa: E402
    DCN_AXIS,
    ICI_AXIS,
    ShardedBlockPoly,
    ShardedProductPoly,
    init_distributed,
    make_mesh_2d,
    mesh_axis_spec,
    sharded,
)
from thaler_study_tpu_torch.protocols import ProductPoly  # noqa: E402
from thaler_study_tpu_torch.sumcheck import Prover  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SEED = 6, 11
# two layers of 16 gates: 8 shards need n_shard 3 < k variables (the JAX
# side's eager GKR costs ~20 s cold here, most of it first compiles)
WIDTHS = [16, 16, 16]


def _values():
    rng = np.random.default_rng(SEED)
    return [rng.integers(1, GOLDILOCKS.p, size=1 << N, dtype=np.uint64) for _ in range(2)]


def _tables():
    return [FArray.from_ints(v, GOLDILOCKS, device="cpu") for v in _values()]


@functools.lru_cache(maxsize=None)
def _jax_bytes() -> bytes:
    """The JAX package's unsharded host loop over the product's tables."""
    tabs = [jfields.FArray.from_ints(np.array([int(x) for x in v], dtype=object), jfields.GOLDILOCKS)
            for v in _values()]
    spec = JPolySpec((N,), ((0,), (0,)), ((0, 1),))
    with jax.disable_jit():
        return jgenerate(JInteractiveProver(JProver(JProductPoly(spec, tabs))), jfields.GOLDILOCKS).to_bytes()


# a 2-block spec with a replicated-only term and its last block sharded
# whole (the 8th draw of the JAX fuzz's procedure, as in
# tests/test_torch_parallel.py)
BLOCK_SPEC = ((1, 3), ((0,), (1,)), ((0, 1), (0,)))


def _block_values():
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(1, GOLDILOCKS.p, size=1 << sum(BLOCK_SPEC[0][b] for b in tb), dtype=np.uint64)
            for tb in BLOCK_SPEC[1]]


@functools.lru_cache(maxsize=None)
def _jax_block_bytes() -> bytes:
    tabs = [jfields.FArray.from_ints(np.array([int(x) for x in v], dtype=object), jfields.GOLDILOCKS)
            for v in _block_values()]
    with jax.disable_jit():
        poly = JProductPoly(JPolySpec(*BLOCK_SPEC), tabs)
        return jgenerate(JInteractiveProver(JProver(poly)), jfields.GOLDILOCKS).to_bytes()


def _reset():
    for key in sharded.collectives:
        sharded.collectives[key] = 0


def test_make_mesh_2d_shapes():
    """The JAX package's shapes and axes; a split that does not divide and
    half-given init arguments raise; one process without a group is an
    emulated mesh."""
    for dcn in (1, 2, 8):
        mesh = make_mesh_2d(["cpu"] * 8, dcn_size=dcn)
        jmesh = jmake_mesh_2d(jax.devices()[:8], dcn_size=dcn)
        assert mesh.devices.shape == jmesh.devices.shape == (dcn, 8 // dcn)
        assert mesh.axis_names == tuple(jmesh.axis_names) == (DCN_AXIS, ICI_AXIS)
        assert mesh_axis_spec(mesh) == (DCN_AXIS, ICI_AXIS) and mesh.group is None
        assert list(mesh.local_positions()) == list(range(8))
    assert make_mesh_2d(["cpu"] * 8).devices.shape == (1, 8)
    with pytest.raises(ValueError, match="do not split"):
        make_mesh_2d(["cpu"] * 8, dcn_size=3)
    with pytest.raises(ValueError, match="together"):
        init_distributed("localhost:1", num_processes=2)


@pytest.mark.parametrize("dcn", [1, 2, 8], ids=["1x8", "2x4", "8x1"])
def test_transcript_identical_across_mesh_shapes(dcn):
    """The sharded device proof and the per-round loop give the JAX bytes
    on every mesh shape, for the product (``ShardedProductPoly``) and a
    2-block spec (``ShardedBlockPoly``, ``generate_transcript_device(mesh=)``);
    on 2 x 4 also with alternating devices (a group per position, so each
    round's rows cross devices)."""
    want, want_block = _jax_bytes(), _jax_block_bytes()
    tables = _tables()
    block_spec = PolySpec(*BLOCK_SPEC)
    block_tables = [FArray.from_ints(v, GOLDILOCKS, device="cpu") for v in _block_values()]
    meshes = [make_mesh_2d(["cpu"] * 8, dcn_size=dcn)]
    if dcn == 2:
        meshes.append(make_mesh_2d(["cpu", "cpu:0"] * 4, dcn_size=2))
    for mesh in meshes:
        msgs = fs_kernel.fs_prove_device_sharded(single_block_spec(2, N), tables, mesh, n_shard=3)
        assert FiatShamirTranscript(msgs).to_bytes() == want
        poly = ShardedProductPoly.from_internal_tables(tables, mesh, n_shard=3)
        assert generate_transcript(SumcheckInteractiveProver(Prover(poly)), GOLDILOCKS).to_bytes() == want
        block = ShardedBlockPoly.from_internal_tables(block_spec, block_tables, mesh, n_shard=3)
        assert block.has_shard == (False, True)
        assert generate_transcript(SumcheckInteractiveProver(Prover(block)), GOLDILOCKS).to_bytes() == want_block
        device = generate_transcript_device(ProductPoly(block_spec, block_tables), GOLDILOCKS, mesh=mesh)
        assert device.to_bytes() == want_block


def _circuit(mod):
    rng = np.random.default_rng(41)
    layers = [[(bool(rng.random() < 0.5), int(rng.integers(WIDTHS[i + 1])), int(rng.integers(WIDTHS[i + 1])))
               for _ in range(WIDTHS[i])] for i in range(len(WIDTHS) - 1)]
    return mod.Circuit([mod.CircuitLayer([mod.Gate(mod.GateType.MUL if m else mod.GateType.ADD, (b, c))
                                          for m, b, c in layer]) for layer in layers], WIDTHS[-1])


def test_sharded_gkr_matches_jax():
    """The per-layer GKR prover with mesh= (LibraW's phases sharded, the
    round kernel's LibraW shapes over the shard rows) and
    ``api.run_gkr(mesh=, n_shard=)``: the JAX package's unsharded bytes,
    outputs and decision, on 1 x 8, 2 x 4 and 8 x 1, over BabyBear (the mont32
    path; the card runs the Goldilocks and BabyBear flagships sharded)."""
    field, jf = BABYBEAR, jfields.BABYBEAR
    inputs = [int(x) for x in np.random.default_rng(42).integers(0, field.p, WIDTHS[-1])]
    with jax.disable_jit():
        want = jgkr.generate_gkr_transcript(jgkr.Prover(_circuit(jgkr), jf.felts(inputs), jf), jf).to_bytes()
        jouts, jok = japi.run_gkr(_circuit(jgkr), inputs, jf, seed=4)
    circuit = _circuit(gkr)
    for dcn in (1, 2, 8):
        mesh = make_mesh_2d(["cpu"] * 8, dcn_size=dcn)
        prover = gkr.Prover(circuit, field.felts(inputs), field, mesh=mesh, n_shard=3, device="cpu")
        assert gkr.generate_gkr_transcript(prover, field).to_bytes() == want, dcn
    outs, ok = api.run_gkr(circuit, inputs, field, seed=4, mesh=mesh, n_shard=3, device="cpu")
    assert ok and jok and [f.v for f in outs] == [f.v for f in jouts]


def test_sharded_fs_collective_contract():
    """One exact reduction per sharded round (n - n_shard of them), one
    gather of 2^n_shard words per sharded table at the transition, nothing
    else: the JAX package's lowered-HLO contract
    (tests/test_multihost.py::test_sharded_fused_collective_contract:
    n - n_shard all-reduces of scalars, #tables x #limbs all-gathers of
    2^n_shard). A reduction sends the round's D + 1 sums off each device
    but the first, and nothing off the first: 0 words where every shard is
    on one device, 4 (D + 1) where 4 of 8 positions lie on another. The
    per-round class issues the same, plus c_1's reduction."""
    tables, want = _tables(), _jax_bytes()
    for devices, others in ((["cpu"] * 8, 0), (["cpu", "cpu:0"] * 4, 4)):
        mesh = make_mesh_2d(devices, dcn_size=2)
        _reset()
        msgs = fs_kernel.fs_prove_device_sharded(single_block_spec(2, N), tables, mesh, n_shard=3)
        assert FiatShamirTranscript(msgs).to_bytes() == want
        assert sharded.collectives == {"reduce": N - 3, "reduce_words": others * 3 * (N - 3), "gather": 2,
                                       "gather_words": 16}, devices
        _reset()
        poly = ShardedProductPoly.from_internal_tables(tables, mesh, n_shard=3)
        assert generate_transcript(SumcheckInteractiveProver(Prover(poly)), GOLDILOCKS).to_bytes() == want
        assert sharded.collectives == {"reduce": N - 3 + 1, "reduce_words": others * (3 * (N - 3) + 2),
                                       "gather": 2, "gather_words": 16}, devices


WORKER = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from thaler_study_tpu_torch.fields import GOLDILOCKS, FArray
from thaler_study_tpu_torch.fiat_shamir import FiatShamirTranscript, SumcheckInteractiveProver, generate_transcript
from thaler_study_tpu_torch.ops import fs_kernel
from thaler_study_tpu_torch.ops.round_kernel import single_block_spec
from thaler_study_tpu_torch.parallel import ShardedProductPoly, init_distributed, make_mesh_2d, sharded
from thaler_study_tpu_torch.sumcheck import Prover
import torch.distributed as dist

address, rank, data, out, gkr_data = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
init_distributed(address, 2, rank)
mesh = make_mesh_2d(["cpu"] * 4)
vals = np.load(data)
tables = [FArray.from_ints(vals[k], GOLDILOCKS, device="cpu") for k in range(2)]
msgs = fs_kernel.fs_prove_device_sharded(single_block_spec(2, vals.shape[1].bit_length() - 1), tables, mesh, n_shard=3)
poly = ShardedProductPoly.from_internal_tables(tables, mesh, n_shard=3)
rounds = generate_transcript(SumcheckInteractiveProver(Prover(poly)), GOLDILOCKS)
fs_collectives = dict(sharded.collectives)
# the sharded fused GKR prover over the same mesh
from thaler_study_tpu_torch import gkr
from thaler_study_tpu_torch.gkr import fused
spec = json.load(open(gkr_data))
circuit = gkr.Circuit([gkr.CircuitLayer([gkr.Gate(gkr.GateType.MUL if m else gkr.GateType.ADD, (b, c))
                                         for m, b, c in layer]) for layer in spec["layers"]], spec["n_in"])
for counts in (sharded.collectives, sharded.sends):
    for key in counts:
        counts[key] = 0
before = fused.fallbacks
t = gkr.generate_gkr_transcript_fused(gkr.Prover(circuit, GOLDILOCKS.felts(spec["inputs"]), GOLDILOCKS, device="cpu"),
                                      GOLDILOCKS, mesh=mesh)
json.dump({"device": FiatShamirTranscript(msgs).to_bytes().hex(), "rounds": rounds.to_bytes().hex(),
           "shape": list(mesh.devices.shape), "rows": [list(g[1:]) for g in mesh.layout(8)],
           "collectives": fs_collectives, "gkr": t.to_bytes().hex(), "gkr_fallbacks": fused.fallbacks - before,
           "gkr_collectives": sharded.collectives, "gkr_sends": sharded.sends}, open(out, "w"))
dist.destroy_process_group()
"""


def test_two_gloo_processes(tmp_path):
    """Two processes, one DCN row of 4 each (2 x 4): each holds shard rows
    4 rank .. 4 rank + 3, reduces its rows, and one all_reduce of 32-bit
    lanes per sharded round sums the two; both processes write the JAX
    package's bytes. Then the sharded fused GKR prover over the same mesh
    on a Goldilocks circuit of two 16-gate layers: both processes write the
    bytes of the port's unsharded per-layer prover (held against the JAX
    package by tests/test_torch_gkr.py), with one all_reduce per sharded
    round and the residual tables all-gathered. The spawn, the rendezvous
    and the proofs fail the test after 60 s in all rather than hang the
    suite."""
    want = _jax_bytes()
    data = tmp_path / "tables.npy"
    np.save(data, np.stack(_values()))
    rng = np.random.default_rng(43)
    layers = [[(bool(rng.random() < 0.5), int(rng.integers(WIDTHS[i + 1])), int(rng.integers(WIDTHS[i + 1])))
               for _ in range(WIDTHS[i])] for i in range(len(WIDTHS) - 1)]
    gkr_inputs = [int(x) for x in rng.integers(0, 1 << 62, WIDTHS[-1])]
    gkr_data = tmp_path / "gkr.json"
    gkr_data.write_text(json.dumps({"layers": layers, "n_in": WIDTHS[-1], "inputs": gkr_inputs}))
    circuit = gkr.Circuit([gkr.CircuitLayer([gkr.Gate(gkr.GateType.MUL if m else gkr.GateType.ADD, (b, c))
                                             for m, b, c in layer]) for layer in layers], WIDTHS[-1])
    want_gkr = gkr.generate_gkr_transcript(
        gkr.Prover(circuit, GOLDILOCKS.felts(gkr_inputs), GOLDILOCKS, device="cpu"), GOLDILOCKS).to_bytes()
    with socket.socket() as s:  # a free port on this machine's loopback
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, f"tcp://127.0.0.1:{port}", str(r), str(data), str(outs[r]),
                               str(gkr_data)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + 60  # one deadline for the spawn, the rendezvous and both proofs
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}: {log[-2000:]}"
    for r, out in enumerate(outs):
        got = json.loads(out.read_text())
        assert bytes.fromhex(got["device"]) == want and bytes.fromhex(got["rounds"]) == want, r
        assert got["shape"] == [2, 4] and got["rows"] == [[4 * r, 4]], got
        # two proofs: 2^3 words per table gathered; the only words off this
        # process's one device are the all_reduce's D + 1 per reduction
        assert got["collectives"] == {"reduce": 2 * (N - 3) + 1, "reduce_words": 6 * (N - 3) + 2, "gather": 4,
                                      "gather_words": 2 * 16}, got
        # two layers of k = 4 over n_shard 3: one sharded round per phase,
        # each an all_reduce of 3 words; 6 gathers of 2 x 8 words per layer;
        # r_i and u sent per layer to no other device of the process
        assert bytes.fromhex(got["gkr"]) == want_gkr and got["gkr_fallbacks"] == 0, r
        assert got["gkr_collectives"] == {"reduce": 4, "reduce_words": 12, "gather": 12, "gather_words": 192}, got
        assert got["gkr_sends"] == {"send": 4, "send_words": 0}, got
