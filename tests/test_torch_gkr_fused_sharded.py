"""The port's sharded fused GKR prover against the JAX package, on the CPU.

- ``generate_gkr_transcript_fused(mesh=)`` on 8 shards of the CPU device,
  on ``make_mesh`` and on the 2 x 4 and 8 x 1 2-D meshes (2 x 4 also with
  alternating devices, ``["cpu", "cpu:0"] * 4``, a group per position:
  the reductions' and the challenge sends' cross-device path), byte for
  byte against the JAX package's unsharded ``generate_gkr_transcript`` on a
  3-layer x 16-gate random circuit (the shape of the JAX package's slow
  ``test_fused_sharded_matches_host_transcript``, which pins its own
  sharded fused bytes to the unsharded ones); the verifier accepts;
- a circuit whose small layers run replicated on the first device while
  the large ones shard, in one proof (the counterpart of the JAX
  ``test_fused_sharded_mixed_small_layers``);
- K2 over shard rows (``phase_tables_rows``) at n_shard 1 and 3 against
  the unsharded K2's tables in the sharded layout, and the kernel's walk
  of each group's plan (in the layout's order, runs longer than LONG
  split over a warp's lanes) in Python ints against those tables and
  against the JAX ``phase1_tables`` / ``phase2_tables`` laid out by the JAX
  ``shard_factor``, over Goldilocks and BabyBear;
- the round tail over a sharded round's reduced rows
  (``gkr_tail.round_tail``) against the same round run whole with the tail
  as K1's epilogue (``libra_round_tail``): bytes, chain, challenges, claim;
- the zero-flag fallback under a mesh, and a mesh size that is not a power
  of two raising ``ValueError``;
- the reductions, gathers and challenge sends of a proof against a
  prediction made from each layer's k and n_shard.

The JAX side runs eagerly under ``jax.disable_jit()`` (it compiles no JAX
program). Inputs come from numpy seeds whose serialized coefficients are
all nonzero, so the fused path runs to its end. Tolerance: exact (bytes,
field words).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu import gkr as jgkr  # noqa: E402
from thaler_study_tpu.gkr import device_tables as jdt  # noqa: E402
from thaler_study_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from thaler_study_tpu.parallel import shard_factor as jshard_factor  # noqa: E402
from thaler_study_tpu_torch import gkr  # noqa: E402
from thaler_study_tpu_torch.fields import BABYBEAR, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.gkr import device_tables as dt  # noqa: E402
from thaler_study_tpu_torch.gkr import fused  # noqa: E402
from thaler_study_tpu_torch.gkr.circuit import layer_wiring  # noqa: E402
from thaler_study_tpu_torch.ops import cuda_round, gkr_tail  # noqa: E402
from thaler_study_tpu_torch.parallel import make_mesh, make_mesh_2d, sharded  # noqa: E402

F, JF, P = GOLDILOCKS, jfields.GOLDILOCKS, GOLDILOCKS.p
_JF = {"Goldilocks": jfields.GOLDILOCKS, "BabyBear": jfields.BABYBEAR}
# 3 layers of 16 gates over 16 inputs (k = 4 > n_shard = 3: one sharded
# round per phase); the mixed circuit's layers of 2^4 (sharded), 2^2
# (replicated: 4 values do not divide over 8 shards) and 2^3 inputs
# (sharded with no sharded round: k = n_shard)
UNIFORM = ((16, 16, 16, 16), 6)
MIXED = ((4, 16, 4, 8), 4)


def _gates(widths, seed):
    rng = np.random.default_rng(seed)
    layers = [[(bool(rng.random() < 0.5), int(rng.integers(nxt)), int(rng.integers(nxt))) for _ in range(width)]
              for width, nxt in zip(widths[:-1], widths[1:])]
    inputs = [P - 1] + [int(x) for x in rng.integers(0, 1 << 62, widths[-1] - 1)]
    return layers, inputs


def _circuit(mod, layers, n_in):
    return mod.Circuit([mod.CircuitLayer([mod.Gate(mod.GateType.MUL if m else mod.GateType.ADD, (b, c))
                                          for m, b, c in layer]) for layer in layers], n_in)


def _case(case):
    widths, seed = case
    layers, inputs = _gates(widths, seed)
    return _circuit(gkr, layers, widths[-1]), layers, inputs


@functools.lru_cache(maxsize=None)
def _jax_bytes(case) -> bytes:
    widths, _ = case
    _, layers, inputs = _case(case)
    with jax.disable_jit():
        return jgkr.generate_gkr_transcript(
            jgkr.Prover(_circuit(jgkr, layers, widths[-1]), JF.felts(inputs), JF), JF).to_bytes()


def _prover(circuit, inputs):
    return gkr.Prover(circuit, F.felts(inputs), F, device="cpu")


def _reset():
    for counts in (sharded.collectives, sharded.sends):
        for key in counts:
            counts[key] = 0


def _prove(circuit, inputs, mesh):
    """The sharded fused proof, checked to have run to its end."""
    before = fused.fallbacks
    t = gkr.generate_gkr_transcript_fused(_prover(circuit, inputs), F, mesh=mesh)
    assert fused.fallbacks == before, "the fused path fell back"
    return t


@pytest.mark.parametrize("shape", ["make_mesh", "2x4", "8x1"])
def test_sharded_fused_matches_jax(shape):
    circuit, _, inputs = _case(UNIFORM)
    want = _jax_bytes(UNIFORM)
    meshes = {"make_mesh": [make_mesh(["cpu"] * 8)],
              "2x4": [make_mesh_2d(["cpu"] * 8, dcn_size=2), make_mesh_2d(["cpu", "cpu:0"] * 4, dcn_size=2)],
              "8x1": [make_mesh_2d(["cpu"] * 8, dcn_size=8)]}[shape]
    for mesh in meshes:
        t = _prove(circuit, inputs, mesh)
        assert t.to_bytes() == want, mesh
    assert gkr.verify_gkr_transcript(t, gkr.Verifier(circuit, F), F.felts(inputs), F)


def test_mixed_small_layers():
    """Layer 1 (4 values) runs replicated on the first device, layers 0 and
    2 shard (layer 2 with k = n_shard: K2 over shard rows, then the gather
    before any round), in one proof."""
    circuit, _, inputs = _case(MIXED)
    mesh = make_mesh(["cpu"] * 8)
    _reset()
    t = _prove(circuit, inputs, mesh)
    assert t.to_bytes() == _jax_bytes(MIXED)
    # layer 0 reduces once per phase, layer 2 never; 6 gathers per sharded layer
    assert sharded.collectives["reduce"] == 2 and sharded.collectives["gather"] == 12


LONG = 32  # csrc/phase_tables.cu LONG: a longer run is walked by its warp's 32 lanes


def _plan_walk(phase, wiring, eq_r, table, k, n_shard, row0, rows):
    """The kernel's walk over the group's plan in Python ints: thread pos
    sums the run of plan position pos and writes word pos; a run of more
    than LONG gates is split over the warp's 32 lanes (lane l every 32nd
    gate from the l-th), each lane's sums reduced, then added. Checks the
    plan's shape on the way: the group's gates, each once, ascending
    within a run. Returns the two [rows, cols] tables."""
    p = eq_r.field.p
    plan = wiring.plan(phase, n_shard, row0, rows)
    starts, order, packed = (plan.starts.tolist(), plan.order.tolist(), plan.packed.tolist())
    e, v = [int(x) for x in eq_r.to_u64()], [int(x) for x in table.to_u64()]
    cols = 1 << (k - n_shard)
    key = (wiring.b if phase == 1 else wiring.c).tolist()
    mask = (1 << n_shard) - 1
    pos_of = [int(format(x, f"0{k}b")[::-1], 2) for x in key]  # the MSB-first position of each gate's cell
    group = [g for g, x in enumerate(pos_of) if row0 <= x & mask < row0 + rows]
    assert len(starts) == rows * cols + 1 and starts[0] == 0 and sorted(order) == group
    out = np.zeros((2, rows * cols), dtype=object)
    for pos in range(rows * cols):
        s0, s1 = starts[pos], starts[pos + 1]
        run = order[s0:s1]
        assert run == sorted(run) and all(pos_of[g] == (pos % cols) << n_shard | (row0 + pos // cols) for g in run)
        lanes = [range(s0, s1)] if s1 - s0 <= LONG else [range(s0 + lane, s1, 32) for lane in range(32)]
        for walk in lanes:
            acc = [0, 0]
            for s in walk:
                g, w = order[s], packed[s]
                mul, x = w < 0, e[g] * v[w & 0x7FFFFFFF]
                if phase == 1:
                    acc[0] += x if mul else e[g]
                    acc[1] += 0 if mul else x
                else:
                    acc[0] += 0 if mul else x
                    acc[1] += x if mul else 0
            out[0, pos] += acc[0] % p
            out[1, pos] += acc[1] % p
    return (out % p).reshape(2, rows, cols)


def _groups(n_shard):
    """Groups of shard rows as a mesh gives them to a device: all rows, one
    row at row0 = 1, the last two, and 4 rows from row0 = 3."""
    shards = 1 << n_shard
    return [(0, shards), (1, 1), (shards - 2, 2)] + ([(3, 4)] if shards >= 8 else [])


def _skewed_wiring(rng, k, skew):
    g = 1 << k
    b, c = rng.integers(0, 1 << k, g), rng.integers(0, 1 << k, g)
    if skew:  # 40 gates on one cell of each key: runs longer than LONG
        b[:40] = 5
        c[g - 40 :] = 9
    mul = rng.random(g) < 0.5
    return b, c, mul, layer_wiring(torch.from_numpy(b.astype(np.int32)), torch.from_numpy(c.astype(np.int32)),
                                   torch.from_numpy(mul), k)


def test_phase_tables_over_shard_rows():
    """At n_shard 1 and 3, both phases, every group of rows a mesh gives a
    device (all rows, one row, the last two, 4 from row 3): the unsharded
    K2's tables in the layout and the kernel's walk of the group's plan; a
    skewed wiring (40 gates on one cell: the warp's walk) and a k = n_shard
    layer."""
    rng = np.random.default_rng(61)
    for k, n_shard, skew in ((6, 1, False), (6, 3, True), (5, 3, False), (3, 3, False)):
        g = 1 << k
        _, _, _, wiring = _skewed_wiring(rng, k, skew)
        eq_r = FArray.from_ints(rng.integers(0, P, g, dtype=np.uint64), F, device="cpu")
        table = FArray.from_ints(rng.integers(0, P, 1 << k, dtype=np.uint64), F, device="cpu")
        cols = 1 << (k - n_shard)
        for phase in (1, 2):
            whole = dt.phase_tables(phase, wiring, eq_r, table, k)
            for row0, rows in _groups(n_shard):
                got = dt.phase_tables_rows(phase, wiring, eq_r, table, k, n_shard, row0, rows)
                walk = _plan_walk(phase, wiring, eq_r, table, k, n_shard, row0, rows)
                for t, x, want in zip(range(2), got, whole):
                    assert x.shape == (rows, cols)
                    lay = want.data.reshape(cols, 1 << n_shard)[:, row0 : row0 + rows].T
                    assert torch.equal(x.data, lay), (k, n_shard, phase, row0, rows)
                    assert x.to_u64().astype(object).tolist() == walk[t].tolist(), (k, n_shard, phase, row0)
    with pytest.raises(ValueError, match="shard rows"):
        dt.phase_tables_rows(1, wiring, eq_r, table, 3, 3, 7, 2)
    with pytest.raises(ValueError, match="shard rows"):
        wiring.plan(1, 3, 7, 2)


@pytest.mark.parametrize("field", [GOLDILOCKS, BABYBEAR], ids=lambda f: f.name)
def test_layout_plans_match_jax(field):
    """The kernel's walk of each group's plan (``_plan_walk``) and K2's
    rows form on the CPU against the JAX package's ``phase1_tables`` /
    ``phase2_tables`` (the scan mode) laid out by the JAX ``shard_factor``:
    n_shard 1 and 3, the groups of ``_groups``, a skewed wiring whose hot
    cells take 40 gates (more than LONG) and a k = n_shard layer; eq_r, the
    gathered W and eq_u with p - 1 among their words."""
    rng = np.random.default_rng(71 if field is GOLDILOCKS else 72)
    p, jf = field.p, _JF[field.name]
    mesh1 = jmake_mesh(jax.devices()[:1])
    for k, shards in ((6, (1, 3)), (3, (3,))):
        b, c, mul, wiring = _skewed_wiring(rng, k, k == 6)
        r_ints = [p - 1] + [int(x) for x in rng.integers(0, p, k - 1, dtype=np.uint64)]
        u_ints = [int(x) for x in rng.integers(0, p, k - 1, dtype=np.uint64)] + [p - 1]
        w_ints = [p - 1] + [int(x) for x in rng.integers(0, p, (1 << k) - 1, dtype=np.uint64)]
        port = {name: FArray.from_ints(np.array(x, dtype=np.uint64), field, device="cpu")
                for name, x in (("r", r_ints), ("u", u_ints), ("w", w_ints))}
        eq_r, eq_u = dt.eq_table_dev(port["r"], k), dt.eq_table_dev(port["u"], k)
        jb, jc, jm = jnp.asarray(b.astype(np.int32)), jnp.asarray(c.astype(np.int32)), jnp.asarray(mul)
        with jax.disable_jit():
            jr, ju, jw = (jfields.FArray.from_ints(np.array(x, dtype=object), jf) for x in (r_ints, u_ints, w_ints))
            b_scan = tuple(jnp.asarray(x) for x in jdt.scan_plan(b, 1 << k))
            c_scan = tuple(jnp.asarray(x) for x in jdt.scan_plan(c, 1 << k))
            ja1, ja2, jeq = jdt.phase1_tables(jr, jw, jb, jc, jm, k, k, lane_bits=16, b_scan=b_scan)
            jb1, jb2, _ = jdt.phase2_tables(ju, jw, jeq, jb, jc, jm, k, lane_bits=16, c_scan=c_scan)
            msb = [jdt.lsb_to_msb(t, k) for t in (ja1, ja2, jb1, jb2)]
            layouts = {n: [np.asarray(jshard_factor(t, mesh1, n).to_ints(), dtype=object) for t in msb]
                       for n in shards}
        assert eq_r.to_u64().astype(object).tolist() == np.asarray(jeq.to_ints(), dtype=object).tolist()
        for n_shard in shards:
            for phase, table in ((1, port["w"]), (2, eq_u)):
                want = layouts[n_shard][2 * (phase - 1) : 2 * phase]
                for row0, rows in _groups(n_shard):
                    walk = _plan_walk(phase, wiring, eq_r, table, k, n_shard, row0, rows)
                    got = dt.phase_tables_rows(phase, wiring, eq_r, table, k, n_shard, row0, rows)
                    for t in range(2):
                        lay = want[t][row0 : row0 + rows].tolist()
                        assert walk[t].tolist() == lay, (field.name, k, n_shard, phase, row0, rows)
                        assert got[t].to_u64().astype(object).tolist() == lay, (field.name, k, n_shard, phase, row0)


def test_round_tail_over_rows_matches_the_epilogue():
    """A round run whole with the tail as K1's epilogue against the same
    round over 8 shard rows (K1's no-claim sums per row, the reduction,
    the standalone tail), at every 4th fill of the chain's block through
    StartSumCheck, a folded round of either phase and two draws."""
    rng = np.random.default_rng(67)
    mesh = make_mesh(["cpu"] * 8)
    for fill in range(0, 64, 4):
        kind = ("start", "plain", "two draws")[fill % 3]
        phase = 1 if kind == "start" or fill % 8 else 2
        prefix = rng.integers(0, 256, 64 * (1 + fill % 3) + fill, dtype=np.uint8).tobytes()
        vals = [FArray.from_ints(rng.integers(0, P, 64, dtype=np.uint64), F, device="cpu").data for _ in range(3)]
        scalars = [] if phase == 1 else [FArray.from_ints([int(rng.integers(0, P, dtype=np.uint64))], F, device="cpu").data]
        fold = kind != "start"
        r = FArray.from_ints([int(rng.integers(0, P, dtype=np.uint64))], F, device="cpu").data if fold else None
        claim_in = int(rng.integers(0, P, dtype=np.uint64))
        k, draws = 6, 2 if kind == "two draws" else 1
        idx = 2 * k - 3 if draws == 2 else fill % k
        start = (fill, k) if kind == "start" else None
        tails = []
        for _ in range(2):
            tails.append(gkr_tail.LayerTail(
                gkr_tail.prefix_chain(prefix, "cpu"), torch.zeros(120, dtype=torch.uint8),
                torch.zeros(1, dtype=torch.int32), FArray.from_ints([claim_in], F, device="cpu").data,
                torch.zeros(2 * k, dtype=torch.int64), torch.zeros(1, dtype=torch.int32)))
        gkr_tail.libra_round_tail([v.reshape(1, -1) for v in vals], r, fold, phase, scalars,
                                  gkr_tail.RoundTail(tails[0], 3, idx, draws, start))
        # the sharded layout: row = the last 3 variables
        rows = [v.reshape(8, 8).T.contiguous() for v in vals]
        terms = cuda_round.LIBRA_PHASE1 if phase == 1 else cuda_round.LIBRA_PHASE2
        _, s = cuda_round.libra_round_sums(rows, None if r is None else r.expand(8).contiguous(), fold, None, F,
                                           terms, [x.expand(8).contiguous() for x in scalars])
        assert not fold or not s[:, 1].any()  # s(1) left out per row
        gkr_tail.round_tail(sharded.collective(mesh, "sum", [s], F), gkr_tail.RoundTail(tails[1], 3, idx, draws, start))
        a, b = tails
        assert a.chain.nbytes == b.chain.nbytes
        for x, y in ((a.chain.state, b.chain.state), (a.chain.buf, b.chain.buf), (a.msgs, b.msgs),
                     (a.chal, b.chal), (a.claim, b.claim), (a.zero, b.zero)):
            assert torch.equal(x, y), (fill, kind, phase)


def test_zero_flag_and_bad_mesh_under_a_mesh(monkeypatch):
    """A flagged zero coefficient in a sharded round's tail redoes the proof
    on the per-layer path (counted in ``fallbacks``); a mesh of 6 raises."""
    circuit, _, inputs = _case(UNIFORM)
    plain = gkr_tail.round_tail_plain

    def flagged(*args, **kwargs):
        plain(*args, **kwargs)
        args[4][0] = 1  # zero

    monkeypatch.setattr(gkr_tail, "round_tail_plain", flagged)
    before = fused.fallbacks
    t = gkr.generate_gkr_transcript_fused(_prover(circuit, inputs), F, mesh=make_mesh(["cpu"] * 8))
    assert fused.fallbacks == before + 1
    assert t.to_bytes() == gkr.generate_gkr_transcript(_prover(circuit, inputs), F).to_bytes()
    with pytest.raises(ValueError, match="mesh size 6"):
        gkr.generate_gkr_transcript_fused(_prover(circuit, inputs), F, mesh=make_mesh(["cpu"] * 6))


def test_collectives_and_sends_match_the_prediction():
    """Per sharded layer (k >= n_shard, L = k - n_shard): 2L reductions (one
    per sharded round), 6 gathers (each table's residual columns: 2 x
    2^n_shard words, 2^n_shard when L = 0), and 2 + 2 max(L - 1, 0) sends
    (r_i, u, the challenges the next sharded fold reads); replicated layers
    none.
    On 8 shards of one device a reduction and a send move no word; with
    alternating devices each reduction moves 3 words per group on the other
    device, each send its words once (one other device)."""
    widths = [32, 64, 16, 32]
    layers, inputs = _gates(widths, 9)
    circuit = _circuit(gkr, layers, widths[-1])
    ks = [circuit.num_vars_at(i + 1) for i in range(len(layers))]
    for n_shard, devices in ((3, ["cpu"] * 8), (1, ["cpu"] * 2), (3, ["cpu", "cpu:0"] * 4)):
        others = 4 if "cpu:0" in devices else 0
        sh = [k for k in ks if k >= n_shard]
        local = [k - n_shard for k in sh]
        reduce = sum(2 * m for m in local)
        gather_words = sum(6 * (2 if m else 1) << n_shard for m in local)
        sends = sum(2 + 2 * max(m - 1, 0) for m in local)
        # words off the first device per send: r_i (k_cur), u (k), one per challenge
        k_cur = {circuit.num_vars_at(i + 1): circuit.num_vars_at(i) for i in range(len(layers))}
        send_words = sum(k_cur[k] + k + 2 * max(k - n_shard - 1, 0) for k in sh) if others else 0
        _reset()
        t = _prove(circuit, inputs, make_mesh(devices))
        assert t.to_bytes() == gkr.generate_gkr_transcript(_prover(circuit, inputs), F).to_bytes()
        assert sharded.collectives == {"reduce": reduce, "reduce_words": others * 3 * reduce, "gather": 6 * len(sh),
                                       "gather_words": gather_words}, devices
        assert sharded.sends == {"send": sends, "send_words": send_words}, devices
