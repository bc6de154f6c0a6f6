"""The port's fused GKR prover against the JAX package, on the CPU.

- ``generate_gkr_transcript_fused`` with ``device="cpu"`` (the plain
  versions of K1, K2, the eq table, the line restriction and the GKR
  tails) byte for byte against the JAX package's host
  ``generate_gkr_transcript`` on a mixed-width Goldilocks circuit (widths
  4, 8, 4: k_cur != k in both layers); the verifier accepts it and rejects
  one tampered message of each kind;
- the same against the port's per-layer ``generate_gkr_transcript`` (held
  against JAX by ``tests/test_torch_gkr.py``) on a uniform circuit of width
  2^5;
- routing as the JAX ``supports_fused_gkr`` (F389, k = 1 layers, a
  non-empty DST), the per-layer transcript for each, ``mesh=`` raising, and
  a forced zero flag giving the per-layer transcript, each counted in
  ``fallbacks``;
- ``eq_table_plain``, ``eq_table_dot`` and ``line_restrict_coeffs_plain``
  (and the wrappers, which take them for CPU tensors, the line
  restriction in both forms) against the JAX ``eq_table_dev``,
  ``dot_mod`` and ``line_restrict_coeffs`` at k = 0..6, random values and
  every value p - 1 (the JAX side at 6 variables, the case embedded);
- K1 and the round tail as one call (``gkr_tail.libra_round_tail``, the
  composition the kernel's epilogue runs) at every buffer fill against
  Python-int round sums and the JAX package's codec and chain;
- the plain round tail and final tail at every buffer fill 0..63 against
  the JAX package's pure-Python host code: its message codec, its
  challenge chain and its polynomials (bytes, chain state, challenges,
  next claim, r_{i+1}), with the JAX ``_interp_coeffs`` run eagerly at one
  fill; and the native SHA-256 midstate against the JAX package's.

The JAX side runs eagerly under ``jax.disable_jit()`` (its fused path,
which compiles, is never called). The circuits' seeds are ones whose
serialized coefficients are all nonzero, so that the fused path runs to
its end (a small circuit's sparse wiring often makes a round coefficient
zero, which routes the proof to the per-layer path by design; the
zero-flag case checks that route). Tolerance: exact (bytes, field values).
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``.

Cases loop inside a few test functions on purpose: the suite runs under
pytest-xdist ``--dist loadfile``, which starts files with more cases first.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu import gkr as jgkr  # noqa: E402
from thaler_study_tpu import runtime as jruntime  # noqa: E402
from thaler_study_tpu.fiat_shamir.hash_to_field import XmdChain as JXmdChain  # noqa: E402
from thaler_study_tpu.gkr import device_tables as jdt  # noqa: E402
from thaler_study_tpu.gkr import fused as jfused  # noqa: E402
from thaler_study_tpu.ops.fs_kernel import _interp_coeffs as j_interp_coeffs  # noqa: E402
from thaler_study_tpu.sumcheck.univariate import UniPoly as JUniPoly  # noqa: E402
from thaler_study_tpu.sumcheck.univariate import lagrange_interpolate  # noqa: E402
from thaler_study_tpu_torch import gkr, runtime  # noqa: E402
from thaler_study_tpu_torch.fiat_shamir import SerializationError  # noqa: E402
from thaler_study_tpu_torch.fields import F389, GOLDILOCKS, FArray  # noqa: E402
from thaler_study_tpu_torch.gkr import device_tables as dt  # noqa: E402
from thaler_study_tpu_torch.gkr import fused  # noqa: E402
from thaler_study_tpu_torch.ops import gkr_tail  # noqa: E402
from thaler_study_tpu_torch.sumcheck import SumCheckError  # noqa: E402

F = GOLDILOCKS
JF = jfields.GOLDILOCKS
P = F.p


def _gate_lists(widths, seed):
    """[(is_mul, b, c) per gate] per layer, output layer first (as in
    tests/test_torch_gkr.py)."""
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


def _case(widths, seed, field=F):
    rng = np.random.default_rng(seed + 100)
    inputs = [field.p - 1] + [int(x) for x in rng.integers(0, min(field.p, 1 << 62), widths[-1] - 1)]
    return _gate_lists(widths, seed), widths[-1], inputs


def _prover(circuit, inputs, field=F):
    return gkr.Prover(circuit, field.felts(inputs), field, device="cpu")


def _accepts(t, circuit, inputs, field=F) -> bool:
    try:
        return gkr.verify_gkr_transcript(t, gkr.Verifier(circuit, field), field.felts(inputs), field)
    except (gkr.GKRError, SumCheckError, SerializationError, ValueError):
        return False


def test_fused_matches_jax_on_mixed_widths():
    layers, n_in, inputs = _case([4, 8, 4], 30)
    circuit = _circuit(gkr, layers, n_in)
    assert [circuit.num_vars_at(i) for i in range(3)] == [2, 3, 2]
    before = fused.fallbacks
    t = gkr.generate_gkr_transcript_fused(_prover(circuit, inputs), F)
    assert fused.fallbacks == before, "the fused path fell back"
    jcircuit = _circuit(jgkr, layers, n_in)
    with jax.disable_jit():
        want = jgkr.generate_gkr_transcript(jgkr.Prover(jcircuit, JF.felts(inputs), JF), JF).to_bytes()
    assert t.to_bytes() == want
    assert _accepts(t, circuit, inputs)
    kinds = {}
    for i, m in enumerate(t.g):
        kinds.setdefault(m[0], i)
    assert sorted(kinds) == [0, 1, 2, 3]
    for i in kinds.values():
        bad = [bytearray(m) for m in t.g]
        bad[i][-1] ^= 1
        assert not _accepts(gkr.GKRTranscript([bytes(m) for m in bad]), circuit, inputs), i


def test_fused_matches_per_layer_path_at_width_32():
    layers, n_in, inputs = _case([32, 32, 32, 32], 31)
    circuit = _circuit(gkr, layers, n_in)
    before = fused.fallbacks
    timings = []
    t = gkr.generate_gkr_transcript_fused(_prover(circuit, inputs), F, timings=timings)
    assert fused.fallbacks == before
    assert t.to_bytes() == gkr.generate_gkr_transcript(_prover(circuit, inputs), F).to_bytes()
    assert [name for name, _, _ in timings] == ["prelude"] + ["phase1", "phase2"] * 3 + ["pull", "assemble"]
    assert all(s >= 0 for _, _, s in timings)


def test_routing_matches_jax():
    """F389, a circuit with k = 1 layers and a non-empty DST take the
    per-layer path (and count a fallback each), as the JAX
    supports_fused_gkr routes them; mesh= raises."""
    cases = [
        ("book F389", [[(True, 0, 1), (True, 2, 3)], [(True, 0, 0), (True, 1, 1), (True, 1, 2), (True, 3, 3)]],
         4, [3, 2, 3, 1], F389, b""),
        ("k = 1 layers", *_case([4, 2, 4, 4, 2, 4], 21), F, b""),
        ("non-empty DST", *_case([4, 8, 4], 30), F, b"thaler-study-gkr"),
    ]
    jf = {F389.name: jfields.F389, F.name: JF}
    for name, layers, n_in, inputs, field, dst in cases:
        circuit = _circuit(gkr, layers, n_in)
        assert not gkr.supports_fused_gkr(circuit, field, dst), name
        assert not jfused.supports_fused_gkr(_circuit(jgkr, layers, n_in), jf[field.name], dst), name
        before = fused.fallbacks
        t = gkr.generate_gkr_transcript_fused(_prover(circuit, inputs, field), field, dst)
        assert fused.fallbacks == before + 1, name
        assert t.to_bytes() == gkr.generate_gkr_transcript(_prover(circuit, inputs, field), field, dst).to_bytes()
    layers, n_in, inputs = _case([4, 8, 4], 30)
    circuit = _circuit(gkr, layers, n_in)
    assert gkr.supports_fused_gkr(circuit, F, b"")
    assert jfused.supports_fused_gkr(_circuit(jgkr, layers, n_in), JF, b"")
    with pytest.raises(NotImplementedError, match="multi-device"):
        gkr.generate_gkr_transcript_fused(_prover(circuit, inputs), F, mesh=object())


def test_zero_flag_falls_back_to_the_per_layer_path(monkeypatch):
    layers, n_in, inputs = _case([4, 8, 4], 30)
    circuit = _circuit(gkr, layers, n_in)
    plain = gkr_tail.round_tail_plain

    def flagged(*args, **kwargs):
        plain(*args, **kwargs)
        args[4][0] = 1  # zero

    monkeypatch.setattr(gkr_tail, "round_tail_plain", flagged)
    before = fused.fallbacks
    t = gkr.generate_gkr_transcript_fused(_prover(circuit, inputs), F)
    assert fused.fallbacks == before + 1
    assert t.to_bytes() == gkr.generate_gkr_transcript(_prover(circuit, inputs), F).to_bytes()
    assert _accepts(t, circuit, inputs)


def _embed(x: np.ndarray, n: int) -> np.ndarray:
    """x padded with zeros to n entries."""
    return np.concatenate([x, np.zeros(n - len(x), dtype=np.uint64)])


def test_eq_table_and_line_restriction_match_jax():
    """At k = 0..6 (random values, every value p - 1): the plain versions
    and the CPU wrappers of the eq table, the eq table with the dot, and
    the line restriction in both forms against the JAX package.

    The JAX side runs each case at K = 6 variables: W padded with zeros, u
    and c with zeros, so delta is 0 there and r_j(t) = 0 for the extra
    variables. Then q_K = (q_k, 0, ...), eq_K = (eq_k, 0, ...) and W~(u) is
    unchanged, exactly, and every eager JAX primitive runs at one set of
    shapes (its per-shape compilation was most of this test's time)."""
    rng = np.random.default_rng(41)
    K = 6
    for k in range(0, K + 1):
        for values in ("random", "p - 1"):
            size = 1 << k
            if values == "random":
                w, u, c = (rng.integers(0, P, n, dtype=np.uint64) for n in (size, k, k))
            else:
                w, u, c = (np.full(n, P - 1, dtype=np.uint64) for n in (size, k, k))
            fw, fu, fc = (FArray.from_ints(x, F, device="cpu") for x in (w, u, c))
            jw, ju, jc = (jfields.FArray.from_ints(_embed(x, n), JF) for x, n in ((w, 1 << K), (u, K), (c, K)))
            with jax.disable_jit():
                jq = jdt.line_restrict_coeffs(jw, ju, jc - ju, K)
                jeq = jdt.eq_table_dev(ju, K)
                jwu = jdt.dot_mod(jw, jeq)
            q_all = np.asarray(jq.to_u64(), dtype=np.uint64)
            eq_all = np.asarray(jeq.to_u64(), dtype=np.uint64)
            assert not q_all[k + 1 :].any() and not eq_all[size:].any()
            want_q, want_eq = q_all[: k + 1], eq_all[:size]
            want_wu = int(np.asarray(jwu.to_u64()).reshape(-1)[0])
            chal = FArray.from_ints(np.concatenate([u, c]), F, device="cpu")
            qs_port = [fn(fw, fu, fc - fu, k) for fn in (dt.line_restrict_coeffs_plain, dt.line_restrict_coeffs)]
            qs_port.append(dt.line_restrict_chal(fw, chal, k))
            for q in qs_port:
                assert q.shape == (k + 1,)
                assert np.array_equal(q.to_u64(), want_q), (k, values)
            for fn in (dt.eq_table_plain, dt.eq_table_dev):
                assert np.array_equal(fn(fu, k).to_u64(), want_eq), (k, values, fn.__name__)
            eq_u, w_u = dt.eq_table_dot(fu, fw, k)
            assert np.array_equal(eq_u.to_u64(), want_eq), (k, values)
            assert w_u.shape == (1,) and int(w_u.to_u64()[0]) == want_wu, (k, values)
            # q(t) = W~(u + t (c - u)) at t = 0, 1: W~(u) and W~(c)
            qs = [int(x) for x in want_q]
            assert qs[0] == want_wu == runtime.mle_eval(w, u, P)
            assert sum(qs) % P == runtime.mle_eval(w, c, P)
    assert np.array_equal(dt.eq_table_dev(FArray.from_ints([5], F, device="cpu"), 0).to_u64(), [1])


def _chain_at(prefix: bytes):
    """(port chain after ``prefix``, JAX host chain after it)."""
    jchain = JXmdChain(JF)
    jchain.absorb(prefix)
    return gkr_tail.prefix_chain(prefix, "cpu"), jchain


def _check_chain(chain, prefix: bytes) -> None:
    """The chain's state and partial block against the JAX package's
    native midstate over Z_pad || prefix."""
    full = bytes(64) + prefix
    cut = len(full) - len(full) % 64
    want = np.asarray(jruntime.sha256_midstate(full[:cut]), dtype=np.uint32)
    assert np.array_equal(chain.state.numpy().view(np.uint32), want)
    rest = np.zeros(64, dtype=np.uint8)
    rest[: len(full) - cut] = np.frombuffer(full[cut:], dtype=np.uint8)
    assert np.array_equal(chain.buf.numpy(), rest)
    assert chain.nbytes == len(prefix)


def _sums_for(rng, claim=None):
    """Random per-block partials [1, 5, 3] whose column sums are s, and s
    (with s(1) = claim - s(0) when the claim is given)."""
    parts = rng.integers(0, P, (1, 5, 3), dtype=np.uint64)
    s = [int(x) % P for x in parts[0].astype(object).sum(axis=0)]
    if claim is not None:
        s[1] = (claim - s[0]) % P
    return torch.from_numpy(parts.view(np.int64).copy()), s


def _jpoly(s):
    """The JAX UniPoly through the values s at 0, 1, 2."""
    return lagrange_interpolate([(JF.felt(t), JF.felt(v)) for t, v in enumerate(s)], JF)


def test_round_tail_plain_every_fill():
    """Every fill of the chain's partial block, turning through phase 1's
    round 0 (StartSumCheck, no claim), a middle round and the layer's
    second-to-last message (two draws)."""
    rng = np.random.default_rng(43)
    for fill in range(64):
        kind = ("start", "plain", "two draws")[fill % 3]
        prefix = rng.integers(0, 256, 64 * (3 + fill % 4) + fill, dtype=np.uint8).tobytes()
        chain, jchain = _chain_at(prefix)
        _check_chain(chain, prefix)
        claim_in = P - 1 - fill
        parts, s = _sums_for(rng, None if kind == "start" else claim_in)
        k, layer = 3 + fill % 5, fill
        msgs = torch.full((300,), 7, dtype=torch.uint8)
        zero = torch.zeros(1, dtype=torch.int32)
        claim = FArray.from_ints([claim_in], F, device="cpu").data
        chal = torch.zeros(2 * k, dtype=torch.int64)
        draws = 2 if kind == "two draws" else 1
        idx = 2 * k - 3 if draws == 2 else fill % k
        start = (layer, k) if kind == "start" else None
        gkr_tail.round_tail_plain(parts, chain, msgs, 11, zero, claim, chal, idx, draws, start)
        m = gkr_tail.ROUND_LEN + (gkr_tail.START_LEN if start else 0)
        chain.nbytes += m

        poly = _jpoly(s)
        want = b""
        if kind == "start":
            c1 = JF.felt(s[0] + s[1])
            want = jgkr.serialize_gkr_message(jgkr.StartSumCheck(c_1=c1, round=layer, num_vars=2 * k))
        want += jgkr.serialize_gkr_message(jgkr.SumCheckProverMessage(p=poly))
        assert m == len(want) and bytes(msgs[11 : 11 + m].tolist()) == want, (fill, kind)
        assert msgs[:11].eq(7).all() and msgs[11 + m :].eq(7).all()
        _check_chain(chain, prefix + want)
        jchain.absorb(want)
        rs = jchain.draw(draws)
        got = FArray(chal, F).to_u64()
        assert [int(x) for x in got[idx : idx + draws]] == [r.v for r in rs], (fill, kind)
        assert FArray(claim, F).to_u64()[0] == poly.evaluate(rs[0]).v
        assert int(zero[0]) == 0
        if fill == 5:
            with jax.disable_jit():
                sums = jfields.FArray.from_ints(np.array(s, dtype=np.uint64), JF)
                coeffs, _ = j_interp_coeffs(sums, 2)
            jc = [int(lo) | int(hi) << 32 for lo, hi in coeffs]
            assert jc == [poly.coeff(t).v for t in range(3)]
    # a zero coefficient sets the flag: s = (0, 0, 0) at round 0
    chain, _ = _chain_at(b"")
    zero = torch.zeros(1, dtype=torch.int32)
    gkr_tail.round_tail_plain(torch.zeros((1, 2, 3), dtype=torch.int64), chain, torch.zeros(82, dtype=torch.uint8),
                              0, zero, torch.zeros(1, dtype=torch.int64), torch.zeros(4, dtype=torch.int64), 0, 1,
                              (0, 2))
    assert int(zero[0]) == 1


def _libra_sums(phase, tables, scalar, r):
    """Python ints: the tables folded at r (None: no fold) and the round
    sums s(0), s(1), s(2) of W A1 + A2 (phase 1) or B1 w + B1 Wc + B2 w Wc
    (phase 2) over the (folded) tables' halves."""
    if r is not None:
        h = len(tables[0]) // 2
        tables = [[(t[x] + r * (t[h + x] - t[x])) % P for x in range(h)] for t in tables]
    h = len(tables[0]) // 2
    s = []
    for t in range(3):
        v = [[(tab[x] + t * (tab[h + x] - tab[x])) % P for x in range(h)] for tab in tables]
        if phase == 1:
            s.append(sum(a * b + c for a, b, c in zip(*v)) % P)
        else:
            s.append(sum(a * scalar + a * c + b * scalar * c for a, b, c in zip(*v)) % P)
    return tables, s


def test_round_with_tail_every_fill():
    """K1 and the round tail as one call (``gkr_tail.libra_round_tail``: on
    the CPU, K1's plain version then ``round_tail_plain``, the composition
    the kernel's epilogue runs) at every fill of the chain's partial block,
    turning through phase 1's round 0 (StartSumCheck, no fold), a folded
    round of either phase and the second-to-last message (two draws): the
    folded tables and the round sums equal to Python ints, the message
    bytes, chain state, challenges and next claim equal to the JAX
    package's codec and challenge chain."""
    rng = np.random.default_rng(53)
    for fill in range(64):
        kind = ("start", "plain", "two draws")[fill % 3]
        phase = 1 if kind == "start" or fill % 2 else 2
        prefix = rng.integers(0, 256, 64 * (1 + fill % 3) + fill, dtype=np.uint8).tobytes()
        chain, jchain = _chain_at(prefix)
        vals = [[int(x) for x in rng.integers(0, P, 16, dtype=np.uint64)] for _ in range(3)]
        vals[0][fill % 16] = P - 1
        scalar = int(rng.integers(0, P, dtype=np.uint64))
        r = None if kind == "start" else int(rng.integers(0, P, dtype=np.uint64))
        folded_want, s = _libra_sums(phase, vals, scalar, r)
        claim_in = (s[0] + s[1]) % P if kind == "start" else int(rng.integers(0, P, dtype=np.uint64))
        if kind != "start":
            s[1] = (claim_in - s[0]) % P
        k, layer = 3 + fill % 4, fill
        draws = 2 if kind == "two draws" else 1
        idx = 2 * k - 3 if draws == 2 else fill % k
        layer_tail = gkr_tail.LayerTail(
            chain, torch.full((200,), 5, dtype=torch.uint8), torch.zeros(1, dtype=torch.int32),
            FArray.from_ints([claim_in], F, device="cpu").data, torch.zeros(2 * k, dtype=torch.int64),
            torch.zeros(1, dtype=torch.int32),
        )
        tail = gkr_tail.RoundTail(layer_tail, 9, idx, draws, (layer, k) if kind == "start" else None)
        tables = [FArray.from_ints(v, F, device="cpu").data.reshape(1, -1) for v in vals]
        folded, partials = gkr_tail.libra_round_tail(
            tables, None if r is None else FArray.from_ints([r], F, device="cpu").data, kind != "start", phase,
            [] if phase == 1 else [FArray.from_ints([scalar], F, device="cpu").data], tail,
        )
        assert partials.shape[0] == 1 and partials.shape[2] == 3
        if r is not None:
            assert [[int(x) for x in FArray(t[0], F).to_u64()] for t in folded] == folded_want, fill

        poly = _jpoly(s)
        want = b""
        if kind == "start":
            want = jgkr.serialize_gkr_message(jgkr.StartSumCheck(c_1=JF.felt(s[0] + s[1]), round=layer, num_vars=2 * k))
        want += jgkr.serialize_gkr_message(jgkr.SumCheckProverMessage(p=poly))
        msgs = layer_tail.msgs
        assert tail.length == len(want)
        assert bytes(msgs[9 : 9 + len(want)].tolist()) == want, (fill, kind)
        assert msgs[:9].eq(5).all() and msgs[9 + len(want) :].eq(5).all()
        _check_chain(chain, prefix + want)
        jchain.absorb(want)
        rs = jchain.draw(draws)
        assert [int(x) for x in FArray(layer_tail.chal, F).to_u64()[idx : idx + draws]] == [x.v for x in rs], fill
        assert FArray(layer_tail.claim, F).to_u64()[0] == poly.evaluate(rs[0]).v
        assert int(layer_tail.zero[0]) == 0 and int(layer_tail.counter[0]) == 0


def test_final_tail_plain_every_fill():
    rng = np.random.default_rng(47)
    for fill in range(64):
        k = (2, 3, 5, 20)[fill % 4]
        prefix = rng.integers(0, 256, 64 * (2 + fill % 3) + fill, dtype=np.uint8).tobytes()
        chain, jchain = _chain_at(prefix)
        claim_in = int(rng.integers(0, P, dtype=np.uint64))
        parts, s = _sums_for(rng, claim_in)
        q = rng.integers(1, P, k + 1, dtype=np.uint64)
        q[fill % (k + 1)] = P - 1
        chal = rng.integers(0, P, 2 * k, dtype=np.uint64)
        msgs = torch.full((20 + gkr_tail.final_len(k),), 9, dtype=torch.uint8)
        zero = torch.zeros(1, dtype=torch.int32)
        r_next = torch.zeros(k, dtype=torch.int64)
        claim = FArray.from_ints([claim_in], F, device="cpu").data
        m = gkr_tail.final_tail(parts, claim, FArray.from_ints(q, F, device="cpu").data,
                                FArray.from_ints(chal, F, device="cpu").data, k, chain, msgs, 13, zero, r_next)

        p_poly = _jpoly(s)
        q_poly = JUniPoly.from_coeffs([JF.felt(int(x)) for x in q], JF)
        want = jgkr.serialize_gkr_message(jgkr.FinalRoundMessage(p=p_poly, q=q_poly))
        assert m == len(want) == gkr_tail.final_len(k)
        assert bytes(msgs[13 : 13 + m].tolist()) == want, (fill, k)
        assert msgs[:13].eq(9).all() and msgs[13 + m :].eq(9).all()
        _check_chain(chain, prefix + want)
        jchain.absorb(want)
        (r_star,) = jchain.draw(1)
        u = [JF.felt(int(x)) for x in chal[:k]]
        c = [JF.felt(int(x)) for x in chal[k:]]
        want_next = [li.evaluate(r_star).v for li in jgkr.line(u, c)]
        assert [int(x) for x in FArray(r_next, F).to_u64()] == want_next, (fill, k)
        assert int(zero[0]) == 0
    # a zero coefficient of q sets the flag
    chain, _ = _chain_at(b"x")
    zero = torch.zeros(1, dtype=torch.int32)
    q = torch.tensor([1, 0, 1], dtype=torch.int64)
    gkr_tail.final_tail(_sums_for(rng, 3)[0], torch.tensor([3]), q, torch.ones(4, dtype=torch.int64), 2, chain,
                        torch.zeros(gkr_tail.final_len(2), dtype=torch.uint8), 0, zero, torch.zeros(2, dtype=torch.int64))
    assert int(zero[0]) == 1
