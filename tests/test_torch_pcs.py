"""The port's PCS (``pcs/``), its Merkle build (``ops/merkle_kernel.py``)
and ``utils.config`` against the JAX package on the CPU.

- Merkle levels, paths and multiproofs of ``MerkleTree(..., device="cpu")``
  (``hashlib``) and of ``merkle_kernel.build_tree`` on CPU tensors (its
  plain version) against the JAX package's host tree over F5, F389 and
  Goldilocks leaves; the CUDA kernel's message words (``csrc/merkle.cu``:
  the leaf block, the node's two blocks shifted by the 5-byte prefix)
  replayed in Python ints against ``hashlib``;
- the relaxed PCS: the same roots, restrictions, accept and reject
  decisions as the JAX package (an honest prover, a wrong degree, a
  shifted restriction, a changed leaf, a multi-opening);
- the Pedersen family: the golden root and level 1 of
  ``tests/data/pedersen_golden.json``, the same tree through the JAX
  module, the generators against the golden file, and the relaxed PCS
  over it;
- ``utils``: ``use_config`` / ``set_config`` / ``from_env``, the nine
  exported names, ``device_trace``'s Chrome trace on the CPU.

Inputs come from numpy seeds. The JAX side builds its trees with
``hashlib`` (its ``merkle_device_min_leaves = 0``) and runs no compiled
program. Tolerance: exact (digests, field values, decisions).
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # 6 test workers share the cores: torch's own pool would compete with them

import jax  # noqa: E402

from thaler_study_tpu import fields as jfields  # noqa: E402
from thaler_study_tpu import pcs as jpcs  # noqa: E402
from thaler_study_tpu.mle.dense import DenseMLE as JDenseMLE  # noqa: E402
from thaler_study_tpu.pcs import pedersen as jped  # noqa: E402
from thaler_study_tpu.sumcheck import SeededRng as JSeededRng  # noqa: E402
from thaler_study_tpu.utils import config as jconfig  # noqa: E402
from thaler_study_tpu_torch import pcs, utils  # noqa: E402
from thaler_study_tpu_torch.fields import F5, F389, GOLDILOCKS  # noqa: E402
from thaler_study_tpu_torch.mle.dense import DenseMLE  # noqa: E402
from thaler_study_tpu_torch.ops import merkle_kernel  # noqa: E402
from thaler_study_tpu_torch.ops.sha256 import H0, py_compress  # noqa: E402
from thaler_study_tpu_torch.pcs import pedersen  # noqa: E402
from thaler_study_tpu_torch.sumcheck import SeededRng, UniPoly  # noqa: E402
from thaler_study_tpu_torch.utils.config import DEFAULT, FrameworkConfig, get_config, set_config, use_config  # noqa: E402

GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "data", "pedersen_golden.json")))
_JF = {"Goldilocks": "GOLDILOCKS", "F5": "F5", "F389": "F389"}


def _jf(field):
    return getattr(jfields, _JF[field.name])


def _jax_host_config():
    return jconfig.use_config(dataclasses.replace(jconfig.get_config(), merkle_device_min_leaves=0))


def _jax_levels(jtree):
    """The JAX tree's levels as the port keeps them: each level's digests
    as one string."""
    return [b"".join(level) for level in jtree.levels]


def _values(field, n, seed):
    return [int(v) for v in np.random.default_rng(seed).integers(0, field.p, size=n, dtype=np.uint64)]


def test_merkle_levels_match_jax():
    """Every level of the port's trees (``hashlib`` and the Merkle kernel's
    plain version) equals the JAX package's host tree; paths verify and a
    changed leaf is rejected."""
    for field, n, seed in ((F5, 64, 1), (F389, 32, 2), (GOLDILOCKS, 128, 3), (GOLDILOCKS, 1, 4)):
        ints = _values(field, n, seed)
        felts = [field.felt(v) for v in ints]
        tree = pcs.MerkleTree(felts, device="cpu")
        with _jax_host_config():
            jtree = jpcs.MerkleTree([_jf(field).felt(v) for v in ints])
        assert [tree.level(j) for j in range(tree.height + 1)] == _jax_levels(jtree), field.name
        assert tree.digests == b"".join(_jax_levels(jtree))
        assert pcs.merkle.leaf_bytes(felts).tolist() == [list(f.to_bytes_le()) for f in felts]
        vals = torch.from_numpy(pcs.merkle.leaf_bytes(felts))
        flat = merkle_kernel.build_tree(vals).numpy().view(np.uint32)
        assert [lv.astype(">u4").tobytes() for lv in merkle_kernel.split_levels(flat)] == _jax_levels(jtree)
        assert merkle_kernel.build_tree_device(vals.numpy(), device="cpu")[-1].tolist() == [
            list(np.frombuffer(jtree.root(), ">u4"))]
        for i in {0, n // 2, n - 1}:
            assert tree.generate_proof(i).verify(tree.root(), felts[i])
        if n > 1:
            assert not tree.generate_proof(1).verify(tree.root(), felts[1] + field.one())
    # the kernel's launch plan: one per level of more than 256 nodes, one
    # block for the levels above
    assert [merkle_kernel.node_launches(1 << k) for k in (0, 1, 8, 9, 10, 22)] == [0, 1, 1, 1, 2, 14]


def _words_bytes(w):
    return b"".join(x.to_bytes(4, "big") for x in w)


def _kernel_leaf(row):
    """csrc/merkle.cu leaf_kernel's block in Python ints, compressed."""
    length = 5 + len(row)
    w = [0x6C656166, 0x3A000000] + [0] * 14
    for q in range(5, 14):
        byte = int(row[q - 5]) if q < length else (0x80 if q == length else 0)
        w[q >> 2] |= byte << (8 * (3 - (q & 3)))
    w[15] = 8 * length
    st = list(H0)
    py_compress(st, _words_bytes(w))
    return st


def _kernel_node(left, right):
    """csrc/merkle.cu node_kernel's two blocks in Python ints, compressed."""
    s = list(left) + list(right) + [0x80000000]
    st = list(H0)
    w = [0x6E6F6465, 0x3A000000 | (s[0] >> 8)] + [(s[j - 2] << 24) & 0xFFFFFFFF | (s[j - 1] >> 8) for j in range(2, 16)]
    py_compress(st, _words_bytes(w))
    w = [(s[14] << 24) & 0xFFFFFFFF | (s[15] >> 8), (s[15] << 24) & 0xFFFFFFFF | (s[16] >> 8)] + [0] * 13 + [69 * 8]
    py_compress(st, _words_bytes(w))
    return st


def test_merkle_kernel_words_replay_hashlib():
    """The Merkle kernel's message words (every leaf width 1-8 bytes, and a
    node over two digests) hash to ``hashlib``'s digests."""
    rng = np.random.default_rng(5)
    for byte_size in range(1, 9):
        rows = rng.integers(0, 256, size=(4, byte_size), dtype=np.uint8)
        rows[0] = 255
        leaves = [_kernel_leaf(r) for r in rows]
        for r, st in zip(rows, leaves):
            assert _words_bytes(st) == hashlib.sha256(b"leaf:" + r.tobytes()).digest(), byte_size
        want = hashlib.sha256(b"node:" + _words_bytes(leaves[0]) + _words_bytes(leaves[1])).digest()
        assert _words_bytes(_kernel_node(leaves[0], leaves[1])) == want
        levels = merkle_kernel.build_tree_plain(rows)
        assert levels[1][1].tolist() == _kernel_node(leaves[2], leaves[3])


def test_multipath_matches_jax():
    """Multiproofs: the same siblings as the JAX package's, accepted,
    rejected with a changed leaf or a short or long sibling stream."""
    n = 64
    ints = _values(GOLDILOCKS, n, 6)
    felts = [GOLDILOCKS.felt(v) for v in ints]
    tree = pcs.MerkleTree(felts, device="cpu")
    with _jax_host_config():
        jtree = jpcs.MerkleTree([jfields.GOLDILOCKS.felt(v) for v in ints])
    for idxs in ([0], [5], [6, 7], [3, 17, 16, 60], list(range(n))):
        multi = tree.generate_multi_proof(idxs)
        jmulti = jtree.generate_multi_proof(idxs)
        assert (multi.indices, multi.height, multi.siblings) == (jmulti.indices, jmulti.height, jmulti.siblings)
        leaves = [felts[i] for i in multi.indices]
        assert multi.verify(tree.root(), leaves)
        bad = list(leaves)
        bad[0] = bad[0] + GOLDILOCKS.one()
        assert not multi.verify(tree.root(), bad)
    multi = tree.generate_multi_proof([3, 17])
    leaves = [felts[3], felts[17]]
    assert not pcs.MerkleMultiPath(multi.indices, multi.height, multi.siblings[:-1]).verify(tree.root(), leaves)
    assert not pcs.MerkleMultiPath(multi.indices, multi.height, multi.siblings + multi.siblings[:1]).verify(
        tree.root(), leaves)


def _provers(field, m, seed, hash_family="sha256"):
    ints = _values(field, 1 << m, seed)
    port = pcs.Prover(DenseMLE.from_evals_lsb([field.felt(v) for v in ints], m, field, device="cpu"), hash_family)
    with _jax_host_config():
        jax_p = jpcs.Prover(JDenseMLE.from_evals_lsb([_jf(field).felt(v) for v in ints], m, _jf(field)), hash_family)
    return port, jax_p


def _flow(prover, verifier, rng, field, cheat):
    """The reference's it_works flow; returns the error type raised (None
    when accepted)."""
    b, c = verifier.random_line(rng, field)
    restriction = prover.poly_restriction_to_line(b, c)
    if cheat == "shift":
        restriction = restriction + type(restriction)([(0, field.one())], field)
    point = verifier.challenge_prover(rng, field)
    proof, value = prover.challenge(point)
    if cheat == "leaf":
        value = value + field.one()
    try:
        verifier.commited_univariate(restriction)
        verifier.verify_prover_reply(proof, value)
    except Exception as e:  # noqa: BLE001 - the decision is compared by type name
        return type(e).__name__
    return None


def test_relaxed_pcs_matches_jax():
    """The same roots as the JAX package (F5 m = 2, F389 m = 1), and the
    same decisions: an honest prover accepted; a shifted restriction, a
    changed leaf and a wrong degree rejected."""
    with jax.disable_jit():
        for field, m, seed in ((F5, 2, 7), (F389, 1, 8)):
            port, jax_p = _provers(field, m, seed)
            assert port.merkle_root() == jax_p.merkle_root()
            assert len(port.values) == len(jax_p.values) == 1 << (field.p ** m - 1).bit_length()
            for seed in range(8):
                for cheat in (None, "shift", "leaf"):
                    got = _flow(port, pcs.Verifier(m, 1, port.merkle_root()), SeededRng(seed), field, cheat)
                    want = _flow(jax_p, jpcs.Verifier(m, 1, jax_p.merkle_root()), JSeededRng(seed), _jf(field), cheat)
                    assert got == want, (field.name, seed, cheat)
                    # a lower-degree restriction trips the degree check first
                    assert got in ((None, "DegreeMismatch") if cheat is None else ("EvalMismatch", "DegreeMismatch",
                                                                                   "PCSError")), (seed, cheat, got)
            v = pcs.Verifier(m, 1, port.merkle_root())
            v.random_line(SeededRng(9), field)
            with pytest.raises(pcs.DegreeMismatch):
                v.commited_univariate(UniPoly([(5, field.one())], field))


def _multi_flow(prover, verifier_cls, rng_cls, field, m):
    """A multi-opening of 4 points on the first random line whose
    restriction has the full degree m (the verifier's degree check needs
    it; a lower degree raises DegreeMismatch, in both packages): the
    multiproof, accepted, and the error a changed leaf raises."""
    for seed in range(20):
        verifier, rng = verifier_cls(m, 1, prover.merkle_root()), rng_cls(seed)
        b, c = verifier.random_line(rng, field)
        restriction = prover.poly_restriction_to_line(b, c)
        if restriction.degree() == m:
            break
    verifier.commited_univariate(restriction)
    points = verifier.challenge_prover_many(rng, field, 4)
    multi, leaves = prover.challenge_many(points)
    verifier.verify_prover_reply_many(multi, leaves)
    try:
        verifier.verify_prover_reply_many(multi, [leaves[0] + field.one()] + leaves[1:])
        error = None
    except Exception as e:  # noqa: BLE001 - the decision is compared by type name
        error = type(e).__name__
    return seed, multi.indices, multi.siblings, [x.v for x in leaves], error


def test_pcs_multi_opening_matches_jax():
    """A multi-opening of 4 points on the random line: the same multiproof
    as the JAX package's, accepted; a changed leaf rejected."""
    with jax.disable_jit():
        port, jax_p = _provers(F5, 2, 10)
        got = _multi_flow(port, pcs.Verifier, SeededRng, F5, 2)
        want = _multi_flow(jax_p, jpcs.Verifier, JSeededRng, jfields.F5, 2)
    assert got == want
    assert got[-1] == "PCSError"


def test_pedersen_matches_golden_and_jax():
    """The Pedersen family: the golden F5 (3, 1, 4, 1) root and level 1,
    the same tree through the JAX module, the first generators against the
    golden file, and the relaxed PCS over it (F5, m = 2: 25 points, 32
    leaves) accepted and a changed leaf rejected. (The 32-leaf tree takes
    ~8 s of host integers; it is built once, by the port.)"""
    leaves = (3, 1, 4, 1)
    tree = pedersen.PedersenMerkleTree([F5.felt(v) for v in leaves])
    jtree = jped.PedersenMerkleTree([jfields.F5.felt(v) for v in leaves])
    assert tree.root().hex() == jtree.root().hex() == GOLDEN["tree_f5_3141_root"]
    assert [pedersen.te_serialize_compressed(p).hex() for p in tree.levels[1]] == GOLDEN["tree_f5_3141_level1"]
    assert tree.levels == jtree.levels
    params = pedersen.default_params()
    leaf0, node0 = params.leaf_generators[0][0], params.node_generators[0][0]
    assert [hex(leaf0[0]), hex(leaf0[1])] == GOLDEN["first_leaf_generator"]
    assert [hex(node0[0]), hex(node0[1])] == GOLDEN["first_node_generator"]
    rng = pedersen.ark_test_rng()
    assert [hex(rng.next_u32()) for _ in range(8)] == GOLDEN["test_rng_first_u32"]
    ints = _values(F5, 4, 12)
    port = pcs.Prover(DenseMLE.from_evals_lsb([F5.felt(v) for v in ints], 2, F5, device="cpu"), "pedersen")
    assert len(port.values) == 32
    for seed in range(20):  # a line whose restriction has the full degree (see _multi_flow)
        b, c = pcs.Verifier(2, 1, port.merkle_root()).random_line(SeededRng(seed), F5)
        if port.poly_restriction_to_line(b, c).degree() == 2:
            break
    assert _flow(port, pcs.Verifier(2, 1, port.merkle_root()), SeededRng(seed), F5, None) is None
    assert _flow(port, pcs.Verifier(2, 1, port.merkle_root()), SeededRng(seed), F5, "leaf") == "PCSError"


def test_utils_config(monkeypatch, tmp_path):
    """``use_config`` / ``set_config`` scope the active config; the port
    reads no knob, so its ``FrameworkConfig`` has no field the reference
    lacks and ``from_env`` takes no ``THALER_*`` variable; a tree follows
    its ``device`` alone; the nine names of the JAX package's ``utils``;
    ``device_trace`` writes a Chrome trace."""
    assert set(utils.__all__) == set(__import__("thaler_study_tpu.utils", fromlist=["x"]).__all__)
    port_fields = {f.name for f in dataclasses.fields(FrameworkConfig)}
    assert port_fields <= {f.name for f in dataclasses.fields(jconfig.FrameworkConfig)}
    assert utils.DEFAULT == FrameworkConfig()
    before = get_config()
    cfg = FrameworkConfig()
    with use_config(cfg) as active:
        assert active is cfg and get_config() is cfg and cfg is not before
        tree = pcs.MerkleTree([F5.felt(1), F5.felt(2)], device="cpu")
        assert tree.root() == hashlib.sha256(b"node:" + hashlib.sha256(b"leaf:\x01").digest()
                                             + hashlib.sha256(b"leaf:\x02").digest()).digest()
    assert get_config() is before
    prev = set_config(cfg)
    assert prev is before and get_config() is cfg
    set_config(prev)
    assert get_config() is before
    monkeypatch.setenv("THALER_FIELD", "F5")
    monkeypatch.setenv("THALER_MERKLE_DEVICE_MIN", "1024")
    assert FrameworkConfig.from_env() == FrameworkConfig() == DEFAULT
    timer = utils.RoundTimer()
    with utils.device_trace(str(tmp_path)):
        with timer.round("add"):
            torch.ones(4) + 1
    assert timer.summary()["rounds"] == 1
    assert json.load(open(tmp_path / "trace.json"))["traceEvents"]
