"""Pedersen-CRH-over-JubJub Merkle commitments — the reference's hash family.

A copy of ``thaler_study_tpu/pcs/pedersen.py`` (host integers only, so the
port keeps its own). The reference instantiates its relaxed-PCS Merkle tree
with arkworks' Pedersen CRH over the JubJub curve (relaxed-pcs/src/lib.rs:
231-284: ``pedersen::CRH<JubJub, Window4x256>`` leaves,
``pedersen::TwoToOneCRH`` inner nodes, parameters drawn from
``ark_std::test_rng()``). The production tree is SHA-256 (pcs/merkle.py —
the hash family is a config type parameter in the reference too). This
module is a pure-host-integer implementation of the exact arkworks
semantics —

- ``ChaCha12Rng``: rand 0.8's ``StdRng`` (rand_chacha ChaCha12, 64-bit
  block counter in state words 12-13, word-little-endian output,
  rand_core ``BlockRng`` u32/u64 consumption order), seeded with
  ``ark_std::test_rng()``'s fixed seed = [1, 23, 456, 7890] as LE u32s
  (ark-std src/rand_helper.rs).
- ``fq_rand``: ark-ff ``Fp::rand`` — 4 ``next_u64`` limbs (LSB limb
  first), top limb masked by ``u64::MAX >> 1`` (255-bit modulus in a
  256-bit repr), rejection-resampled while >= p, and the accepted limbs
  ARE the Montgomery representation (canonical value = repr * R^-1).
- JubJub (ark-ed-on-bls12-381): twisted Edwards a = -1,
  d = -(10240/10241) over the BLS12-381 scalar field; cofactor 8.
- ``Projective::rand``: loop { y = Fq::rand; greatest = sign bit of
  ``next_u32`` (rand 0.8 bool = ``(next_u32 as i32) < 0``);
  get_point_from_y_unchecked picks the greater/lesser root of
  x^2 = (y^2 - 1)/(d y^2 - a); multiply by the cofactor }.
- Pedersen ``setup``/``create_generators``: NUM_WINDOWS = 256 windows,
  each window = [g, 2g, 4g, 8g] (WINDOW_SIZE = 4 doublings of one
  random base).
- ``CRH::evaluate``: zero-pad input bytes to 128, bits LSB-first per
  byte, one window per 4-bit chunk, sum the powers at set bits.
- ``TwoToOneCRH::evaluate``: CRH over left||right bytes (its own
  generator set, drawn AFTER the leaf set from the same rng — the
  reference's setup order); ``compress`` feeds the points' uncompressed
  serialization (x||y, 32 LE bytes each), matching
  ``ByteDigestConverter`` (to_uncompressed_bytes) at the leaf boundary.
- Serialization: ark 0.4 twisted-Edwards — compressed = y's 32 LE bytes
  with the "x is negative" flag (x > -x) in the top bit of the last
  byte; uncompressed = x || y plain.

The bytes are derived from the arkworks 0.4 source semantics cited above,
not from a live arkworks run; the golden vectors
(tests/data/pedersen_golden.json) pin that derivation so that an arkworks
run can confirm or falsify one exact constant.

Host-side by design: commitment hashing is tree bookkeeping, not field
math — the reference's arkworks path is host-serial too. The card's path
for commitments is the SHA-256 tree (ops/merkle_kernel.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..fields import Felt

# --------------------------------------------------------------------------
# ChaCha12 (rand 0.8 StdRng) + ark_std::test_rng
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


class ChaCha12Rng:
    """rand_chacha's ChaCha12Rng: 32-byte seed -> key; 64-bit block
    counter in words 12-13; stream id (words 14-15) zero; output words
    little-endian; BlockRng consumption (next_u64 = lo word then hi
    word, spanning blocks)."""

    _CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self._key = tuple(
            int.from_bytes(seed[4 * i : 4 * i + 4], "little")
            for i in range(8)
        )
        self._counter = 0
        self._words: List[int] = []

    def _block(self, counter: int) -> List[int]:
        init = list(self._CONSTANTS) + list(self._key) + [
            counter & _M32,
            (counter >> 32) & _M32,
            0,
            0,
        ]
        x = list(init)

        def qr(a, b, c, d):
            x[a] = (x[a] + x[b]) & _M32
            x[d] = _rotl32(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & _M32
            x[b] = _rotl32(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & _M32
            x[d] = _rotl32(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & _M32
            x[b] = _rotl32(x[b] ^ x[c], 7)

        for _ in range(6):  # 12 rounds = 6 double rounds
            qr(0, 4, 8, 12)
            qr(1, 5, 9, 13)
            qr(2, 6, 10, 14)
            qr(3, 7, 11, 15)
            qr(0, 5, 10, 15)
            qr(1, 6, 11, 12)
            qr(2, 7, 8, 13)
            qr(3, 4, 9, 14)
        return [(a + b) & _M32 for a, b in zip(x, init)]

    def _refill(self) -> None:
        self._words.extend(self._block(self._counter))
        self._counter += 1

    def next_u32(self) -> int:
        if not self._words:
            self._refill()
        return self._words.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)


def ark_test_rng() -> ChaCha12Rng:
    """ark_std::test_rng(): StdRng seeded with [1, 23, 456, 7890] as
    little-endian u32s (ark-std src/rand_helper.rs)."""
    seed = b"".join(
        v.to_bytes(4, "little") for v in (1, 23, 456, 7890)
    ) + bytes(16)
    return ChaCha12Rng(seed)


# --------------------------------------------------------------------------
# JubJub: twisted Edwards over the BLS12-381 scalar field
# --------------------------------------------------------------------------

FQ = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
_R256 = (1 << 256) % FQ  # arkworks Montgomery R for the 4-limb repr
COEFF_A = FQ - 1  # a = -1
COEFF_D = (-10240 * pow(10241, -1, FQ)) % FQ
COFACTOR = 8
_FQ_BYTES = 32  # ceil(255 / 8)

# Edwards points as (x, y) canonical-integer affine pairs; identity (0, 1)
Point = Tuple[int, int]
IDENTITY: Point = (0, 1)


def fq_rand(rng: ChaCha12Rng) -> int:
    """ark-ff Fp::rand: sample 4 u64 limbs (LSB first), mask the top
    limb's high bit (256 -> 255), reject while >= p; the accepted limbs
    are the MONTGOMERY representation, so the canonical value is
    repr * R^-1 mod p."""
    while True:
        limbs = [rng.next_u64() for _ in range(4)]
        limbs[3] &= (1 << 63) - 1
        repr_int = sum(l << (64 * i) for i, l in enumerate(limbs))
        if repr_int < FQ:
            return (repr_int * pow(_R256, FQ - 2, FQ)) % FQ


def _sqrt_fq(a: int) -> Optional[int]:
    """Tonelli-Shanks square root mod FQ (2-adicity 32); either root."""
    if a == 0:
        return 0
    if pow(a, (FQ - 1) // 2, FQ) != 1:
        return None
    q = FQ - 1
    s = 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (FQ - 1) // 2, FQ) != FQ - 1:
        z += 1
    m, c, t, r = s, pow(z, q, FQ), pow(a, q, FQ), pow(a, (q + 1) // 2, FQ)
    while t != 1:
        t2 = t
        i = 0
        while t2 != 1:
            t2 = t2 * t2 % FQ
            i += 1
        b = pow(c, 1 << (m - i - 1), FQ)
        m, c = i, b * b % FQ
        t, r = t * c % FQ, r * b % FQ
    return r


def edwards_add(p1: Point, p2: Point) -> Point:
    """Complete twisted-Edwards addition (affine)."""
    x1, y1 = p1
    x2, y2 = p2
    dxy = COEFF_D * x1 * x2 % FQ * y1 * y2 % FQ
    x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, FQ - 2, FQ) % FQ
    y3 = (
        (y1 * y2 - COEFF_A * x1 * x2) * pow((1 - dxy) % FQ, FQ - 2, FQ) % FQ
    )
    return x3, y3


def edwards_double(p: Point) -> Point:
    return edwards_add(p, p)


def edwards_mul(p: Point, k: int) -> Point:
    acc = IDENTITY
    while k:
        if k & 1:
            acc = edwards_add(acc, p)
        p = edwards_double(p)
        k >>= 1
    return acc


def get_point_from_y(y: int, greatest: bool) -> Optional[Point]:
    """ark-ec get_point_from_y_unchecked: x^2 = (y^2 - 1)/(d y^2 - a);
    the two roots ordered canonically, ``greatest`` picks the larger."""
    num = (y * y - 1) % FQ
    den = (COEFF_D * y * y - COEFF_A) % FQ
    if den == 0:
        return None
    x = _sqrt_fq(num * pow(den, FQ - 2, FQ) % FQ)
    if x is None:
        return None
    neg = (FQ - x) % FQ
    lo, hi = (x, neg) if x <= neg else (neg, x)
    return (hi if greatest else lo, y)


def projective_rand(rng: ChaCha12Rng) -> Point:
    """ark-ec Projective::<TE>::rand: y = Fq::rand, greatest = rand
    bool (= sign bit of next_u32, rand 0.8 Standard), retry until the
    x exists, then multiply by the cofactor."""
    while True:
        y = fq_rand(rng)
        greatest = (rng.next_u32() >> 31) == 1
        p = get_point_from_y(y, greatest)
        if p is not None:
            return edwards_mul(p, COFACTOR)


# --------------------------------------------------------------------------
# Serialization (ark 0.4 CanonicalSerialize)
# --------------------------------------------------------------------------


def fq_to_bytes(v: int) -> bytes:
    return v.to_bytes(_FQ_BYTES, "little")


def te_serialize_uncompressed(p: Point) -> bytes:
    """x || y, 32 canonical LE bytes each (to_uncompressed_bytes!)."""
    return fq_to_bytes(p[0]) + fq_to_bytes(p[1])


def te_serialize_compressed(p: Point) -> bytes:
    """y's 32 LE bytes with the 'x is negative' flag (x > -x) in the
    top bit of the final byte (ark 0.4 TEFlags)."""
    x, y = p
    out = bytearray(fq_to_bytes(y))
    if x > (FQ - x) % FQ:
        out[-1] |= 0x80
    return bytes(out)


def te_deserialize_compressed(data: bytes) -> Optional[Point]:
    """Inverse of :func:`te_serialize_compressed`: recover x from y and
    the sign flag (None for off-curve bytes)."""
    if len(data) != _FQ_BYTES:
        return None
    raw = bytearray(data)
    x_negative = bool(raw[-1] & 0x80)
    raw[-1] &= 0x7F
    y = int.from_bytes(bytes(raw), "little")
    if y >= FQ:
        return None
    # x^2 = (y^2 - 1)/(d y^2 - a); pick the root matching the flag
    p = get_point_from_y(y, greatest=False)
    if p is None:
        return None
    x = p[0]
    neg = (FQ - x) % FQ
    if x_negative:
        x = max(x, neg)
    else:
        x = min(x, neg)
    return (x, y)


# --------------------------------------------------------------------------
# Pedersen CRH (ark-crypto-primitives 0.4 pedersen, Window4x256)
# --------------------------------------------------------------------------

WINDOW_SIZE = 4
NUM_WINDOWS = 256
_CAPACITY_BYTES = WINDOW_SIZE * NUM_WINDOWS // 8  # 128


def create_generators(rng: ChaCha12Rng) -> List[List[Point]]:
    """One random base per window, then WINDOW_SIZE successive doublings
    (pedersen::CRH::create_generators / generator_powers)."""
    gens = []
    for _ in range(NUM_WINDOWS):
        base = projective_rand(rng)
        powers = []
        for _ in range(WINDOW_SIZE):
            powers.append(base)
            base = edwards_double(base)
        gens.append(powers)
    return gens


def pedersen_hash(generators: List[List[Point]], data: bytes) -> Point:
    """pedersen::CRH::evaluate: zero-pad to 128 bytes, bits LSB-first
    per byte, window w sums its power table at the set bits of chunk w."""
    if len(data) > _CAPACITY_BYTES:
        raise ValueError(
            f"input {len(data)} bytes exceeds Window4x256 capacity"
        )
    data = data + bytes(_CAPACITY_BYTES - len(data))
    acc = IDENTITY
    for w in range(NUM_WINDOWS):
        for i in range(WINDOW_SIZE):
            bit_index = w * WINDOW_SIZE + i
            byte = data[bit_index >> 3]
            if (byte >> (bit_index & 7)) & 1:
                acc = edwards_add(acc, generators[w][i])
    return acc


class PedersenParams:
    """The (leaf CRH, two-to-one CRH) generator sets, drawn in the
    reference's order from one rng (relaxed-pcs/src/lib.rs:319-320)."""

    def __init__(self, rng: Optional[ChaCha12Rng] = None):
        rng = rng or ark_test_rng()
        self.leaf_generators = create_generators(rng)
        self.node_generators = create_generators(rng)


_DEFAULT_PARAMS: List[Optional[PedersenParams]] = [None]


def default_params() -> PedersenParams:
    """The ark_std::test_rng() parameters (cached — ~512 point samples)."""
    if _DEFAULT_PARAMS[0] is None:
        _DEFAULT_PARAMS[0] = PedersenParams()
    return _DEFAULT_PARAMS[0]


# --------------------------------------------------------------------------
# Merkle tree over Pedersen digests (ark-crypto-primitives merkle_tree)
# --------------------------------------------------------------------------


def _leaf_digest(params: PedersenParams, leaf: Felt) -> Point:
    """CHROverField::evaluate: the felt's canonical little-endian bytes
    (ark serialize_uncompressed width = field byte size) into the leaf
    CRH (relaxed-pcs/src/lib.rs:245-267)."""
    data = int(leaf.v).to_bytes(leaf.field.byte_size, "little")
    return pedersen_hash(params.leaf_generators, data)


def _node_digest(params: PedersenParams, left: Point, right: Point) -> Point:
    """TwoToOneCRH::compress/evaluate: CRH over the uncompressed bytes
    of both child digests (ByteDigestConverter at the leaf boundary uses
    the same uncompressed form, so every level is uniform)."""
    return pedersen_hash(
        params.node_generators,
        te_serialize_uncompressed(left) + te_serialize_uncompressed(right),
    )


class PedersenMerklePath:
    """Authentication path of compressed sibling digests (duck-types
    pcs.merkle.MerklePath for the relaxed-PCS prover/verifier). The wire
    data is the ark-compressed form; verification decompresses each
    sibling (sign flag + square root) to recompute the parent CRH."""

    def __init__(
        self,
        index: int,
        leaf_digest: bytes,
        siblings: List[bytes],
        params: Optional[PedersenParams] = None,
    ):
        self.index = index
        self.leaf_hash = leaf_digest  # compressed bytes
        self.siblings = siblings
        self._params = params or default_params()

    def verify(self, root: bytes, leaf: Felt) -> bool:
        params = self._params
        digest = _leaf_digest(params, leaf)
        if te_serialize_compressed(digest) != self.leaf_hash:
            return False
        idx = self.index
        for sib_bytes in self.siblings:
            sib = te_deserialize_compressed(sib_bytes)
            if sib is None:
                return False
            if idx & 1:
                digest = _node_digest(params, sib, digest)
            else:
                digest = _node_digest(params, digest, sib)
            idx >>= 1
        return te_serialize_compressed(digest) == root


class PedersenMerkleMultiPath:
    """Batch opening with deduplicated siblings — the Pedersen twin of
    pcs.merkle.MerkleMultiPath (same deterministic bottom-up,
    index-ascending sibling consumption order)."""

    def __init__(self, indices: List[int], height: int, siblings: List[bytes]):
        self.indices = list(indices)
        self.height = height
        self.siblings = list(siblings)
        self._params = default_params()

    def verify(self, root: bytes, leaves: Sequence[Felt]) -> bool:
        if len(leaves) != len(self.indices):
            return False
        params = self._params
        nodes = {
            i: _leaf_digest(params, v)
            for i, v in zip(self.indices, leaves)
        }
        stream = iter(self.siblings)
        try:
            for _ in range(self.height):
                nxt = {}
                for i in sorted(nodes):
                    if i ^ 1 in nodes and i % 2 == 1:
                        continue  # handled with its even partner
                    if i ^ 1 in nodes:
                        sib = nodes[i ^ 1]
                    else:
                        sib = te_deserialize_compressed(next(stream))
                        if sib is None:
                            return False
                    left, right = (
                        (nodes[i], sib) if i % 2 == 0 else (sib, nodes[i])
                    )
                    nxt[i // 2] = _node_digest(params, left, right)
                nodes = nxt
        except StopIteration:
            return False
        if next(stream, None) is not None:
            return False  # trailing unused digests
        return {
            i: te_serialize_compressed(p) for i, p in nodes.items()
        } == {0: root}


class PedersenMerkleTree:
    """Power-of-two Merkle tree over field elements with Pedersen leaf
    and two-to-one CRHs — the reference's JubJubMerkleTree shape
    (relaxed-pcs/src/lib.rs:270-284). API mirrors pcs.merkle.MerkleTree
    so relaxed.Prover can swap hash families."""

    def __init__(
        self, values: Sequence[Felt], params: Optional[PedersenParams] = None
    ):
        self.params = params or default_params()
        n = len(values)
        assert n and (n & (n - 1)) == 0, "power-of-two leaf count"
        level = [_leaf_digest(self.params, v) for v in values]
        self.levels = [level]
        while len(level) > 1:
            level = [
                _node_digest(self.params, level[2 * i], level[2 * i + 1])
                for i in range(len(level) // 2)
            ]
            self.levels.append(level)

    def root(self) -> bytes:
        return te_serialize_compressed(self.levels[-1][0])

    def generate_proof(self, index: int) -> PedersenMerklePath:
        siblings = []
        idx = index
        for level in self.levels[:-1]:
            siblings.append(te_serialize_compressed(level[idx ^ 1]))
            idx >>= 1
        return PedersenMerklePath(
            index,
            te_serialize_compressed(self.levels[0][index]),
            siblings,
            self.params,
        )

    def generate_multi_proof(self, indices: Sequence[int]) -> "PedersenMerkleMultiPath":
        """Batch opening with shared siblings emitted once, in the order
        PedersenMerkleMultiPath.verify consumes them (mirrors
        pcs.merkle.MerkleTree.generate_multi_proof)."""
        idxs = sorted(set(indices))
        assert idxs, "at least one index"
        siblings: List[bytes] = []
        cur = idxs
        for level in self.levels[:-1]:
            known = set(cur)
            nxt = []
            for i in cur:
                if i ^ 1 in known and i % 2 == 1:
                    continue
                if i ^ 1 not in known:
                    siblings.append(te_serialize_compressed(level[i ^ 1]))
                nxt.append(i // 2)
            cur = sorted(set(nxt))
        return PedersenMerkleMultiPath(
            idxs, len(self.levels) - 1, siblings
        )
