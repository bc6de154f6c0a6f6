"""Field configuration and exact host-side scalars.

Host-side protocol state (verifier checks, univariate round polynomials,
transcript challenges) uses :class:`Felt` — arbitrary-precision Python integers
reduced mod p. This mirrors the reference where the verifier is plain Rust over
arkworks scalars (sum-check-protocol/src/lib.rs:227-331). Bulk data lives in
int64 tensors, one element per 64-bit word (see ``farray.py``).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache


def _bit_size(p: int) -> int:
    return p.bit_length()


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """A prime field F_p.

    ``backend`` names the tensor representation:

    - ``"mont32"``:  p < 2^31 (the reference test fields 5, 389, 1572869
      and BabyBear). Host scalars work; tensors of these fields are not
      ported yet (``FArray`` raises).
    - ``"goldilocks"``: p = 2^64 - 2^32 + 1. One int64 word per element
      holding the canonical value's u64 bit pattern; the special reduction
      2^64 === 2^32 - 1 (mod p) makes Montgomery unnecessary.
    """

    p: int
    name: str = ""

    def __post_init__(self):
        if self.p < 2 or not _is_probable_prime(self.p):
            raise ValueError(f"modulus {self.p} is not prime")
        if not self.name:
            object.__setattr__(self, "name", f"F{self.p}")

    # ---- derived, cached ----
    @property
    def backend(self) -> str:
        if self.p == GOLDILOCKS_P:
            return "goldilocks"
        if self.p < (1 << 31):
            return "mont32"
        raise NotImplementedError(
            f"no device backend for {self.p.bit_length()}-bit modulus {self.p}"
        )

    @property
    def bit_size(self) -> int:
        """Number of bits of p (arkworks MODULUS_BIT_SIZE)."""
        return _bit_size(self.p)

    @property
    def byte_size(self) -> int:
        """Serialized size of one canonical element: ceil(MODULUS_BIT_SIZE/8).

        ark-ff's ``Fp::serialize_with_flags`` (arkworks 0.6, the version the
        reference's workspace Cargo.toml pins) writes
        ``buffer_byte_size(MODULUS_BIT_SIZE + Flags::BIT_SIZE)`` bytes of the
        little-endian canonical integer; ``CanonicalSerialize`` uses
        ``EmptyFlags`` (BIT_SIZE = 0), so the width is ceil(bits(p)/8) — NOT
        the limb width. F5 -> 1 byte, F389 -> 2, F1572869 -> 3,
        Goldilocks -> 8. Transcript bit-exactness vs the Rust reference
        (fiat-shamir/src/lib.rs:48-58) depends on this width.
        """
        return (self.bit_size + 7) // 8

    # Montgomery constants for mont32
    @property
    def mont_r(self) -> int:
        return (1 << 32) % self.p

    @property
    def mont_r2(self) -> int:
        return (self.mont_r * self.mont_r) % self.p

    @property
    def mont_pinv_neg(self) -> int:
        """-p^{-1} mod 2^32 (for Montgomery REDC)."""
        return (-pow(self.p, -1, 1 << 32)) % (1 << 32)

    # ---- host scalar constructors ----
    def felt(self, v: int) -> "Felt":
        return Felt(v % self.p, self)

    def zero(self) -> "Felt":
        return Felt(0, self)

    def one(self) -> "Felt":
        return Felt(1, self)

    def felts(self, vs) -> list:
        return [self.felt(int(v)) for v in vs]

    def rand(self, rng) -> "Felt":
        """Draw a uniform element using a python ``random.Random``-like rng."""
        return self.felt(rng.randrange(self.p))


def _is_probable_prime(n: int) -> bool:
    if n < 2:
        return False
    for q in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % q == 0:
            return n == q
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


class Felt:
    """An exact field element for host-side protocol logic.

    Cheap, hashable, and closed under arithmetic; the device hot path never
    touches this class.
    """

    __slots__ = ("v", "field")

    def __init__(self, v: int, field: FieldConfig):
        self.v = v % field.p
        self.field = field

    # -- arithmetic --
    def __add__(self, o: "Felt") -> "Felt":
        return Felt(self.v + o.v, self.field)

    def __sub__(self, o: "Felt") -> "Felt":
        return Felt(self.v - o.v, self.field)

    def __mul__(self, o: "Felt") -> "Felt":
        return Felt(self.v * o.v, self.field)

    def __neg__(self) -> "Felt":
        return Felt(-self.v, self.field)

    def __truediv__(self, o: "Felt") -> "Felt":
        return self * o.inverse()

    def __pow__(self, e: int) -> "Felt":
        return Felt(pow(self.v, e, self.field.p), self.field)

    def inverse(self) -> "Felt":
        if self.v == 0:
            raise ZeroDivisionError("inverse of zero field element")
        return Felt(pow(self.v, -1, self.field.p), self.field)

    def double(self) -> "Felt":
        return Felt(self.v * 2, self.field)

    # -- predicates / conversions --
    def is_zero(self) -> bool:
        return self.v == 0

    def is_one(self) -> bool:
        return self.v == 1

    def __int__(self) -> int:
        return self.v

    def __index__(self) -> int:
        return self.v

    def __eq__(self, o) -> bool:
        return isinstance(o, Felt) and self.v == o.v and self.field.p == o.field.p

    def __hash__(self):
        return hash((self.v, self.field.p))

    def __repr__(self):
        return f"{self.v}_{self.field.name}"

    def to_bytes_le(self) -> bytes:
        """arkworks CanonicalSerialize (uncompressed) of an Fp64 element:
        the canonical integer as 8 bytes little-endian
        (fiat-shamir/src/lib.rs:48-58 relies on this)."""
        return self.v.to_bytes(self.field.byte_size, "little")

    @classmethod
    def from_bytes_le(cls, b: bytes, field: FieldConfig) -> "Felt":
        v = int.from_bytes(b, "little")
        if v >= field.p:
            raise ValueError("non-canonical field element bytes")
        return cls(v, field)


class FeltVector:
    """A vector of field elements stored in bulk (int list or uint64 array).

    Megabyte-scale protocol messages (the GKR ``Begin`` claim over a
    2^20-gate output layer) would otherwise construct one :class:`Felt`
    object per element (~1 us each — seconds per message at 2^24 gates).
    This behaves like ``List[Felt]`` (len / index / slice / iterate /
    compare) while keeping the data bulk; bulk consumers read ``.ints``
    directly (the verifier's MLE evaluation and the serializer both accept
    either representation)."""

    __slots__ = ("ints", "field")

    def __init__(self, ints, field: FieldConfig):
        self.ints = ints  # List[int] or np.ndarray[uint64]
        self.field = field

    def __len__(self) -> int:
        return len(self.ints)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [Felt(int(v), self.field) for v in self.ints[i]]
        return Felt(int(self.ints[i]), self.field)

    def __iter__(self):
        field = self.field
        for v in self.ints:
            yield Felt(int(v), field)

    def __eq__(self, other) -> bool:
        if isinstance(other, FeltVector):
            if self.field != other.field or len(self.ints) != len(other.ints):
                return False
            return all(int(a) == int(b) for a, b in zip(self.ints, other.ints))
        if isinstance(other, (list, tuple)):
            return len(other) == len(self.ints) and all(
                isinstance(f, Felt) and f.v == int(v)
                for f, v in zip(other, self.ints)
            )
        return NotImplemented

    def __repr__(self) -> str:
        return f"FeltVector(n={len(self.ints)}, field={self.field.name})"


GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1


@lru_cache(maxsize=None)
def _mkfield(p: int, name: str) -> FieldConfig:
    return FieldConfig(p, name)


# Reference test fields (sum-check-protocol/src/lib.rs:349-354,
# gkr-protocol/src/lib.rs:509-514, triangle-counting/src/lib.rs:272-277)
F5 = _mkfield(5, "F5")
F389 = _mkfield(389, "F389")
F1572869 = _mkfield(1572869, "F1572869")

# Production fields
GOLDILOCKS = _mkfield(GOLDILOCKS_P, "Goldilocks")
BABYBEAR = _mkfield((1 << 31) - (1 << 27) + 1, "BabyBear")
