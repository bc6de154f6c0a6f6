"""arkworks-compatible canonical serialization (uncompressed).

Byte-level clone of what the reference's Fiat-Shamir transform writes into
transcripts (fiat-shamir/src/lib.rs:44-66). Pinned assumptions (arkworks 0.6,
the version the reference's workspace Cargo.toml selects):

- ``Fp`` element: ark-ff ``Fp::serialize_with_flags`` writes the canonical
  (non-Montgomery) integer little-endian, truncated to
  ``buffer_byte_size(MODULUS_BIT_SIZE + Flags::BIT_SIZE)`` bytes;
  ``CanonicalSerialize`` passes ``EmptyFlags`` (BIT_SIZE = 0), so the width
  is **ceil(bits(p)/8)** — 1 byte for F5, 2 for F389, 3 for F1572869, 8 for
  Goldilocks. Deserialization rejects values >= p (``Fp::from_bigint``).
- ``univariate::SparsePolynomial<F>`` (derived CanonicalSerialize on
  ``struct { coeffs: Vec<(usize, F)> }``): u64-LE length prefix (Vec), then
  per term a u64-LE degree (ark-serialize writes usize as u64 LE) and the
  coefficient bytes. Terms sorted by degree, zero coefficients dropped
  (``SparsePolynomial::from_coefficients`` invariant).
- tuple ``(F, SparsePolynomial<F>)``: element-wise concatenation, no prefix.

These assumptions are anchored *externally* by tests/data/fs_golden.json:
vectors derived by tests/data/derive_fs_golden.py using only hashlib and
Python integers (no framework imports) — see tests/test_fs_golden.py.
Bit-exact transcripts vs the Rust reference hinge on these layouts plus the
hash-to-field in ``hash_to_field.py`` (SURVEY.md section 3.2: the FS path is
the deterministic bit-exactness anchor).
"""

from __future__ import annotations

import struct

from ..fields import Felt, FieldConfig
from ..sumcheck.univariate import UniPoly


def serialize_felt(f: Felt) -> bytes:
    return f.v.to_bytes(f.field.byte_size, "little")


def deserialize_felt(data: bytes, offset: int, field: FieldConfig) -> tuple:
    size = field.byte_size
    v = int.from_bytes(data[offset : offset + size], "little")
    if v >= field.p:
        raise ValueError("non-canonical field element")
    return Felt(v, field), offset + size


def serialize_unipoly(p: UniPoly) -> bytes:
    out = [struct.pack("<Q", len(p.terms))]
    for d, c in p.terms:
        out.append(struct.pack("<Q", d))
        out.append(serialize_felt(c))
    return b"".join(out)


def deserialize_unipoly(
    data: bytes, offset: int, field: FieldConfig
) -> tuple:
    (n,) = struct.unpack_from("<Q", data, offset)
    offset += 8
    terms = []
    for _ in range(n):
        (d,) = struct.unpack_from("<Q", data, offset)
        offset += 8
        c, offset = deserialize_felt(data, offset, field)
        terms.append((d, c))
    return UniPoly(terms, field), offset


def serialize_c1_and_poly(c_1: Felt, p: UniPoly) -> bytes:
    """The round-0 message: the tuple (c_1, g_1) (ref :48-51)."""
    return serialize_felt(c_1) + serialize_unipoly(p)


def deserialize_c1_and_poly(data: bytes, field: FieldConfig) -> tuple:
    c_1, offset = deserialize_felt(data, 0, field)
    p, offset = deserialize_unipoly(data, offset, field)
    if offset != len(data):
        raise ValueError("trailing bytes in round-0 message")
    return c_1, p
