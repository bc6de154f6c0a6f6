"""SHA-256 hash-to-field, byte-compatible with arkworks' DefaultFieldHasher.

The reference draws every Fiat-Shamir challenge as
``DefaultFieldHasher<Sha256>::hash_to_field::<1>(transcript_bytes)`` with an
empty domain-separation tag (fiat-shamir/src/lib.rs:78-88,221-229).

ark-ff's ``DefaultFieldHasher`` (SEC_PARAM = 128) is RFC 9380
``expand_message_xmd`` (the 64-byte SHA-256 input block size supplies
Z_pad) followed by big-endian reduction:

  len_per_base_elem = ceil((MODULUS_BIT_SIZE + 128) / 8)
  uniform = expand_message_xmd(msg, dst, len_per_base_elem)
  element = int.from_bytes(uniform, 'big') mod p

Host code (challenges are O(rounds) scalars). The device chain lives in
``ops/sha_chain.py`` and inside the FS tail kernel.
"""

from __future__ import annotations

import hashlib

from ..fields import Felt, FieldConfig

_LONG_DST_PREFIX = b"H2C-OVERSIZE-DST-"


def expand_message_xmd(
    msg: bytes, dst: bytes, len_in_bytes: int, block_size: int = 64
) -> bytes:
    """RFC 9380 expand_message_xmd with SHA-256."""
    b_len = 32  # SHA-256 output size
    ell = (len_in_bytes + b_len - 1) // b_len
    if ell > 255:
        raise ValueError("expand_message_xmd: ell > 255")
    if len_in_bytes > 0xFFFF:
        raise ValueError("expand_message_xmd: len_in_bytes too large")
    if len(dst) > 255:
        dst = hashlib.sha256(_LONG_DST_PREFIX + dst).digest()
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(block_size)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b_0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    return _expand_from_b0(b_0, dst_prime, len_in_bytes)


def _expand_from_b0(b_0: bytes, dst_prime: bytes, len_in_bytes: int) -> bytes:
    """The b_1 .. b_ell tail of expand_message_xmd."""
    ell = (len_in_bytes + 31) // 32
    b_i = hashlib.sha256(b_0 + b"\x01" + dst_prime).digest()
    uniform = bytearray(b_i)
    for i in range(2, ell + 1):
        mixed = bytes(x ^ y for x, y in zip(b_0, b_i))
        b_i = hashlib.sha256(mixed + bytes([i]) + dst_prime).digest()
        uniform.extend(b_i)
    return bytes(uniform[:len_in_bytes])


def _to_field(uniform: bytes, field: FieldConfig, width: int, count: int) -> list:
    return [
        Felt(int.from_bytes(uniform[i * width : (i + 1) * width], "big") % field.p, field)
        for i in range(count)
    ]


class DefaultFieldHasher:
    """ark-ff ``DefaultFieldHasher<Sha256, 128>`` clone for prime fields."""

    SEC_PARAM = 128

    def __init__(self, field: FieldConfig, dst: bytes = b""):
        self.field = field
        self.dst = dst
        self.len_per_base_elem = (field.bit_size + self.SEC_PARAM + 7) // 8

    def hash_to_field(self, msg: bytes, count: int = 1) -> list:
        """The ``hash_to_field::<N>`` call; extension degree m = 1."""
        uniform = expand_message_xmd(msg, self.dst, count * self.len_per_base_elem)
        return _to_field(uniform, self.field, self.len_per_base_elem, count)


class XmdChain:
    """Incremental ``DefaultFieldHasher`` over a *growing* message prefix.

    The reference derives challenge j by re-hashing the full running
    concatenation g_1||...||g_j (fiat-shamir/src/lib.rs:82-93). RFC 9380's
    ``b_0 = SHA256(Z_pad || msg || l_i_b || 0x00 || DST')`` starts with one
    whole 64-byte block, so the chain carries a SHA-256 object over
    ``Z_pad || msg`` and finishes a copy of it per draw: O(new bytes +
    suffix) per draw, byte-identical to
    ``DefaultFieldHasher(field, dst).hash_to_field(msg_so_far, count)``.
    """

    def __init__(self, field: FieldConfig, dst: bytes = b""):
        self.field = field
        if len(dst) > 255:
            dst = hashlib.sha256(_LONG_DST_PREFIX + dst).digest()
        self.dst_prime = dst + bytes([len(dst)])
        self.len_per_base_elem = (
            field.bit_size + DefaultFieldHasher.SEC_PARAM + 7
        ) // 8
        self._sha = hashlib.sha256(bytes(64))  # Z_pad block

    def absorb(self, data: bytes) -> None:
        self._sha.update(bytes(data))

    def draw(self, count: int = 1) -> list:
        if count == 0:
            return []
        len_in_bytes = count * self.len_per_base_elem
        if (len_in_bytes + 31) // 32 > 255:
            raise ValueError("expand_message_xmd: ell > 255")
        sha = self._sha.copy()
        sha.update(len_in_bytes.to_bytes(2, "big") + b"\x00" + self.dst_prime)
        uniform = _expand_from_b0(sha.digest(), self.dst_prime, len_in_bytes)
        return _to_field(uniform, self.field, self.len_per_base_elem, count)
