"""Carried-midstate Fiat-Shamir hash chain, batched over proofs.

The reference hashes the running concatenation of every serialized message
for each challenge draw (fiat-shamir/src/lib.rs:82-93). RFC 9380
``expand_message_xmd`` prepends a fixed 64-byte Z_pad and the transcript
only grows, so the SHA-256 midstate over ``Z_pad || transcript`` can be
carried: absorbing a message advances the midstate over its full 64-byte
blocks and keeps the remainder in a buffer; a draw finishes a copy of the
hash. Each draw costs O(1) compressions instead of O(transcript).

:class:`DevChain` holds that state for B proofs as tensors — ``state``
[B, 8] int32 (the u32 words' bits), ``buf`` [B, 64] uint8 — and the
absorbed byte count, which is a host int: every message length of the
fused FS prover is static, so every proof sits at the same offset. The
traced-offset mode of the JAX package (GKR layers) is a later slice.

The absorb/draw arithmetic runs on the card inside the FS tail kernel
(``csrc/fs_tail.cu``); :func:`absorb_py` and :func:`draw_py` are its
plain versions. Scope: the empty DST, any field of the port (at most 32
uniform bytes per draw, so one digest b_1).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..fields import GOLDILOCKS, FieldConfig
from .sha256 import H0, digest_bytes, py_compress

# midstate after the all-zero Z_pad block
ZPAD_STATE = list(H0)
py_compress(ZPAD_STATE, bytes(64))


def len_in_bytes(field: FieldConfig) -> int:
    """Uniform bytes of one element, ceil((bits(p) + 128) / 8): 17 for F5,
    18 for F389, 19 for F1572869, 20 for BabyBear, 24 for Goldilocks."""
    return (field.bit_size + 128 + 7) // 8


def _b0_suffix(length: int) -> bytes:
    """The bytes after the transcript in b_0:
    I2OSP(len_in_bytes, 2) || 0x00 || DST' with DST' = I2OSP(len(DST) = 0, 1)."""
    return length.to_bytes(2, "big") + bytes([0, 0])


@dataclasses.dataclass
class DevChain:
    """Running-concatenation FS chains of B proofs (see module docstring).

    ``buf`` row b holds the first ``nbytes % 64`` bytes of proof b's
    partial block; the rest of the row is zero."""

    state: torch.Tensor
    buf: torch.Tensor
    nbytes: int

    @classmethod
    def fresh(cls, batch: int, device) -> "DevChain":
        words = np.array([ZPAD_STATE] * batch, dtype=np.uint32).view(np.int32)
        return cls(
            state=torch.from_numpy(words).to(device),
            buf=torch.zeros((batch, 64), dtype=torch.uint8, device=device),
            nbytes=0,
        )


def absorb_py(state: List[int], buf: bytearray, nbytes: int, msg: bytes) -> None:
    """Append ``msg`` to one chain whose transcript holds ``nbytes`` bytes;
    updates ``state`` (8 u32 ints) and ``buf`` (64 bytes) in place."""
    fill = nbytes % 64
    for byte in msg:
        buf[fill] = byte
        fill += 1
        if fill == 64:
            py_compress(state, bytes(buf))
            fill = 0
    buf[fill:] = bytes(64 - fill)


def draw_py(field: FieldConfig, state: List[int], buf: bytes, nbytes: int) -> int:
    """``DefaultFieldHasher<Sha256,128>::hash_to_field::<1>`` with the empty
    DST over the chain's ``nbytes``-byte transcript: the canonical value of
    the first ``len_in_bytes(field)`` uniform bytes, big-endian, mod p."""
    length = len_in_bytes(field)
    suffix = _b0_suffix(length)
    fill = nbytes % 64
    msg_len = 64 + nbytes + len(suffix)  # Z_pad + transcript + suffix
    tail = bytes(buf[:fill]) + suffix + b"\x80"
    tail += bytes((56 - len(tail)) % 64) + (8 * msg_len).to_bytes(8, "big")
    b0 = list(state)
    for off in range(0, len(tail), 64):
        py_compress(b0, tail[off : off + 64])
    # b_1 = H(b_0 || 0x01 || DST'), one padded block of 34 message bytes
    block = digest_bytes(b0) + bytes([1, 0, 0x80]) + bytes(21) + (8 * 34).to_bytes(8, "big")
    b1 = list(H0)
    py_compress(b1, block)
    return int.from_bytes(digest_bytes(b1)[:length], "big") % field.p


def draw_gl_py(state: List[int], buf: bytes, nbytes: int) -> int:
    """:func:`draw_py` for Goldilocks."""
    return draw_py(GOLDILOCKS, state, buf, nbytes)
