"""Goldilocks field (p = 2^64 - 2^32 + 1) arithmetic on int64 tensors.

One element per 64-bit word: an int64 tensor holds the u64 bit pattern of
the canonical value (< p). torch has no unsigned 64-bit arithmetic on the
CPU, so everything here computes on int64:

- adds and products wrap mod 2^64, which is exactly the u64 arithmetic;
- an unsigned compare flips the sign bit of both sides first (values >= 2^63
  read as negative in int64);
- ``>>`` is arithmetic on int64, so every logical shift is masked.

Reduction uses 2^64 === 2^32 - 1 =: EPS and 2^96 === -1 (mod p), as the
device functions in ``csrc/goldilocks.cuh`` do. These functions are exact on
any device; they are the plain versions the CUDA kernels are held against.
"""

from __future__ import annotations

import torch

P = (1 << 64) - (1 << 32) + 1
EPS = (1 << 32) - 1  # 2^64 mod p
MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 63)  # int64 with only the sign bit set
_P_FLIPPED = P ^ (1 << 63)  # p with its sign bit flipped, < 2^63


def to_i64(v: int) -> int:
    """A u64 value as the int64 with the same bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _reduce_once(x: torch.Tensor) -> torch.Tensor:
    """x - p where x >= p (unsigned); -p wraps to +EPS mod 2^64."""
    return torch.where((x ^ _SIGN) >= _P_FLIPPED, x + EPS, x)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular add of canonical elements."""
    s = a + b
    # a wrap lost 2^64 === EPS; a + b < 2p, so adding EPS cannot wrap again
    s = torch.where(ult(s, a), s + EPS, s)
    return _reduce_once(s)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular subtract of canonical elements."""
    d = a - b
    # a borrow added 2^64 === EPS; a - b + p lies in (0, p)
    return torch.where(ult(a, b), d - EPS, d)


def mulhi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 64 bits of the 128-bit product of two u64 bit patterns."""
    a0, a1 = a & MASK32, (a >> 32) & MASK32
    b0, b1 = b & MASK32, (b >> 32) & MASK32
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = ((p00 >> 32) & MASK32) + (p01 & MASK32) + (p10 & MASK32)  # < 3 * 2^32
    return p11 + ((p01 >> 32) & MASK32) + ((p10 >> 32) & MASK32) + (mid >> 32)


def reduce128(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(hi * 2^64 + lo) mod p for any 128-bit value: with hi = (hh, hl) in
    32-bit halves, the value is === lo - hh + hl * EPS."""
    hh, hl = (hi >> 32) & MASK32, hi & MASK32
    t0 = lo - hh
    t0 = torch.where(ult(lo, hh), t0 - EPS, t0)
    t1 = (hl << 32) - hl  # hl * EPS < 2^64
    r = t0 + t1
    r = torch.where(ult(r, t1), r + EPS, r)  # cannot wrap again
    return _reduce_once(r)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular product (exact for any u64 inputs; canonical output)."""
    return reduce128(a * b, mulhi(a, b))


def fold(lo: torch.Tensor, hi: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The sumcheck fold lo + r * (hi - lo) mod p."""
    return add(lo, mul(sub(hi, lo), r))


def sum_mod(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact modular sum along ``dim``: the 32-bit halves are summed natively
    (each sum < 2^63 < p for fewer than 2^31 terms) and recombined mod p."""
    if x.shape[dim] >= (1 << 31):
        raise ValueError("sum_mod takes fewer than 2^31 terms along dim")
    lo = (x & MASK32).sum(dim)
    hi = ((x >> 32) & MASK32).sum(dim)
    return add(lo, mul(hi, torch.full_like(hi, 1 << 32)))
