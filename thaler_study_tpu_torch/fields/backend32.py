"""Montgomery field arithmetic for p < 2^31 on int32 tensors.

Counterpart of ``thaler_study_tpu/fields/backend32.py``. An element is
stored as its Montgomery word x * 2^32 mod p (R = 2^32), the JAX package's
one u32 limb: every word is < p < 2^31, so it is a non-negative int32 and
the two packages compare word for word. The CUDA side is
``csrc/mont32.cuh``; these functions are the plain versions its kernels are
held against, exact on any device.

torch has no unsigned 32-bit arithmetic on the CPU, so products widen to
int64: a * b < p^2 < 2^62 fits, but t + m * p of the textbook REDC does
not, so REDC adds the high words t_hi + (m p)_hi + carry, as the JAX
package does. Adds and subtracts stay in int32: a - p + b lies in (-p, p).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def pinv_neg(p: int) -> int:
    """-p^{-1} mod 2^32, the REDC constant."""
    return (-pow(p, -1, 1 << 32)) % (1 << 32)


def redc64(p: int, t: torch.Tensor) -> torch.Tensor:
    """t * 2^-32 mod p for an int64 t in [0, p * 2^32); int32 result < p."""
    m = ((t & MASK32) * pinv_neg(p)) & MASK32  # the product wraps mod 2^64
    # t_lo + (m p)_lo === 0 mod 2^32; the carry out of it is 1 iff t_lo != 0
    u = (t >> 32) + ((m * p) >> 32) + ((t & MASK32) != 0).to(torch.int64)
    return torch.where(u >= p, u - p, u).to(torch.int32)


def mont_mul(p: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * 2^-32 mod p of two words."""
    return redc64(p, a.to(torch.int64) * b.to(torch.int64))


def add(p: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = (a - p) + b
    return torch.where(s < 0, s + p, s)


def sub(p: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + p, d)


def neg(p: int, a: torch.Tensor) -> torch.Tensor:
    return torch.where(a == 0, a, p - a)


def to_mont(p: int, a: torch.Tensor) -> torch.Tensor:
    """Canonical values (< p) -> Montgomery words."""
    return ((a.to(torch.int64) << 32) % p).to(torch.int32)


def from_mont(p: int, a: torch.Tensor) -> torch.Tensor:
    """Montgomery words -> canonical values: REDC(a)."""
    return redc64(p, a.to(torch.int64))


def fold(p: int, lo: torch.Tensor, hi: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The sumcheck fold lo + r * (hi - lo), all Montgomery words."""
    return add(p, lo, mont_mul(p, sub(p, hi, lo), r))


def sum_mod(p: int, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact modular sum along ``dim``: words < 2^31 sum natively in int64
    for fewer than 2^32 terms. The sum of Montgomery words is the
    Montgomery word of the sum."""
    if x.shape[dim] >= (1 << 32):
        raise ValueError("sum_mod takes fewer than 2^32 terms along dim")
    return (x.to(torch.int64).sum(dim) % p).to(torch.int32)


def dot_mod(p: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(mont_mul(a, b)) over all elements with one REDC: the raw products
    R^2 x y are summed in 32-bit halves (each half-sum < 2^63 for fewer than
    2^31 terms), combined mod p, and REDC takes R^2 sum(xy) to its word."""
    t = (a.to(torch.int64) * b.to(torch.int64)).reshape(-1)
    if t.numel() >= (1 << 31):
        raise ValueError("dot_mod takes fewer than 2^31 products")
    lo = (t & MASK32).sum() % p
    hi = (t >> 32).sum() % p
    return redc64(p, (hi * ((1 << 32) % p) + lo) % p)
