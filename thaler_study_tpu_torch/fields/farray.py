"""Tensors of field elements.

:class:`FArray` is the port's counterpart of the JAX package's limb-array
``FArray``: one tensor plus its :class:`FieldConfig`.

- Goldilocks: one int64 word per element holding the canonical value's u64
  bit pattern (``goldilocks.py``).
- mont32 fields (p < 2^31: F5, F389, F1572869, BabyBear): one int32 word
  per element holding the Montgomery form x * 2^32 mod p, the JAX
  package's single u32 limb (``backend32.py``).

Codecs go through numpy ``uint64`` arrays, never through Python's int ->
float conversions (ints >= 2^63 in a plain list would turn into float64).

Every constructor takes an explicit ``device``, ``"cuda"`` by default. A
CUDA request on a machine without a card raises; nothing drops to the CPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import backend32 as b32
from . import goldilocks as gl
from .field import GOLDILOCKS, Felt, FieldConfig


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; a CUDA request needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain versions"
        )
    return dev


def word_dtype(field: FieldConfig) -> torch.dtype:
    """The tensor dtype of one element of ``field``."""
    return torch.int64 if field.backend == "goldilocks" else torch.int32


def u64_tensor(values: np.ndarray, device, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """numpy uint64 values -> a tensor on ``device``: int64 with the same
    bits, or int32 for values < 2^31."""
    arr = np.ascontiguousarray(values, dtype=np.uint64)
    if dtype == torch.int32:
        host = torch.from_numpy(arr.astype(np.int32))
    else:
        host = torch.from_numpy(arr.view(np.int64).copy())
    return host.to(resolve_device(device))


def tensor_u64(t: torch.Tensor) -> np.ndarray:
    """int64 (u64 bits) or int32 (non-negative) tensor -> numpy uint64
    values (host copy)."""
    host = t.detach().cpu().contiguous().numpy()
    return host.astype(np.uint64) if host.dtype == np.int32 else host.view(np.uint64)


def _host_u64(values, field: FieldConfig) -> np.ndarray:
    """A numpy integer array as uint64 (taken as it is, values of any size);
    ints or Felts reduced mod p with Python ints."""
    if isinstance(values, np.ndarray) and np.issubdtype(values.dtype, np.integer):
        return np.ascontiguousarray(values, dtype=np.uint64)
    obj = np.asarray(values, dtype=object)
    return np.array([int(v) % field.p for v in obj.ravel()], dtype=np.uint64).reshape(obj.shape)


def _words(u: torch.Tensor, field: FieldConfig) -> torch.Tensor:
    """int64 tensor of u64 bit patterns -> the field's words, reduced mod p
    (mont32: Montgomery), computed on the tensor's device."""
    if field.backend == "goldilocks":
        return gl.canonical(u)
    p = field.p
    lo, hi = u & b32.MASK32, (u >> 32) & b32.MASK32
    return b32.to_mont(p, (hi % p * ((1 << 32) % p) + lo % p) % p)


class FArray:
    """An n-dimensional array of field elements in one tensor (module doc)."""

    __slots__ = ("data", "field")

    def __init__(self, data: torch.Tensor, field: FieldConfig):
        if data.dtype != word_dtype(field):
            raise TypeError(f"{field.name} FArray data must be {word_dtype(field)}, got {data.dtype}")
        self.data = data
        self.field = field

    # -- shape --
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def reshape(self, *shape) -> "FArray":
        return FArray(self.data.reshape(*shape), self.field)

    def __getitem__(self, idx) -> "FArray":
        return FArray(self.data[idx], self.field)

    # -- constructors --
    @classmethod
    def from_ints(cls, values, field: FieldConfig, device="cuda") -> "FArray":
        """Build from Python ints or a numpy integer array (reduced mod p;
        mont32 values go to their Montgomery words). A numpy array crosses
        to ``device`` as it is and is reduced there."""
        vals = _host_u64(values, field)
        return cls(_words(torch.from_numpy(vals.view(np.int64)).to(resolve_device(device)), field), field)

    @classmethod
    def from_felts(cls, felts: Sequence[Felt], field: FieldConfig = None, device="cuda") -> "FArray":
        field = field or felts[0].field
        return cls.from_ints([f.v for f in felts], field, device=device)

    @classmethod
    def from_jax_limbs(cls, *limbs, field: FieldConfig = None, device="cuda") -> "FArray":
        """The JAX package's uint32 limb arrays -> an FArray holding the same
        elements (the state carried across): Goldilocks (lo, hi) canonical
        limbs, or one Montgomery limb for a mont32 field."""
        field = GOLDILOCKS if field is None else field
        want = 2 if field.backend == "goldilocks" else 1
        arrs = [np.asarray(x) for x in limbs]
        if len(arrs) != want or any(a.dtype != np.uint32 for a in arrs):
            raise TypeError(f"{field.name} takes {want} uint32 limb array(s)")
        vals = arrs[0].astype(np.uint64)
        if want == 2:
            vals |= arrs[1].astype(np.uint64) << np.uint64(32)
        if (vals >= np.uint64(field.p)).any():
            raise ValueError("limbs hold a non-canonical word (>= p)")
        return cls(u64_tensor(vals, device, word_dtype(field)), field)

    @classmethod
    def zeros(cls, shape, field: FieldConfig, device="cuda") -> "FArray":
        return cls(torch.zeros(shape, dtype=word_dtype(field), device=resolve_device(device)), field)

    @classmethod
    def scalar(cls, value: Felt, device="cuda") -> "FArray":
        """A 0-d FArray (broadcasts against any shape)."""
        return cls.from_ints([value.v], value.field, device=device).reshape(())

    # -- extraction (device -> host, exact) --
    def to_u64(self) -> np.ndarray:
        """Canonical values as numpy uint64."""
        vals = tensor_u64(self.data)
        if self.field.backend == "mont32":
            p = self.field.p
            # word * R^-1 mod p: both factors < 2^31
            vals = vals * np.uint64(pow(self.field.mont_r, -1, p)) % np.uint64(p)
        return vals

    def to_ints(self) -> np.ndarray:
        """Canonical integer values as a numpy object array."""
        return self.to_u64().astype(object)

    def to_felts(self) -> list:
        return [Felt(int(v), self.field) for v in self.to_u64().ravel()]

    def item(self) -> Felt:
        vals = self.to_u64().ravel()
        if vals.size != 1:
            raise ValueError(f"item() of an FArray of shape {self.shape}")
        return Felt(int(vals[0]), self.field)

    # -- arithmetic (elementwise, broadcasting like torch) --
    def _coerce(self, other) -> "FArray":
        if isinstance(other, FArray):
            return other
        if isinstance(other, Felt):
            return FArray.scalar(other, device=self.device)
        raise TypeError(f"cannot operate FArray with {type(other)}")

    def _binary(self, other, gl_op, m32_op) -> "FArray":
        o = self._coerce(other).data
        if self.field.backend == "goldilocks":
            return FArray(gl_op(self.data, o), self.field)
        return FArray(m32_op(self.field.p, self.data, o), self.field)

    def __add__(self, other) -> "FArray":
        return self._binary(other, gl.add, b32.add)

    def __sub__(self, other) -> "FArray":
        return self._binary(other, gl.sub, b32.sub)

    def __mul__(self, other) -> "FArray":
        return self._binary(other, gl.mul, b32.mont_mul)

    def __neg__(self) -> "FArray":
        if self.field.backend == "goldilocks":
            return FArray(gl.sub(torch.zeros_like(self.data), self.data), self.field)
        return FArray(b32.neg(self.field.p, self.data), self.field)

    @classmethod
    def fold(cls, lo: "FArray", hi: "FArray", r) -> "FArray":
        """The sumcheck fold lo + r*(hi - lo) (reference identity:
        matrix-multiplication/src/lib.rs:114-122)."""
        rd = lo._coerce(r).data
        if lo.field.backend == "goldilocks":
            return cls(gl.fold(lo.data, hi.data, rd), lo.field)
        return cls(b32.fold(lo.field.p, lo.data, hi.data, rd), lo.field)

    def sum(self, axis: int = 0) -> "FArray":
        """Exact modular reduction along one axis."""
        if self.field.backend == "goldilocks":
            return FArray(gl.sum_mod(self.data, axis), self.field)
        return FArray(b32.sum_mod(self.field.p, self.data, axis), self.field)

    def __repr__(self):
        return f"FArray({self.field.name}, shape={self.shape}, device={self.device})"
