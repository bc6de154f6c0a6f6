"""Tensors of Goldilocks field elements.

:class:`FArray` is the port's counterpart of the JAX package's limb-array
``FArray``: one int64 tensor holding each canonical element's u64 bit
pattern, plus its :class:`FieldConfig`. Only Goldilocks is ported; the
mont32 fields (p < 2^31) raise. Codecs go through ``numpy.uint64`` views,
never through Python's int -> float conversions (ints >= 2^63 in a plain
list would turn into float64).

Every constructor takes an explicit ``device``, ``"cuda"`` by default. A
CUDA request on a machine without a card raises; nothing drops to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from . import goldilocks as gl
from .field import Felt, FieldConfig


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; a CUDA request needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain versions"
        )
    return dev


def _check_field(field: FieldConfig) -> None:
    if field.backend != "goldilocks":
        raise NotImplementedError(
            f"{field.name}: mont32 field tensors are a later slice of the "
            "port; only Goldilocks is ported"
        )


def u64_tensor(values: np.ndarray, device) -> torch.Tensor:
    """numpy uint64 values -> int64 tensor with the same bits on ``device``."""
    arr = np.ascontiguousarray(values, dtype=np.uint64)
    return torch.from_numpy(arr.view(np.int64).copy()).to(resolve_device(device))


def tensor_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 values with the same bits (host copy)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


class FArray:
    """An n-dimensional array of Goldilocks elements in one int64 tensor."""

    __slots__ = ("data", "field")

    def __init__(self, data: torch.Tensor, field: FieldConfig):
        _check_field(field)
        if data.dtype != torch.int64:
            raise TypeError(f"FArray data must be int64, got {data.dtype}")
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
        """Build from Python ints or a numpy integer array (reduced mod p)."""
        _check_field(field)
        p = np.uint64(field.p)
        if isinstance(values, np.ndarray) and np.issubdtype(
            values.dtype, np.integer
        ):
            vals = values.astype(np.uint64)
            if (vals >= p).any():
                vals = vals % p
        else:
            obj = np.asarray(values, dtype=object)
            vals = np.array(
                [int(v) % field.p for v in obj.ravel()], dtype=np.uint64
            ).reshape(obj.shape)
        return cls(u64_tensor(vals, device), field)

    @classmethod
    def from_jax_limbs(cls, lo, hi, field: FieldConfig = None, device="cuda"):
        """The JAX package's canonical (lo, hi) uint32 limb arrays -> an
        FArray holding the same elements (the state carried across)."""
        from .field import GOLDILOCKS

        field = GOLDILOCKS if field is None else field
        _check_field(field)
        lo = np.asarray(lo)
        hi = np.asarray(hi)
        if lo.dtype != np.uint32 or hi.dtype != np.uint32:
            raise TypeError("limbs must be uint32 arrays")
        vals = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
        if (vals >= np.uint64(field.p)).any():
            raise ValueError("limbs hold a non-canonical element (>= p)")
        return cls(u64_tensor(vals, device), field)

    @classmethod
    def scalar(cls, value: Felt, device="cuda") -> "FArray":
        """A 0-d FArray (broadcasts against any shape)."""
        return cls.from_ints([value.v], value.field, device=device).reshape(())

    # -- extraction (device -> host, exact) --
    def to_u64(self) -> np.ndarray:
        return tensor_u64(self.data)

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

    def __add__(self, other) -> "FArray":
        return FArray(gl.add(self.data, self._coerce(other).data), self.field)

    def __sub__(self, other) -> "FArray":
        return FArray(gl.sub(self.data, self._coerce(other).data), self.field)

    def __mul__(self, other) -> "FArray":
        return FArray(gl.mul(self.data, self._coerce(other).data), self.field)

    @classmethod
    def fold(cls, lo: "FArray", hi: "FArray", r) -> "FArray":
        """The sumcheck fold lo + r*(hi - lo) (reference identity:
        matrix-multiplication/src/lib.rs:114-122)."""
        return cls(gl.fold(lo.data, hi.data, lo._coerce(r).data), lo.field)

    def sum(self, axis: int = 0) -> "FArray":
        """Exact modular reduction along one axis."""
        return FArray(gl.sum_mod(self.data, axis), self.field)

    def __repr__(self):
        return f"FArray({self.field.name}, shape={self.shape}, device={self.device})"
