"""Prime-field arithmetic for the port.

A field is described by a :class:`FieldConfig`; host-side scalars are
exact-integer :class:`Felt` values; tensors of Goldilocks elements are
:class:`FArray` (one int64 word per element), computed on by the plain
torch functions in ``goldilocks`` and by the device functions in
``csrc/goldilocks.cuh``.
"""

from .field import FieldConfig, Felt, FeltVector, F5, F389, F1572869, GOLDILOCKS, BABYBEAR
from .farray import FArray

__all__ = [
    "FieldConfig",
    "Felt",
    "FeltVector",
    "FArray",
    "F5",
    "F389",
    "F1572869",
    "GOLDILOCKS",
    "BABYBEAR",
]
