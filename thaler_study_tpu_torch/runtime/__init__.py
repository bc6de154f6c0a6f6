"""Host C++ runtime: exact u64 field work for the GKR verifier.

Counterpart of ``thaler_study_tpu/runtime``: ``native.cpp`` here is the
port's own copy of the functions it uses (eq tables, the sparse wiring
predicate evaluation, MLE evaluation), built with ``g++`` into ``_build/``
at first use (``_build.load_host``). A failed build raises; there is no
Python fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build

_U64P = ctypes.POINTER(ctypes.c_uint64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_host("native")
        lib.ts_eq_table.argtypes = [_U64P, ctypes.c_int32, _U64P, ctypes.c_uint64]
        lib.ts_wiring_eval_sparse.argtypes = [
            _U64P, _U64P, _U64P, _I32P, _I32P, _U8P, ctypes.c_int64, ctypes.c_uint64,
        ]
        lib.ts_wiring_eval_sparse.restype = ctypes.c_uint64
        lib.ts_mle_eval.argtypes = [_U64P, ctypes.c_int64, _U64P, ctypes.c_int32, _U64P, ctypes.c_uint64]
        lib.ts_mle_eval.restype = ctypes.c_uint64
        _lib = lib
    return _lib


def _u64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint64)


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def eq_table(r, p: int) -> np.ndarray:
    """eq weights over little-endian indices (index bit j = r[j])."""
    r = _u64(r)
    out = np.empty(1 << len(r), dtype=np.uint64)
    _load().ts_eq_table(_ptr(r, _U64P), len(r), _ptr(out, _U64P), p)
    return out


def wiring_eval_sparse(eq_r, eq_b, eq_c, b_idx, c_idx, sel, p: int) -> int:
    """sum over selected gates g of eq_r[g] eq_b[b_g] eq_c[c_g] mod p."""
    eq_r, eq_b, eq_c = _u64(eq_r), _u64(eq_b), _u64(eq_c)
    b_idx = np.ascontiguousarray(b_idx, dtype=np.int32)
    c_idx = np.ascontiguousarray(c_idx, dtype=np.int32)
    sel = np.ascontiguousarray(sel, dtype=np.uint8)
    return int(
        _load().ts_wiring_eval_sparse(
            _ptr(eq_r, _U64P), _ptr(eq_b, _U64P), _ptr(eq_c, _U64P),
            _ptr(b_idx, _I32P), _ptr(c_idx, _I32P), _ptr(sel, _U8P), len(b_idx), p,
        )
    )


def mle_eval(evals, point, p: int) -> int:
    """Exact MLE evaluation at ``point`` (little-endian variable order)."""
    evals, point = _u64(evals), _u64(point)
    scratch = np.empty(max(len(evals) // 2, 1), dtype=np.uint64)
    return int(
        _load().ts_mle_eval(
            _ptr(evals, _U64P), len(evals), _ptr(point, _U64P), len(point), _ptr(scratch, _U64P), p
        )
    )
