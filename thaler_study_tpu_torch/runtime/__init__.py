"""Host C++ runtime: exact u64 field work for the GKR verifier.

Counterpart of ``thaler_study_tpu/runtime``: ``native.cpp`` here is the
port's own copy of the functions it uses (eq tables, the dense wiring
scatter, the sparse wiring predicate evaluation, MLE evaluation, the
SHA-256 midstate), built with ``g++`` into ``_build/``
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
        lib.ts_wiring_scatter.argtypes = [
            _I32P, _I32P, _U8P, _U64P, ctypes.c_int64, ctypes.c_int32, _U64P, ctypes.c_uint64,
        ]
        lib.ts_mle_eval.argtypes = [_U64P, ctypes.c_int64, _U64P, ctypes.c_int32, _U64P, ctypes.c_uint64]
        lib.ts_mle_eval.restype = ctypes.c_uint64
        lib.ts_sha256_blocks.argtypes = [_U8P, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32)]
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


def wiring_scatter(b_idx, c_idx, sel, eq_w, k_next: int, p: int) -> np.ndarray:
    """The dense wiring table over (b, c): grid[(c << k_next) | b] = sum of
    eq_w[g] mod p over the selected gates g wired to (b, c)."""
    b_idx = np.ascontiguousarray(b_idx, dtype=np.int32)
    c_idx = np.ascontiguousarray(c_idx, dtype=np.int32)
    sel = np.ascontiguousarray(sel, dtype=np.uint8)
    eq_w = _u64(eq_w)
    if not len(b_idx) == len(c_idx) == len(sel) == len(eq_w):
        raise ValueError("one b, c, selection flag and eq weight per gate")
    size = 1 << k_next
    if len(b_idx) and (min(b_idx.min(), c_idx.min()) < 0 or max(b_idx.max(), c_idx.max()) >= size):
        raise ValueError(f"a wire label lies outside the next layer's {size} values")
    grid = np.zeros(1 << (2 * k_next), dtype=np.uint64)
    _load().ts_wiring_scatter(
        _ptr(b_idx, _I32P), _ptr(c_idx, _I32P), _ptr(sel, _U8P), _ptr(eq_w, _U64P), len(b_idx), k_next,
        _ptr(grid, _U64P), p,
    )
    return grid


def mle_eval(evals, point, p: int) -> int:
    """Exact MLE evaluation at ``point`` (little-endian variable order)."""
    evals, point = _u64(evals), _u64(point)
    scratch = np.empty(max(len(evals) // 2, 1), dtype=np.uint64)
    return int(
        _load().ts_mle_eval(
            _ptr(evals, _U64P), len(evals), _ptr(point, _U64P), len(point), _ptr(scratch, _U64P), p
        )
    )


# SHA-256 initial hash value (FIPS 180-4)
_SHA256_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)


def sha256_midstate(data: bytes, state=None) -> np.ndarray:
    """Advance a SHA-256 midstate over ``data``, whole 64-byte blocks
    (``len(data) % 64 == 0``), from ``state`` (8 u32 words; the initial hash
    value when None). Returns the new state as a numpy uint32 [8]: a large
    Fiat-Shamir prefix is absorbed once, by the native runtime."""
    if len(data) % 64:
        raise ValueError(f"sha256_midstate takes whole 64-byte blocks, not {len(data)} bytes")
    out = np.array(_SHA256_H0 if state is None else state, dtype=np.uint32)
    if out.shape != (8,):
        raise ValueError("a SHA-256 state is 8 words")
    if data:
        buf = np.frombuffer(data, dtype=np.uint8)
        _load().ts_sha256_blocks(_ptr(buf, _U8P), len(data) // 64, _ptr(out, ctypes.POINTER(ctypes.c_uint32)))
    return out
