"""The fused round kernel for Hopper and its plain torch version.

Counterpart of ``thaler_study_tpu/ops/pallas_round.py`` (the Pallas kernel
``_make_kernel``, entered through ``pallas_round_step``): one pass over a
batch of k-factor single-block product tables that folds the previous
challenge and computes the round sums. The CUDA source is
``csrc/round_kernel.cu``; its note says what bounds it and how.

:func:`round_partials` is the wrapper. CPU tensors go to
:func:`round_partials_plain`; CUDA tensors go to the kernel or raise. Both
return the same per-block partial sums, so the two can be compared bit for
bit; callers sum the partials mod p (``round_kernel._round_sums`` or the
FS tail kernel).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _build
from ..fields import goldilocks as gl

THREADS = 256  # csrc/round_kernel.cu THREADS
_TARGET_BLOCKS = 2048  # blocks in flight over the whole batch: ~16 per SM

# launches of the CUDA kernel (not of the plain version)
launches = 0

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("round_kernel")
        fn = lib.ts_round_launch
        fn.argtypes = (
            [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 8
            + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def blocks_for(batch: int, half: int) -> int:
    """Blocks per proof: enough to fill the card across the batch, and no
    more than one block per THREADS pair indices."""
    return max(1, min(-(-half // THREADS), _TARGET_BLOCKS // batch))


def _check(tables, r, out, fold: bool) -> Tuple[int, int, torch.device]:
    if not tables:
        raise ValueError("round_partials needs at least one table")
    t0 = tables[0]
    dev = t0.device
    if t0.dim() != 2:
        raise ValueError(f"tables must be [B, n], got shape {tuple(t0.shape)}")
    batch, n = t0.shape
    if n < (4 if fold else 2) or n & (n - 1):
        raise ValueError(f"table length {n} must be a power of two >= {4 if fold else 2}")
    for t in tables:
        if t.dtype != torch.int64 or t.shape != t0.shape or t.device != dev:
            raise ValueError("tables must be int64 tensors of one shape on one device")
        if not t.is_contiguous():
            raise ValueError("tables must be contiguous")
    if fold:
        if r is None or r.dtype != torch.int64 or r.shape != (batch,) or r.device != dev:
            raise ValueError(f"r must be an int64 [{batch}] tensor on {dev}")
        if not r.is_contiguous():
            raise ValueError("r must be contiguous")
    if out is not None:
        if len(out) != len(tables):
            raise ValueError("one output per table")
        for o in out:
            if o.dtype != torch.int64 or o.shape != (batch, n // 2) or o.device != dev:
                raise ValueError(f"outputs must be int64 [{batch}, {n // 2}] on {dev}")
            if not o.is_contiguous():
                raise ValueError("outputs must be contiguous")
    return batch, n, dev


def round_partials(
    tables: Sequence[torch.Tensor],
    r: Optional[torch.Tensor] = None,
    skip_t1: bool = False,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[Optional[List[torch.Tensor]], torch.Tensor]:
    """One round over B proofs of a single-block product of k tables.

    ``tables``: k int64 [B, n] tensors (canonical Goldilocks, MSB-first).
    ``r``: int64 [B] challenges, or None for a round without a fold.
    ``skip_t1``: leave s(1) out (0); the caller fills claim - s(0).
    ``out``: k int64 [B, n/2] buffers for the folded tables (allocated when
    None). Returns (folded tables or None, partials int64 [B, blocks, k+1]).
    The input tables are never written.
    """
    fold = r is not None
    batch, n, dev = _check(tables, r, out, fold)
    half = n // 4 if fold else n // 2
    blocks = blocks_for(batch, half)
    if dev.type == "cpu":
        folded, partials = round_partials_plain(tables, r, skip_t1, blocks)
        if out is not None and folded is not None:
            for o, f in zip(out, folded):
                o.copy_(f)
            folded = list(out)
        return folded, partials
    if dev.type != "cuda":
        raise ValueError(f"round_partials runs on cpu or cuda, not {dev}")
    k = len(tables)
    if k not in (2, 3):
        raise NotImplementedError(f"the CUDA round kernel takes k = 2 or 3 factors, not {k}")
    if batch > 65535:
        raise ValueError("the CUDA round kernel takes at most 65535 proofs")
    if fold and out is None:
        out = [torch.empty((batch, n // 2), dtype=torch.int64, device=dev) for _ in tables]
    partials = torch.empty((batch, blocks, k + 1), dtype=torch.int64, device=dev)
    ins = [t.data_ptr() for t in tables] + [None] * (3 - k)
    outs = ([o.data_ptr() for o in out] if fold else []) + [None] * (3 - (k if fold else 0))
    chunk = -(-half // blocks)
    rc = _kernel()(
        k,
        int(fold),
        int(skip_t1),
        *ins,
        *outs,
        r.data_ptr() if fold else None,
        partials.data_ptr(),
        batch,
        n,
        blocks,
        chunk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"round kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return (list(out) if fold else None), partials


def round_partials_plain(
    tables: Sequence[torch.Tensor],
    r: Optional[torch.Tensor],
    skip_t1: bool,
    blocks: int,
) -> Tuple[Optional[List[torch.Tensor]], torch.Tensor]:
    """The kernel's function in plain torch int64 ops (any device): the same
    folded tables and the same per-block partials (block x sums the pair
    indices [x * chunk, (x + 1) * chunk))."""
    batch, n = tables[0].shape
    k = len(tables)
    if r is not None:
        h = n // 4
        rr = r.reshape(batch, 1)
        lo = [gl.fold(t[:, :h], t[:, 2 * h : 3 * h], rr) for t in tables]
        hi = [gl.fold(t[:, h : 2 * h], t[:, 3 * h :], rr) for t in tables]
        folded = [torch.cat([a, b], dim=1) for a, b in zip(lo, hi)]
    else:
        h = n // 2
        lo = [t[:, :h] for t in tables]
        hi = [t[:, h:] for t in tables]
        folded = None
    chunk = -(-h // blocks)
    pad = blocks * chunk - h
    deltas = [gl.sub(b, a) for a, b in zip(lo, hi)]
    cols = []
    views = None
    for t in range(k + 1):
        if t == 0:
            views = lo
        elif t == 1:
            views = hi
        else:
            views = [gl.add(v, d) for v, d in zip(views, deltas)]
        if t == 1 and skip_t1:
            cols.append(torch.zeros((batch, blocks), dtype=torch.int64, device=lo[0].device))
            continue
        prod = views[0]
        for v in views[1:]:
            prod = gl.mul(prod, v)
        prod = torch.nn.functional.pad(prod, (0, pad))
        cols.append(gl.sum_mod(prod.reshape(batch, blocks, chunk), 2))
    return folded, torch.stack(cols, dim=2)
