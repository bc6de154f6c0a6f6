"""The per-round tail of a GKR layer's sumcheck on the card, and its plain
version.

Counterpart of the scalar code of ``thaler_study_tpu/gkr/fused.py``'s
layer bodies (:161-196, :283-347): after each round's sums (kernel K1,
``cuda_round.round_partials``) the tail reduces K1's partials, fills s(1)
from the claim, interpolates, serializes the GKR message into the proof's
transcript bytes, absorbs it into the carried SHA-256 chain and draws the
next challenge, so that nothing of a layer goes to the host. The CUDA code
is ``csrc/gkr_tail.cuh`` (the round tail, run as K1's epilogue) and
``csrc/gkr_tail.cu`` (the final tail); the header's note says what bounds
it.

Two entry points, each with a plain version in Python ints (with the
pure-Python SHA-256 compression) for CPU tensors; CUDA tensors launch the
kernel or raise:

- :func:`libra_round_tail`, one launch per inner round: K1 over the
  round's tables with the round tail as its epilogue (the last block to
  finish runs it; StartSumCheck first in phase 1's round 0, then the
  SumCheckProverMessage, one draw (two at the layer's second-to-last
  message) and the next claim). Its plain version is
  ``cuda_round.round_partials_plain`` then :func:`round_tail_plain`;
- :func:`final_tail`, one launch per layer: the FinalRoundMessage (the last
  round polynomial p and the line restriction q), the r* draw and the next
  layer's point r_{i+1} = u + (c - u) r*.

Scope: Goldilocks (int64 words), the empty DST, batch 1. :class:`GKRChain`
carries the chain's state on the card; the absorbed byte count is a host
int, since every message length of the fused prover is fixed (the JAX
package's traced-offset mode existed to reuse one compiled program across
layers; a launch argument does that here).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _build, runtime
from ..fields import GOLDILOCKS
from ..fields.farray import tensor_u64
from . import cuda_round
from .fs_kernel import _put
from .sha_chain import absorb_py, draw_many_py

P = GOLDILOCKS.p
_INV2 = (P + 1) // 2
MAX_K = 31  # csrc/gkr_tail.cu MAX_K: q's k + 1 coefficients, one per lane
START_LEN = 25  # StartSumCheck: tag, c_1, layer, 2k
ROUND_LEN = 57  # SumCheckProverMessage of a degree-2 polynomial

# launches of the CUDA kernels (not of the plain versions), per instantiation
# (Goldilocks only): K1 with the round tail as its epilogue (each also
# counted in cuda_round.libra_launches, as a launch of K1), the final tail
tail_launches = {"goldilocks": 0, "mont32": 0}
final_launches = {"goldilocks": 0, "mont32": 0}

_lib = None
_round_tail_fn = None
_wave = {}  # (device index, phase, fold, skip_t1) -> blocks of one wave


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("gkr_tail")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ts_gkr_final_tail_launch.argtypes = [vp, i, vp, vp, i, vp, vp, vp, ll, vp, vp, vp, vp]
        lib.ts_gkr_final_tail_launch.restype = i
        _lib = lib
    return _lib


def _round_tail_kernel():
    global _round_tail_fn
    if _round_tail_fn is None:
        fn = _build.load("round_kernel").ts_libra_round_tail_launch
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [i, i, i] + [vp] * 9 + [ll, i, ll] + [vp] * 3 + [ll] + [vp] * 4 + [i, i, i, ll, i, vp]
        fn.restype = i
        _round_tail_fn = fn
    return _round_tail_fn


def _wave_blocks(dev, phase: int, fold: bool, skip_t1: bool) -> int:
    """Blocks of one wave of K1 with TAIL on ``dev``: every block then
    fences and takes its ticket at once (csrc/round_kernel.cu)."""
    key = (dev.index, phase, fold, skip_t1)
    n = _wave.get(key)
    if n is None:
        lib = _build.load("round_kernel")
        lib.ts_libra_round_tail_blocks.argtypes = [ctypes.c_int] * 3
        lib.ts_libra_round_tail_blocks.restype = ctypes.c_int
        with torch.cuda.device(dev):
            n = lib.ts_libra_round_tail_blocks(phase, int(fold), int(skip_t1))
        if n < 1:
            raise RuntimeError("could not read the round kernel's occupancy on the card")
        _wave[key] = n
    return n


def final_len(k: int) -> int:
    """Bytes of a FinalRoundMessage with a degree-2 p and a degree-k q."""
    return 1 + 8 + 3 * 16 + 8 + 16 * (k + 1)


@dataclasses.dataclass
class GKRChain:
    """One proof's Fiat-Shamir chain on the card: the SHA-256 midstate over
    Z_pad || transcript (``state``, int32 [8] holding the u32 words' bits),
    the partial block (``buf``, uint8 [64], zero after the fill) and the
    absorbed transcript bytes (``nbytes``, host int)."""

    state: torch.Tensor
    buf: torch.Tensor
    nbytes: int

    @classmethod
    def seeded(cls, state, rest: bytes, nbytes: int, device) -> "GKRChain":
        """The chain after ``nbytes`` transcript bytes: ``state`` (8 u32
        ints) over their whole blocks after Z_pad, ``rest`` the bytes of
        the partial block."""
        words = np.asarray(state, dtype=np.uint32).view(np.int32).copy()
        buf = np.zeros(64, dtype=np.uint8)
        buf[: len(rest)] = np.frombuffer(rest, dtype=np.uint8)
        return cls(torch.from_numpy(words).to(device), torch.from_numpy(buf).to(device), nbytes)


def _check(dev, named):
    for name, (t, dtype, shape) in named.items():
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {list(shape)}, not {list(t.shape)}")


def _check_common(partials, chain, msgs, off, m, zero):
    dev = partials.device
    if partials.dim() != 3 or partials.shape[0] != 1 or partials.shape[2] != 3:
        raise ValueError("partials must be the round kernel's [1, blocks, 3] of one proof")
    _check(dev, {
        "partials": (partials, torch.int64, None),
        "chain.state": (chain.state, torch.int32, (8,)),
        "chain.buf": (chain.buf, torch.uint8, (64,)),
        "msgs": (msgs, torch.uint8, None),
        "zero": (zero, torch.int32, (1,)),
    })
    if msgs.dim() != 1 or not 0 <= off <= msgs.shape[0] - m:
        raise ValueError(f"msgs must be 1-D with room for {m} bytes at offset {off}")
    return dev


def _launched(rc: int, name: str, counts: dict) -> None:
    if rc != 0:
        raise RuntimeError(f"GKR {name} kernel launch failed: CUDA error {rc}")
    counts["goldilocks"] += 1


@dataclasses.dataclass
class LayerTail:
    """What every round tail of one fused layer reads and writes, checked
    once, when it is made: ``chain``; ``msgs`` (uint8, 1-D), the proof's
    transcript bytes; ``zero`` (int32 [1]), ORed with the zero-coefficient
    flag; ``claim`` (int64 [1]), the running claim; ``chal`` (int64, 1-D),
    the layer's challenge vector; ``counter`` (int32 [1], 0), the round
    kernel's ticket counter, left 0 by every launch."""

    chain: GKRChain
    msgs: torch.Tensor
    zero: torch.Tensor
    claim: torch.Tensor
    chal: torch.Tensor
    counter: torch.Tensor

    def __post_init__(self):
        _check(self.claim.device, {
            "chain.state": (self.chain.state, torch.int32, (8,)),
            "chain.buf": (self.chain.buf, torch.uint8, (64,)),
            "msgs": (self.msgs, torch.uint8, None),
            "zero": (self.zero, torch.int32, (1,)),
            "claim": (self.claim, torch.int64, (1,)),
            "chal": (self.chal, torch.int64, None),
            "counter": (self.counter, torch.int32, (1,)),
        })
        if self.msgs.dim() != 1 or self.chal.dim() != 1:
            raise ValueError("msgs and chal must be 1-D")
        # the kernel copies these into shared memory with 16- and 8-byte copies
        if self.chain.state.data_ptr() % 16 or self.chain.buf.data_ptr() % 16 or self.claim.data_ptr() % 8:
            raise ValueError("chain.state and chain.buf must be 16-byte aligned, claim 8-byte aligned")


@dataclasses.dataclass
class RoundTail:
    """One inner round's tail: its message goes to ``layer.msgs[off:]``
    (StartSumCheck first when ``start`` = (layer index, k), phase 1's round
    0: then s(1) is computed, not taken from the claim); ``draws`` (1 or 2)
    challenges go to ``layer.chal[chal_idx:]`` and the claim becomes the
    round polynomial at the first."""

    layer: LayerTail
    off: int
    chal_idx: int
    draws: int
    start: Optional[Tuple[int, int]] = None

    @property
    def length(self) -> int:
        """The bytes of the round's messages."""
        return ROUND_LEN + (START_LEN if self.start is not None else 0)


def libra_round_tail(
    tables: List[torch.Tensor],
    r: Optional[torch.Tensor],
    skip_t1: bool,
    phase: int,
    scalars: List[torch.Tensor],
    tail: RoundTail,
    out: Optional[List[torch.Tensor]] = None,
) -> Tuple[Optional[List[torch.Tensor]], torch.Tensor]:
    """One inner round of a fused GKR layer: K1 over the LibraW ``phase``
    (1: W A1 + A2; 2: B1 w_u + B1 Wc + B2 w_u Wc with ``scalars`` = [w_u];
    batch 1, Goldilocks; ``r``, ``skip_t1`` and ``out`` as
    ``cuda_round.round_partials`` takes them) and the round tail on its
    partials, in place on ``tail.layer``; advances the chain. Returns K1's
    (folded tables or None, partials). CPU tensors run K1's plain version,
    then :func:`round_tail_plain`; CUDA tensors launch K1 with the tail as
    its epilogue (one launch, at most one wave of blocks: the partials may
    be split over fewer blocks than ``round_partials`` uses) or raise."""
    lt, m = tail.layer, tail.length
    if not 0 <= tail.off <= lt.msgs.shape[0] - m:
        raise ValueError(f"msgs must have room for {m} bytes at offset {tail.off}")
    if tail.draws not in (1, 2) or not 0 <= tail.chal_idx <= lt.chal.shape[0] - tail.draws:
        raise ValueError(f"{tail.draws} draws do not fit chal[{tail.chal_idx}:] of {list(lt.chal.shape)}")
    if phase not in (1, 2) or len(scalars) != phase - 1:
        raise ValueError(f"LibraW phase {phase} with {len(scalars)} scalars")
    dev = tables[0].device
    if dev != lt.claim.device:
        raise ValueError(f"the tables are on {dev}, the layer's tail state on {lt.claim.device}")
    if dev.type == "cpu":
        terms = cuda_round.LIBRA_PHASE1 if phase == 1 else cuda_round.LIBRA_PHASE2
        folded, partials = cuda_round.round_partials(tables, r, skip_t1, out, GOLDILOCKS, terms, scalars)
        round_tail_plain(partials, lt.chain, lt.msgs, tail.off, lt.zero, lt.claim, lt.chal, tail.chal_idx,
                         tail.draws, tail.start)
        lt.chain.nbytes += m
        return folded, partials
    if dev.type != "cuda":
        raise ValueError(f"libra_round_tail runs on cpu or cuda, not {dev}")
    fold = r is not None
    batch, n, _ = cuda_round._check(tables, r, out, fold, torch.int64)
    if batch != 1 or len(tables) != 3:
        raise NotImplementedError("the GKR round tail takes K1's three LibraW tables of one proof")
    for sc in scalars:
        if sc.dtype != torch.int64 or sc.shape != (1,) or sc.device != dev or not sc.is_contiguous():
            raise ValueError(f"scalars must be contiguous int64 [1] tensors on {dev}")
    half = n // 4 if fold else n // 2
    blocks = min(cuda_round.blocks_for(1, half), _wave_blocks(dev, phase, fold, skip_t1))
    if fold and out is None:
        out = [torch.empty((1, n // 2), dtype=torch.int64, device=dev) for _ in tables]
    partials = torch.empty((1, blocks, 3), dtype=torch.int64, device=dev)
    outs = [o.data_ptr() for o in out] if fold else [None] * 3
    layer, k = tail.start if tail.start is not None else (0, 0)
    chain = lt.chain
    rc = _round_tail_kernel()(
        phase, int(fold), int(skip_t1), *(t.data_ptr() for t in tables), *outs,
        r.data_ptr() if fold else None, scalars[0].data_ptr() if scalars else None, partials.data_ptr(),
        n, blocks, -(-half // blocks), lt.counter.data_ptr(), chain.state.data_ptr(), chain.buf.data_ptr(),
        chain.nbytes, lt.msgs.data_ptr() + tail.off, lt.zero.data_ptr(), lt.claim.data_ptr(), lt.chal.data_ptr(),
        tail.chal_idx, tail.draws, int(tail.start is not None), layer, k, torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched(rc, "round kernel with the round tail", tail_launches)
    cuda_round.libra_launches["goldilocks"] += 1
    chain.nbytes += m
    return (list(out) if fold else None), partials


def final_tail(
    partials: torch.Tensor,
    claim: torch.Tensor,
    q: torch.Tensor,
    chal: torch.Tensor,
    k: int,
    chain: GKRChain,
    msgs: torch.Tensor,
    off: int,
    zero: torch.Tensor,
    r_next: torch.Tensor,
) -> int:
    """A layer's final tail, in place: p from K1's last [1, blocks, 3]
    partials and ``claim``, ``q`` (int64 [k + 1]) the line restriction's
    coefficients; the FinalRoundMessage goes to ``msgs[off:]`` and into
    ``chain``; ``zero`` is ORed with the zero-coefficient flag; r* is drawn
    and ``r_next`` (int64 [k]) receives u + (c - u) r* with u = chal[:k],
    c = chal[k:]. Returns the bytes written. CPU tensors run
    :func:`final_tail_plain`."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the GKR final tail takes 1 <= k <= {MAX_K} variables per phase, not {k}")
    m = final_len(k)
    dev = _check_common(partials, chain, msgs, off, m, zero)
    _check(dev, {
        "claim": (claim, torch.int64, (1,)),
        "q": (q, torch.int64, (k + 1,)),
        "chal": (chal, torch.int64, (2 * k,)),
        "r_next": (r_next, torch.int64, (k,)),
    })
    if dev.type == "cpu":
        final_tail_plain(partials, claim, q, chal, k, chain, msgs, off, zero, r_next)
    elif dev.type == "cuda":
        rc = _library().ts_gkr_final_tail_launch(
            partials.data_ptr(), partials.shape[1], claim.data_ptr(), q.data_ptr(), k, chal.data_ptr(),
            chain.state.data_ptr(), chain.buf.data_ptr(), chain.nbytes, msgs.data_ptr() + off,
            zero.data_ptr(), r_next.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        _launched(rc, "final tail", final_launches)
    else:
        raise ValueError(f"final_tail runs on cpu or cuda, not {dev}")
    chain.nbytes += m
    return m


# ---- plain versions: Python ints over .tolist(), pure-Python SHA-256; they
# take tensors on any device (chip_smoke.py runs them on the card's) ----


def _ints(t: torch.Tensor) -> List[int]:
    return [int(x) for x in tensor_u64(t).reshape(-1)]


def _sums_interp(partials, claim: Optional[int]) -> Tuple[List[int], List[int]]:
    """Round sums s(0..2) (s(1) = claim - s(0) when the claim is given) and
    the coefficients of the degree-2 g with g(0..2) = s."""
    parts = np.array(_ints(partials), dtype=object).reshape(-1, 3)
    s = [int(parts[:, e].sum()) % P for e in range(3)]
    if claim is not None:
        s[1] = (claim - s[0]) % P
    c2 = (s[2] - 2 * s[1] + s[0]) * _INV2 % P
    return s, [s[0], (s[1] - s[0] - c2) % P, c2]


def _units(tag: int, units) -> bytes:
    return bytes([tag]) + b"".join(int(u).to_bytes(8, "little") for u in units)


def _poly_units(coeffs) -> list:
    return [len(coeffs)] + [x for t, c in enumerate(coeffs) for x in (t, c)]


def _absorb_draw(chain: GKRChain, msgs, off: int, zero, msg: bytes, flagged: bool, draws: int) -> List[int]:
    """Write ``msg`` at ``msgs[off:]``, absorb it, OR the zero flag, draw."""
    state = chain.state.cpu().numpy().view(np.uint32).tolist()
    buf = bytearray(chain.buf.tolist())
    absorb_py(state, buf, chain.nbytes, msg)
    rs = draw_many_py(GOLDILOCKS, state, buf, chain.nbytes + len(msg), draws)
    msgs[off : off + len(msg)] = torch.frombuffer(bytearray(msg), dtype=torch.uint8)
    if flagged:
        zero.fill_(1)
    chain.state.copy_(torch.from_numpy(np.array(state, dtype=np.uint32).view(np.int32)))
    chain.buf.copy_(torch.tensor(list(buf), dtype=torch.uint8))
    return rs


def round_tail_plain(partials, chain, msgs, off, zero, claim, chal, chal_idx, draws, start=None) -> None:
    """:func:`round_tail` in Python ints (same in-place outputs;
    ``chain.nbytes`` is left to the caller)."""
    s, c = _sums_interp(partials, None if start is not None else _ints(claim)[0])
    msg = b""
    if start is not None:
        layer, k = start
        msg = _units(1, [(s[0] + s[1]) % P, layer, 2 * k])
    msg += _units(2, _poly_units(c))
    rs = _absorb_draw(chain, msgs, off, zero, msg, 0 in c, draws)
    _put(chal[chal_idx : chal_idx + draws], rs)
    r = rs[0]
    _put(claim, [(c[0] + c[1] * r + c[2] * r * r) % P])


def final_tail_plain(partials, claim, q, chal, k, chain, msgs, off, zero, r_next) -> None:
    """:func:`final_tail` in Python ints (same in-place outputs;
    ``chain.nbytes`` is left to the caller)."""
    _, p = _sums_interp(partials, _ints(claim)[0])
    qc = _ints(q)
    msg = _units(3, _poly_units(p) + _poly_units(qc))
    (r_star,) = _absorb_draw(chain, msgs, off, zero, msg, 0 in p or 0 in qc, 1)
    ch = _ints(chal)
    u, cc = ch[:k], ch[k:]
    _put(r_next, [(a + (b - a) * r_star) % P for a, b in zip(u, cc)])


def midstate(prefix: bytes) -> Tuple[np.ndarray, bytes]:
    """The chain's host state after ``prefix``: the SHA-256 midstate over
    the whole blocks of Z_pad || prefix by the native runtime (megabytes
    for a GKR Begin message) and the bytes of the partial block."""
    full = bytes(64) + prefix
    cut = len(full) - len(full) % 64
    return runtime.sha256_midstate(full[:cut]), full[cut:]


def prefix_chain(prefix: bytes, device) -> GKRChain:
    """The chain after absorbing ``prefix``, on ``device``."""
    return GKRChain.seeded(*midstate(prefix), len(prefix), device)
