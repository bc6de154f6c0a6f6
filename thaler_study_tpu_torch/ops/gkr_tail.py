"""The per-round tail of a GKR layer's sumcheck on the card, and its plain
version.

Counterpart of the scalar code of ``thaler_study_tpu/gkr/fused.py``'s
layer bodies (:161-196, :283-347): after each launch of the round kernel
(K1, ``cuda_round.round_partials``) the tail reduces K1's partials, fills
s(1) from the claim, interpolates, serializes the GKR message into the
proof's transcript bytes, absorbs it into the carried SHA-256 chain and
draws the next challenge, so that nothing of a layer goes to the host. The
CUDA source is ``csrc/gkr_tail.cu``; its note says what bounds it.

Two entry points, each with a plain version in Python ints (with the
pure-Python SHA-256 compression) for CPU tensors; CUDA tensors launch the
kernel or raise:

- :func:`round_tail`, one launch per inner round: StartSumCheck first in
  phase 1's round 0, then the SumCheckProverMessage, one draw (two at the
  layer's second-to-last message) and the next claim;
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
from .fs_kernel import _put
from .sha_chain import absorb_py, draw_many_py

P = GOLDILOCKS.p
_INV2 = (P + 1) // 2
MAX_K = 31  # csrc/gkr_tail.cu MAX_K: q's k + 1 coefficients, one per lane
START_LEN = 25  # StartSumCheck: tag, c_1, layer, 2k
ROUND_LEN = 57  # SumCheckProverMessage of a degree-2 polynomial

# launches of the CUDA kernels (not of the plain versions), per instantiation
# (Goldilocks only)
round_launches = {"goldilocks": 0, "mont32": 0}
final_launches = {"goldilocks": 0, "mont32": 0}

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("gkr_tail")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ts_gkr_round_tail_launch.argtypes = [vp, i, vp, vp, ll, vp, vp, vp, vp, i, i, i, ll, i, vp]
        lib.ts_gkr_round_tail_launch.restype = i
        lib.ts_gkr_final_tail_launch.argtypes = [vp, i, vp, vp, i, vp, vp, vp, ll, vp, vp, vp, vp]
        lib.ts_gkr_final_tail_launch.restype = i
        _lib = lib
    return _lib


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


def round_tail(
    partials: torch.Tensor,
    chain: GKRChain,
    msgs: torch.Tensor,
    off: int,
    zero: torch.Tensor,
    claim: torch.Tensor,
    chal: torch.Tensor,
    chal_idx: int,
    draws: int,
    start: Optional[Tuple[int, int]] = None,
) -> int:
    """One inner round's tail, in place. ``partials``: K1's [1, blocks, 3];
    ``msgs[off:]`` receives the message bytes (StartSumCheck first when
    ``start`` = (layer, k), phase 1's round 0: then s(1) is computed, not
    taken from ``claim``); ``zero`` (int32 [1]) is ORed with the
    zero-coefficient flag; ``draws`` (1 or 2) challenges go to
    ``chal[chal_idx:]`` and ``claim`` (int64 [1]) becomes the round
    polynomial at the first. Advances ``chain`` and returns the bytes
    written. CPU tensors run :func:`round_tail_plain`."""
    m = ROUND_LEN + (START_LEN if start is not None else 0)
    dev = _check_common(partials, chain, msgs, off, m, zero)
    _check(dev, {"claim": (claim, torch.int64, (1,)), "chal": (chal, torch.int64, None)})
    if draws not in (1, 2) or chal.dim() != 1 or not 0 <= chal_idx <= chal.shape[0] - draws:
        raise ValueError(f"{draws} draws do not fit chal[{chal_idx}:] of {list(chal.shape)}")
    if dev.type == "cpu":
        round_tail_plain(partials, chain, msgs, off, zero, claim, chal, chal_idx, draws, start)
    elif dev.type == "cuda":
        layer, k = start if start is not None else (0, 0)
        rc = _library().ts_gkr_round_tail_launch(
            partials.data_ptr(), partials.shape[1], chain.state.data_ptr(), chain.buf.data_ptr(), chain.nbytes,
            msgs.data_ptr() + off, zero.data_ptr(), claim.data_ptr(), chal.data_ptr(), chal_idx, draws,
            int(start is not None), layer, k, torch.cuda.current_stream(dev).cuda_stream,
        )
        _launched(rc, "round tail", round_launches)
    else:
        raise ValueError(f"round_tail runs on cpu or cuda, not {dev}")
    chain.nbytes += m
    return m


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
