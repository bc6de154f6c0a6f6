"""The batched on-device Fiat-Shamir sumcheck prover.

Counterpart of ``thaler_study_tpu/ops/fs_kernel.py``. The JAX package
compiles a whole proof (fold, round sums, coefficient interpolation,
arkworks serialization, the RFC 9380 ``expand_message_xmd`` / SHA-256
challenge chain) into one XLA program vmapped over B proofs. Here the round
loop runs on the host, and each round is two launches over all B proofs:

1. the round kernel (``cuda_round.round_partials``, ``csrc/round_kernel.cu``):
   fold the previous challenge into ping-pong buffers and compute per-block
   partial round sums;
2. the FS tail kernel (:func:`fs_tail`, ``csrc/fs_tail.cu``): reduce the
   partials, fill s(1) = claim - s(0), interpolate, flag zero coefficients,
   absorb the serialized message into the carried SHA-256 chain, draw the
   next challenge and evaluate the next claim.

Challenges, claims and chain state stay on the device between rounds; the
host reads nothing inside the loop, and afterwards reads only c_1, the
coefficient table and the zero flags, from which it assembles the bytes.

Bit-exactness caveat (as in the JAX package): arkworks drops zero
coefficients from serialized ``SparsePolynomial`` terms, which would make
message lengths value-dependent. The device path assumes every coefficient
is nonzero, detects violations per proof, and returns ``None`` for such a
proof; the caller re-proves it on the exact host loop.

Scope of this slice: Goldilocks, single-block products of 2 or 3 factors
(the CUDA kernels' instantiations; the plain versions take any k), and the
empty DST. Anything else raises ``NotImplementedError`` naming the later
slice.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..fields import FArray, FieldConfig
from ..fields.farray import tensor_u64, u64_tensor
from ..fields.goldilocks import P
from .cuda_round import round_partials
from .round_kernel import PolySpec, check_single_block
from .sha_chain import DevChain, absorb_py, draw_gl_py

# launches of the CUDA FS tail kernel (not of the plain version)
launches = 0

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fs_tail")
        fn = lib.ts_fs_tail_launch
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


@lru_cache(maxsize=None)
def _interp_matrix(degree: int, p: int) -> tuple:
    """Inverse Vandermonde over points 0..degree mod p (exact python ints):
    coeffs = M @ values."""
    n = degree + 1
    v = [[pow(t, i, p) for i in range(n)] for t in range(n)]  # V[t][i]
    # invert mod p by Gauss-Jordan on python ints
    m = [row[:] + [1 if i == j else 0 for j in range(n)] for i, row in enumerate(v)]
    for col in range(n):
        piv = next(r for r in range(col, n) if m[r][col] % p != 0)
        m[col], m[piv] = m[piv], m[col]
        inv = pow(m[col][col], p - 2, p)
        m[col] = [x * inv % p for x in m[col]]
        for r in range(n):
            if r != col and m[r][col] % p:
                f = m[r][col]
                m[r] = [(x - f * y) % p for x, y in zip(m[r], m[col])]
    vinv = [row[n:] for row in m]  # V^{-1}: coeffs_i = sum_t Vinv[i][t] s_t
    return tuple(tuple(row) for row in vinv)


def _msg_len(round_idx: int, degree: int) -> int:
    """Bytes of round ``round_idx``'s message: [c_1] || len || terms."""
    return (8 if round_idx == 0 else 0) + 8 + 16 * (degree + 1)


def _check_supported(spec: PolySpec, field: FieldConfig, num_tables: int, dst: bytes):
    if dst != b"":
        raise NotImplementedError(
            "a non-empty DST needs the unfused per-round batched path "
            "(thaler_study_tpu/protocols/batched.py:188-204), a later slice"
        )
    if field.backend != "goldilocks":
        raise NotImplementedError(
            f"{field.name}: the mont32 fused prover is a later slice of the port"
        )
    check_single_block(spec, num_tables)


def supports_fused_fs(spec: PolySpec, field: FieldConfig, dst: bytes) -> bool:
    """Does this slice's fused path cover (spec, field, dst)? Goldilocks,
    the empty DST and a single-block product of all the spec's tables."""
    try:
        _check_supported(spec, field, len(spec.table_blocks), dst)
    except NotImplementedError:
        return False
    return True


def _assemble_msgs(c1: int, coeffs: Sequence[int], degrees: Sequence[int], byte_size: int) -> list:
    """Host re-assembly of the byte messages from device coefficient ints —
    the exact layout the device hashed. ``coeffs`` is flat round-major,
    (degrees[j] + 1) coefficients per round."""
    msgs = []
    off = 0
    for j, degree in enumerate(degrees):
        out = []
        if j == 0:
            out.append(int(c1).to_bytes(byte_size, "little"))
        out.append((degree + 1).to_bytes(8, "little"))
        for t in range(degree + 1):
            out.append(t.to_bytes(8, "little"))
            out.append(int(coeffs[off]).to_bytes(byte_size, "little"))
            off += 1
        msgs.append(b"".join(out))
    return msgs


def _check_tail(partials, chain, claim, r, c1, coeffs, any_zero, vinv, coeff_off):
    dev = partials.device
    if partials.dim() != 3 or partials.dtype != torch.int64:
        raise ValueError("partials must be an int64 [B, blocks, d+1] tensor")
    batch, _, d1 = partials.shape
    want = {
        "state": (chain.state, torch.int32, (batch, 8)),
        "buf": (chain.buf, torch.uint8, (batch, 64)),
        "claim": (claim, torch.int64, (batch,)),
        "r": (r, torch.int64, (batch,)),
        "c1": (c1, torch.int64, (batch,)),
        "any_zero": (any_zero, torch.int32, (batch,)),
        "vinv": (vinv, torch.int64, (d1 * d1,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {dtype} {list(shape)} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if coeffs.dtype != torch.int64 or coeffs.dim() != 2 or coeffs.shape[0] != batch:
        raise ValueError(f"coeffs must be int64 [{batch}, ncoef]")
    if coeffs.device != dev or not coeffs.is_contiguous() or not partials.is_contiguous():
        raise ValueError("coeffs and partials must be contiguous and on one device")
    if not 0 <= coeff_off <= coeffs.shape[1] - d1:
        raise ValueError("coefficient row offset out of range")


def fs_tail(
    partials: torch.Tensor,
    chain: DevChain,
    claim: torch.Tensor,
    r: torch.Tensor,
    c1: torch.Tensor,
    coeffs: torch.Tensor,
    any_zero: torch.Tensor,
    vinv: torch.Tensor,
    round_idx: int,
    coeff_off: int,
    draw: bool,
) -> None:
    """Round ``round_idx``'s FS tail for B proofs, in place: updates
    ``chain`` (state, buf, nbytes), ``coeffs[:, coeff_off:coeff_off+d+1]``,
    ``any_zero``, ``c1`` (round 0) and, with ``draw``, the next ``r`` and
    ``claim``. ``partials``: the round kernel's int64 [B, blocks, d+1];
    ``vinv``: the (d+1)^2 inverse-Vandermonde constants, row-major.
    CPU tensors run :func:`fs_tail_plain`; CUDA tensors the kernel."""
    _check_tail(partials, chain, claim, r, c1, coeffs, any_zero, vinv, coeff_off)
    batch, blocks, d1 = partials.shape
    dev = partials.device
    if dev.type == "cpu":
        fs_tail_plain(partials, chain, claim, r, c1, coeffs, any_zero, vinv, round_idx, coeff_off, draw)
    elif dev.type == "cuda":
        if d1 - 1 not in (2, 3):
            raise NotImplementedError(f"the CUDA FS tail takes degree 2 or 3, not {d1 - 1}")
        rc = _kernel()(
            d1 - 1,
            partials.data_ptr(),
            blocks,
            chain.state.data_ptr(),
            chain.buf.data_ptr(),
            claim.data_ptr(),
            r.data_ptr(),
            c1.data_ptr(),
            coeffs.data_ptr(),
            coeffs.shape[1],
            coeff_off,
            any_zero.data_ptr(),
            vinv.data_ptr(),
            batch,
            round_idx,
            chain.nbytes,
            int(draw),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"FS tail kernel launch failed: CUDA error {rc}")
        global launches
        launches += 1
    else:
        raise ValueError(f"fs_tail runs on cpu or cuda, not {dev}")
    chain.nbytes += _msg_len(round_idx, d1 - 1)


def _put_u64(t: torch.Tensor, values) -> None:
    t.copy_(u64_tensor(np.array(values, dtype=np.uint64).reshape(t.shape), t.device))


def fs_tail_plain(partials, chain, claim, r, c1, coeffs, any_zero, vinv, round_idx, coeff_off, draw) -> None:
    """:func:`fs_tail` in Python ints over ``.tolist()``, with the
    pure-Python SHA-256 compression (any device; same in-place outputs)."""
    batch, _, d1 = partials.shape
    degree = d1 - 1
    parts = tensor_u64(partials).tolist()
    m = [[int(x) for x in row] for row in tensor_u64(vinv).reshape(d1, d1).tolist()]
    claims = [int(x) for x in tensor_u64(claim)]
    rs = [int(x) for x in tensor_u64(r)]
    c1s = [int(x) for x in tensor_u64(c1)]
    coef = tensor_u64(coeffs).copy()
    zeros = any_zero.cpu().tolist()
    states = chain.state.cpu().numpy().view(np.uint32).tolist()
    bufs = [bytearray(row) for row in chain.buf.cpu().numpy().tolist()]
    for b in range(batch):
        s = [sum(int(row[e]) for row in parts[b]) % P for e in range(d1)]
        if round_idx > 0:
            s[1] = (claims[b] - s[0]) % P
        c = [sum(m[i][t] * s[t] for t in range(d1)) % P for i in range(d1)]
        zeros[b] |= int(any(x == 0 for x in c))
        coef[b, coeff_off : coeff_off + d1] = c
        msg = []
        if round_idx == 0:
            c1s[b] = (s[0] + s[1]) % P
            msg.append(c1s[b].to_bytes(8, "little"))
        msg.append(d1.to_bytes(8, "little"))
        for t in range(d1):
            msg.append(t.to_bytes(8, "little") + c[t].to_bytes(8, "little"))
        msg = b"".join(msg)
        absorb_py(states[b], bufs[b], chain.nbytes, msg)
        if draw:
            rs[b] = draw_gl_py(states[b], bufs[b], chain.nbytes + len(msg))
            acc = c[degree]
            for i in range(degree - 1, -1, -1):
                acc = (acc * rs[b] + c[i]) % P
            claims[b] = acc
    _put_u64(claim, claims)
    _put_u64(r, rs)
    _put_u64(c1, c1s)
    _put_u64(coeffs, coef)
    any_zero.copy_(torch.tensor(zeros, dtype=torch.int32))
    chain.state.copy_(torch.from_numpy(np.array(states, dtype=np.uint32).view(np.int32)))
    chain.buf.copy_(torch.tensor([list(bb) for bb in bufs], dtype=torch.uint8))


def fs_prove_device_batch(
    spec: PolySpec, tables: Sequence[FArray], dst: bytes = b""
) -> List[Optional[list]]:
    """B independent whole proofs, two launches per round.

    ``tables``: per-factor FArrays of shape [B, 2^n] on one device (the
    inputs are never written). Returns a list of B entries — each a message
    list, or ``None`` for an instance whose serialized coefficients hit a
    zero (the caller re-proves only that instance on the host loop).
    Raises ``NotImplementedError`` outside this slice (see module doc)."""
    field = tables[0].field
    _check_supported(spec, field, len(tables), dst)
    data = [t.data for t in tables]
    if data[0].dim() != 2:
        raise ValueError("fs_prove_device_batch takes [B, 2^n] tables")
    batch, size = data[0].shape
    n = spec.num_vars()
    if size != 1 << n:
        raise ValueError(f"tables of {size} entries for a {n}-variable spec")
    dev = data[0].device
    degrees = spec.round_degrees()
    degree = degrees[0]
    vinv = u64_tensor(np.array(_interp_matrix(degree, field.p), dtype=np.uint64).reshape(-1), dev)

    def zeros(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    chain = DevChain.fresh(batch, dev)
    r, claim, c1 = zeros(batch), zeros(batch), zeros(batch)
    coeffs = zeros(batch, sum(d + 1 for d in degrees))
    any_zero = zeros(batch, dtype=torch.int32)
    # ping-pong fold buffers: round j >= 1 writes [B, size >> j] into
    # buffer (j - 1) % 2, reading the previous round's buffer
    bufs = [
        [torch.empty(batch * size // 2, dtype=torch.int64, device=dev),
         torch.empty(batch * size // 4, dtype=torch.int64, device=dev)]
        for _ in data
    ]
    cur = data
    off = 0
    for j in range(n):
        if j == 0:
            _, partials = round_partials(cur)
        else:
            m = size >> j
            out = [pp[(j - 1) % 2][: batch * m].view(batch, m) for pp in bufs]
            cur, partials = round_partials(cur, r, skip_t1=True, out=out)
        fs_tail(partials, chain, claim, r, c1, coeffs, any_zero, vinv, j, off, j < n - 1)
        off += degrees[j] + 1
    # the one host read: c_1, the coefficient table and the zero flags
    host = tensor_u64(torch.cat([c1[:, None], coeffs, any_zero[:, None].to(torch.int64)], 1))
    return [
        None
        if host[b, -1]
        else _assemble_msgs(int(host[b, 0]), host[b, 1:-1].tolist(), degrees, field.byte_size)
        for b in range(batch)
    ]


def fs_prove_device(
    spec: PolySpec, tables: Sequence[FArray], dst: bytes = b""
) -> Optional[list]:
    """One whole proof (1-D tables): a batch of one. Returns the serialized
    round messages, or ``None`` when a zero coefficient forces the exact
    host loop."""
    return fs_prove_device_batch(spec, [t.reshape(1, -1) for t in tables], dst)[0]
