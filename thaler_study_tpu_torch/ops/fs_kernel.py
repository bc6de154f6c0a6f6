"""The batched on-device Fiat-Shamir sumcheck prover.

Counterpart of ``thaler_study_tpu/ops/fs_kernel.py``. The JAX package
compiles a whole proof (fold, round sums, coefficient interpolation,
arkworks serialization, the RFC 9380 ``expand_message_xmd`` / SHA-256
challenge chain) into one XLA program vmapped over B proofs. Here the round
loop runs on the host, and each round is two steps over all B proofs:

1. the round sums on the card. A single-block product of all the spec's
   tables (the batched prover's shape) is one launch of the round kernel
   for the whole batch (``cuda_round.round_partials``,
   ``csrc/round_kernel.cu``: 1 to 8 factors): it folds the previous
   challenge into ping-pong buffers and writes per-block partial sums.
   Every other spec (multi-block, multi-term: the triangle IP, dense GKR W,
   mixed round degrees) runs ``round_kernel.round_step`` once per proof,
   which dispatches to the multi-block kernel, the round kernel or the
   modular matmul and returns s(0..D) on the card; the B sums go into one
   [B, 1, D + 1] buffer;
2. the FS tail kernel (:func:`fs_tail`, ``csrc/fs_tail.cu``, round degree
   1 to 8): reduce the partials, fill s(1) = claim - s(0), interpolate
   (one inverse-Vandermonde matrix per distinct round degree), flag zero
   coefficients, write the serialized message into each proof's transcript
   bytes and absorb it into the carried SHA-256 chain, draw the next
   challenge and evaluate the next claim.

Challenges, claims and chain state stay on the device between rounds; the
host reads nothing inside the loop, and afterwards reads only the
transcript bytes and the zero flags, out of which it slices the messages
(:func:`split_transcripts`).

The single-block product's loop is the port's form of the JAX package's
one program (``_fs_prove_batch_jit``): a :class:`_BatchProgram` per (k,
n, field, B, device), kept in :data:`programs`, whose rounds 2..n-1 are
captured once as a CUDA graph and replayed by every later dispatch
(``ops/graphs.py``); rounds 0 and 1 read the caller's tables and run
eagerly. The multi-block specs (``_spec_rounds``) and
:func:`fs_prove_device_sharded` run eagerly.

Bit-exactness caveat (as in the JAX package): arkworks drops zero
coefficients from serialized ``SparsePolynomial`` terms, which would make
message lengths value-dependent. The device path assumes every coefficient
is nonzero, detects violations per proof, and returns ``None`` for such a
proof; the caller re-proves it on the exact host loop.

Scope (:func:`supports_fused_fs`, the JAX package's decision): the empty
DST, Goldilocks or a mont32 field (F5, F389, F1572869, BabyBear; their
sums, challenges and claims stay Montgomery words on the device, and only
canonical coefficients reach the host), at least one variable, and every
round of degree >= 1. For anything else :func:`fs_prove_device` and
:func:`fs_prove_device_batch` return ``None``, as the JAX package's do, and
the callers run the per-round path. A covered spec that the port's kernels
cannot take (more than three blocks, more than 8 tables or terms, a round
degree above 8) raises ``NotImplementedError`` from
``round_kernel.check_spec`` or ``multiblock.round_plan``; it never falls
back silently.
"""

from __future__ import annotations

import ctypes
import itertools
from collections import OrderedDict
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..fields import GOLDILOCKS, FArray, FieldConfig
from ..fields.farray import tensor_u64, u64_tensor, word_dtype
from . import graphs
from .cuda_round import round_partials
from .round_kernel import PolySpec, check_spec, round_step
from .sha256 import H0, py_compress
from .sha_chain import DevChain, absorb_py, draw_py, len_in_bytes

# launches of the CUDA FS tail kernel (not of the plain version), per
# instantiation
launches = {"goldilocks": 0, "mont32": 0}

MAX_DEGREE = 8  # csrc/fs_tail.cu MAX_D
WIDE_WARPS = 8  # csrc/fs_tail.cu WIDE_WARPS
WIDE_ROWS = 256  # the tail sums more partial rows per proof than this with WIDE_WARPS warps

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("fs_tail")
        lib.ts_fs_tail_launch.argtypes = (
            [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
            + [ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p]
        )
        lib.ts_fs_tail_launch.restype = ctypes.c_int
        lib.ts_sha_chain_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.ts_sha_chain_launch.restype = ctypes.c_int
        _lib = lib
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


def _msg_len(round_idx: int, degree: int, byte_size: int) -> int:
    """Bytes of round ``round_idx``'s message: [c_1] || len || terms."""
    return (byte_size if round_idx == 0 else 0) + 8 + (8 + byte_size) * (degree + 1)


def interp_tensor(field: FieldConfig, degree: int, device) -> torch.Tensor:
    """The inverse-Vandermonde constants as the FS tail takes them, row-major:
    canonical for Goldilocks, Montgomery words (c << 32) mod p for mont32."""
    m = np.array(_interp_matrix(degree, field.p), dtype=object).reshape(-1)
    if field.backend == "mont32":
        m = (m << 32) % field.p
    return u64_tensor(m.astype(np.uint64), device, word_dtype(field))


def supports_fused_fs(spec: PolySpec, field: FieldConfig, dst: bytes) -> bool:
    """Does the fused path cover (spec, field, dst)? The JAX package's
    decision: the empty DST, a Goldilocks or mont32 field, at least one
    variable, and every round degree >= 1 (a degree-0 round would serialize
    a constant whose single coefficient is routinely zero, and arkworks
    drops zero terms, so its length would depend on the values)."""
    if dst != b"":
        return False
    if field.backend not in ("goldilocks", "mont32"):
        return False
    if spec.num_vars() < 1:
        return False
    return all(d >= 1 for d in spec.round_degrees())


def _single_product(spec: PolySpec) -> bool:
    """Is ``spec`` a single-block product of all its tables (the batched
    prover's shape, whose rounds run as one launch for the whole batch)?"""
    k = len(spec.table_blocks)
    return (
        len(spec.block_sizes) == 1
        and len(spec.terms) == 1
        and sorted(spec.terms[0]) == list(range(k))
        and all(tb == (0,) for tb in spec.table_blocks)
    )


def _check_tail(field, partials, chain, claim, r, c1, coeffs, msgs, any_zero, vinv, round_idx, coeff_off):
    dev = partials.device
    w = word_dtype(field)
    if partials.dim() != 3 or partials.dtype != w:
        raise ValueError(f"partials must be a {w} [B, blocks, d+1] tensor")
    batch, _, d1 = partials.shape
    want = {
        "state": (chain.state, torch.int32, (batch, 8)),
        "buf": (chain.buf, torch.uint8, (batch, 64)),
        "claim": (claim, w, (batch,)),
        "r": (r, w, (batch,)),
        "c1": (c1, w, (batch,)),
        "any_zero": (any_zero, torch.int32, (batch,)),
        "vinv": (vinv, w, (d1 * d1,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {dtype} {list(shape)} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if coeffs.dtype != w or coeffs.dim() != 2 or coeffs.shape[0] != batch:
        raise ValueError(f"coeffs must be {w} [{batch}, ncoef]")
    if coeffs.device != dev or not coeffs.is_contiguous() or not partials.is_contiguous():
        raise ValueError("coeffs and partials must be contiguous and on one device")
    if not 0 <= coeff_off <= coeffs.shape[1] - d1:
        raise ValueError("coefficient row offset out of range")
    end = chain.nbytes + _msg_len(round_idx, d1 - 1, field.byte_size)
    if msgs.dtype != torch.uint8 or msgs.dim() != 2 or msgs.shape[0] != batch or msgs.shape[1] < end:
        raise ValueError(f"msgs must be uint8 [{batch}, >= {end}]")
    if msgs.device != dev or not msgs.is_contiguous():
        raise ValueError("msgs must be contiguous and on the partials' device")


def tail_warps(blocks: int) -> int:
    """The FS tail kernel's warps per proof for ``blocks`` partial rows: one
    warp (the batch's tails: a few dozen rows per proof), or the wide form's
    ``WIDE_WARPS`` above ``WIDE_ROWS`` rows (the sharded prover's S x blocks
    rows), whose warps sum the rows together before warp 0 runs the rest.
    ``WIDE_ROWS`` is where the wide form stops losing to one warp over
    Goldilocks on an H100 (``scripts/triangle_times.py --fs-tail``)."""
    return WIDE_WARPS if blocks > WIDE_ROWS else 1


def fs_tail(
    partials: torch.Tensor,
    chain: DevChain,
    claim: torch.Tensor,
    r: torch.Tensor,
    c1: torch.Tensor,
    coeffs: torch.Tensor,
    msgs: torch.Tensor,
    any_zero: torch.Tensor,
    vinv: torch.Tensor,
    round_idx: int,
    coeff_off: int,
    draw: bool,
    field: FieldConfig = GOLDILOCKS,
) -> None:
    """Round ``round_idx``'s FS tail for B proofs, in place: updates
    ``chain`` (state, buf, nbytes), ``coeffs[:, coeff_off:coeff_off+d+1]``,
    the round's message bytes ``msgs[:, chain.nbytes : chain.nbytes + m]``
    (``msgs`` [B, >= chain.nbytes + m] uint8: each row the proof's
    transcript so far), ``any_zero``, ``c1`` (round 0) and, with ``draw``,
    the next ``r`` and ``claim``. ``partials``: the round kernel's
    [B, blocks, d+1]; ``vinv``: :func:`interp_tensor`. Field-valued tensors
    hold ``field``'s words (``word_dtype``): ``claim`` and ``r`` in the
    round kernel's domain, ``c1`` and ``coeffs`` canonical.
    CPU tensors run :func:`fs_tail_plain`; CUDA tensors the kernel, in the
    form :func:`tail_warps` picks from the row count."""
    _check_tail(field, partials, chain, claim, r, c1, coeffs, msgs, any_zero, vinv, round_idx, coeff_off)
    batch, blocks, d1 = partials.shape
    dev = partials.device
    if dev.type == "cpu":
        fs_tail_plain(partials, chain, claim, r, c1, coeffs, msgs, any_zero, vinv, round_idx, coeff_off, draw, field)
    elif dev.type == "cuda":
        if not 1 <= d1 - 1 <= MAX_DEGREE:
            raise NotImplementedError(f"the CUDA FS tail takes round degrees 1 to {MAX_DEGREE}, not {d1 - 1}")
        mont32 = field.backend == "mont32"
        with torch.cuda.device(dev):
            rc = _library().ts_fs_tail_launch(
                int(mont32),
                field.p if mont32 else 0,
                field.mont_pinv_neg if mont32 else 0,
                field.byte_size,
                len_in_bytes(field),
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
                msgs.data_ptr(),
                msgs.shape[1],
                any_zero.data_ptr(),
                vinv.data_ptr(),
                batch,
                round_idx,
                chain.nbytes,
                int(draw),
                tail_warps(blocks),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"FS tail kernel launch failed: CUDA error {rc}")
        launches[field.backend] += 1
    else:
        raise ValueError(f"fs_tail runs on cpu or cuda, not {dev}")
    chain.nbytes += _msg_len(round_idx, d1 - 1, field.byte_size)


def sha_chain(n: int, out: torch.Tensor) -> None:
    """The latency floor under the FS tail's hash path, not on the prover's
    path: one CUDA thread runs ``n`` dependent SHA-256 compressions from the
    initial hash value, compression i over block i % 2 of two blocks that
    hold the big-endian words 0, 1, ..., 31, and writes the final state
    into ``out``, a CUDA int32 [8]."""
    if out.device.type != "cuda" or out.dtype != torch.int32 or out.shape != (8,):
        raise ValueError("out must be a CUDA int32 [8] tensor")
    with torch.cuda.device(out.device):
        rc = _library().ts_sha_chain_launch(n, out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"SHA-256 chain kernel launch failed: CUDA error {rc}")


def sha_chain_plain(n: int) -> List[int]:
    """:func:`sha_chain` in Python ints: the final state as 8 u32 ints."""
    blocks = [b"".join(k.to_bytes(4, "big") for k in range(16 * j, 16 * j + 16)) for j in (0, 1)]
    state = list(H0)
    for i in range(n):
        py_compress(state, blocks[i % 2])
    return state


def _put(t: torch.Tensor, values) -> None:
    t.copy_(u64_tensor(np.array(values, dtype=np.uint64).reshape(t.shape), t.device, t.dtype))


def fs_tail_plain(
    partials, chain, claim, r, c1, coeffs, msgs, any_zero, vinv, round_idx, coeff_off, draw, field=GOLDILOCKS
) -> None:
    """:func:`fs_tail` in Python ints over ``.tolist()``, with the
    pure-Python SHA-256 compression (any device; same in-place outputs).
    mont32 words are taken to canonical values on the way in and back to
    Montgomery words on the way out."""
    batch, _, d1 = partials.shape
    degree = d1 - 1
    p, bs = field.p, field.byte_size
    if field.backend == "mont32":
        rinv, mont_r = pow(field.mont_r, -1, p), field.mont_r
    else:
        rinv = mont_r = 1

    def ints(t):  # words -> canonical ints
        return [int(x) * rinv % p for x in tensor_u64(t).reshape(-1)]

    parts = np.array(ints(partials), dtype=object).reshape(batch, -1, d1)
    m = np.array(ints(vinv), dtype=object).reshape(d1, d1).tolist()
    claims, rs = ints(claim), ints(r)
    c1s = [int(x) for x in tensor_u64(c1)]
    coef = tensor_u64(coeffs).copy()
    zeros = any_zero.cpu().tolist()
    states = chain.state.cpu().numpy().view(np.uint32).tolist()
    bufs = [bytearray(row) for row in chain.buf.cpu().numpy().tolist()]
    out = []
    for b in range(batch):
        s = [int(parts[b, :, e].sum()) % p for e in range(d1)]
        if round_idx > 0:
            s[1] = (claims[b] - s[0]) % p
        c = [sum(m[i][t] * s[t] for t in range(d1)) % p for i in range(d1)]
        zeros[b] |= int(any(x == 0 for x in c))
        coef[b, coeff_off : coeff_off + d1] = c
        msg = []
        if round_idx == 0:
            c1s[b] = (s[0] + s[1]) % p
            msg.append(c1s[b].to_bytes(bs, "little"))
        msg.append(d1.to_bytes(8, "little"))
        for t in range(d1):
            msg.append(t.to_bytes(8, "little") + c[t].to_bytes(bs, "little"))
        msg = b"".join(msg)
        out.append(msg)
        absorb_py(states[b], bufs[b], chain.nbytes, msg)
        if draw:
            rs[b] = draw_py(field, states[b], bufs[b], chain.nbytes + len(msg))
            acc = c[degree]
            for i in range(degree - 1, -1, -1):
                acc = (acc * rs[b] + c[i]) % p
            claims[b] = acc
    _put(claim, [x * mont_r % p for x in claims])
    _put(r, [x * mont_r % p for x in rs])
    _put(c1, c1s)
    _put(coeffs, coef)
    rows = np.frombuffer(b"".join(out), dtype=np.uint8).reshape(batch, -1)
    msgs[:, chain.nbytes : chain.nbytes + rows.shape[1]] = torch.from_numpy(rows.copy())
    any_zero.copy_(torch.tensor(zeros, dtype=torch.int32))
    chain.state.copy_(torch.from_numpy(np.array(states, dtype=np.uint32).view(np.int32)))
    chain.buf.copy_(torch.tensor([list(bb) for bb in bufs], dtype=torch.uint8))


class _Dispatch:
    """One dispatch's state for B proofs on one device, the FS tail's
    in-place operands: the chains, the challenges, claims, c_1 and
    coefficients, the transcript bytes and the zero flags, and one
    interpolation matrix per distinct round degree."""

    def __init__(self, spec: PolySpec, field: FieldConfig, batch: int, dev):
        self.field, self.n = field, spec.num_vars()
        self.degrees = spec.round_degrees()
        self.vinv = {d: interp_tensor(field, d, dev) for d in sorted(set(self.degrees))}
        w = word_dtype(field)
        self.chain = DevChain.fresh(batch, dev)
        self.r, self.claim, self.c1 = (torch.zeros(batch, dtype=w, device=dev) for _ in range(3))
        self.coeffs = torch.zeros((batch, sum(d + 1 for d in self.degrees)), dtype=w, device=dev)
        self.offs = list(itertools.accumulate((d + 1 for d in self.degrees), initial=0))
        self.lens = [_msg_len(j, d, field.byte_size) for j, d in enumerate(self.degrees)]
        self.msgs = torch.zeros((batch, sum(self.lens)), dtype=torch.uint8, device=dev)
        self.any_zero = torch.zeros(batch, dtype=torch.int32, device=dev)

    def tail(self, j: int, partials: torch.Tensor) -> None:
        """Round j's FS tail over its round sums or partials."""
        fs_tail(partials, self.chain, self.claim, self.r, self.c1, self.coeffs, self.msgs, self.any_zero,
                self.vinv[self.degrees[j]], j, self.offs[j], j < self.n - 1, self.field)

    def read(self) -> List[Optional[list]]:
        """The one host read, the transcript bytes and the zero flags, and
        each proof's messages (:func:`split_transcripts`)."""
        host = torch.cat([self.msgs, self.any_zero[:, None].view(torch.uint8)], 1).cpu().numpy()
        return split_transcripts(host, self.lens)

    def tensors(self) -> List[torch.Tensor]:
        return [self.chain.state, self.chain.buf, self.r, self.claim, self.c1, self.coeffs, self.msgs,
                self.any_zero, *self.vinv.values()]


class _BatchProgram:
    """The batch round loop of a single-block product of k tables (k = 1..8)
    over B proofs of n variables on one device, as one program: the
    counterpart of the JAX package's ``_fs_prove_batch_jit``
    (``jax.jit(jax.vmap(_fs_prove_impl))``). It holds the dispatch state
    (:class:`_Dispatch`) and the ping-pong fold buffers; round j >= 1 folds
    [B, 2^(n - j + 1)] into buffer (j - 1) % 2.

    Rounds 0 and 1 read the caller's tables (never copied, never written),
    so they run eagerly in every dispatch: the round kernel, then the FS
    tail. Rounds 2..n-1 read only the program's buffers: on a CUDA device
    the first dispatch runs them eagerly (filling every lazy cache; its
    bytes are the result) and then captures them as one CUDA graph
    (:class:`graphs.Graph`), which every later dispatch replays. On the CPU
    they run eagerly over the plain versions every time. Before round 0
    each dispatch resets the chains and the zero flags; every other operand
    is written before it is read (the transcript bytes and coefficients in
    full, r, claim and c_1 by round 0's tail)."""

    def __init__(self, spec: PolySpec, field: FieldConfig, batch: int, dev):
        self.n, self.batch, self.field, self.dev = spec.num_vars(), batch, field, dev
        self.state = _Dispatch(spec, field, batch, dev)
        self.fresh = self.state.chain.state.clone()
        w = word_dtype(field)
        size = 1 << self.n
        self.bufs = [[torch.empty(batch * size // 2, dtype=w, device=dev),
                      torch.empty(batch * size // 4, dtype=w, device=dev)] for _ in spec.table_blocks]
        self.graph: Optional[graphs.Graph] = None

    def held_bytes(self) -> int:
        """Device bytes the program holds: its buffers and its graph's pool."""
        ts = self.state.tensors() + [self.fresh] + [b for pp in self.bufs for b in pp]
        return sum(t.numel() * t.element_size() for t in ts) + (self.graph.pool_bytes if self.graph else 0)

    def _rounds(self, cur, j0: int, j1: int):
        """Rounds j0..j1-1 over ``cur`` (the tables before round j0);
        returns the tables after them."""
        s, batch, size = self.state, self.batch, 1 << self.n
        for j in range(j0, j1):
            if j == 0:
                _, partials = round_partials(cur, field=self.field)
            else:
                m = size >> j
                out = [pp[(j - 1) % 2][: batch * m].view(batch, m) for pp in self.bufs]
                cur, partials = round_partials(cur, s.r, skip_t1=True, out=out, field=self.field)
            s.tail(j, partials)
        return cur

    def prove(self, data, graph: bool = True) -> List[Optional[list]]:
        """One dispatch over the caller's [B, 2^n] tables ``data``; with
        ``graph`` False rounds 2..n-1 run eagerly (the profiling route)."""
        s = self.state
        if any(d.shape != (self.batch, 1 << self.n) for d in data):
            raise ValueError(f"tables of {list(data[0].shape)} words for {self.batch} proofs of {self.n} variables")
        s.chain.state.copy_(self.fresh)
        s.chain.buf.zero_()
        s.chain.nbytes = 0
        s.any_zero.zero_()
        first = self._rounds(data, 0, min(2, self.n))
        if graph and self.graph is not None:
            self.graph.replay()
        else:
            self._rounds(first, 2, self.n)
        out = s.read()
        if graph and self.graph is None and self.n > 2 and self.dev.type == "cuda":
            s.chain.nbytes = sum(s.lens[:2])
            self.graph = graphs.Graph(self.dev, lambda: self._rounds(first, 2, self.n))
        return out


# the batch programs, (k, n, field, B, device) -> _BatchProgram, the most
# recently used last; at most MAX_PROGRAMS are kept (each holds its fold
# buffers: 3.2 GB for B = 64 Goldilocks proofs of n = 22)
programs: "OrderedDict[tuple, _BatchProgram]" = OrderedDict()
MAX_PROGRAMS = 4


def _batch_program(spec: PolySpec, field: FieldConfig, batch: int, dev) -> _BatchProgram:
    key = (len(spec.table_blocks), spec.num_vars(), field.name, batch, dev)
    prog = programs.get(key)
    if prog is None:
        while len(programs) >= MAX_PROGRAMS:
            programs.popitem(last=False)
        prog = programs[key] = _BatchProgram(spec, field, batch, dev)
    programs.move_to_end(key)
    return prog


def fs_prove_device_batch(
    spec: PolySpec, tables: Sequence[FArray], dst: bytes = b""
) -> Optional[List[Optional[list]]]:
    """B independent whole proofs, the round sums and one FS tail launch per
    round.

    ``tables``: per-table FArrays of shape [B, size_k] on one device, size_k
    the entries of table k under ``spec`` (2^n for the batched prover's
    single-block product); the inputs are never written. A single-block
    product of all the tables runs as one program per (k, n, field, B,
    device) (:class:`_BatchProgram`: rounds 2..n-1 replayed from a CUDA
    graph after the first dispatch); every other spec runs ``round_step``
    per proof and round. Returns a list of B entries — each a message
    list, or ``None`` for an instance whose serialized coefficients hit a
    zero (the caller re-proves only that instance on the host loop).
    Returns ``None`` outright when :func:`supports_fused_fs` does not cover
    (spec, field, dst), as the JAX package's does."""
    return _prove_batch(spec, tables, dst, graph=True)


def _prove_batch(spec: PolySpec, tables: Sequence[FArray], dst: bytes, graph: bool):
    """:func:`fs_prove_device_batch`; ``graph`` False runs a product's
    rounds 2..n-1 eagerly (the profiling route, no capture)."""
    field = tables[0].field
    if not supports_fused_fs(spec, field, dst):
        return None
    if len(tables) != len(spec.table_blocks):
        raise ValueError(f"{len(tables)} tables for a spec of {len(spec.table_blocks)}")
    data = [t.data for t in tables]
    if any(d.dim() != 2 for d in data):
        raise ValueError("fs_prove_device_batch takes [B, size] tables")
    batch, dev = data[0].shape[0], data[0].device
    if _single_product(spec):
        return _batch_program(spec, field, batch, dev).prove(data, graph)
    state = _Dispatch(spec, field, batch, dev)
    for j, sums in enumerate(_spec_rounds(spec, data, field, state.r, state.claim)):
        state.tail(j, sums)
    return state.read()


def _spec_rounds(spec: PolySpec, data, field: FieldConfig, r: torch.Tensor, claim: torch.Tensor):
    """Round j's sums [B, 1, D_j + 1] of any other spec: ``round_step`` once
    per proof (its kernels return s(0..D) on the card, the claim's s(1)
    included), each folding at its proof's challenge ``r[b]`` with the claim
    ``claim[b]``, both written by the previous round's tail."""
    batch = data[0].shape[0]
    cur = [tuple(FArray(d[b], field) for d in data) for b in range(batch)]
    for b in range(batch):
        check_spec(spec, cur[b])
    cur_spec = spec
    for j, degree in enumerate(spec.round_degrees()):
        sums = torch.empty((batch, 1, degree + 1), dtype=data[0].dtype, device=data[0].device)
        for b in range(batch):
            if j == 0:
                s, cur[b] = round_step(spec, cur[b], None)
            else:
                s, cur[b] = round_step(cur_spec, cur[b], FArray(r[b], field), FArray(claim[b], field))
            sums[b, 0] = s.data
        if j > 0:
            cur_spec = cur_spec.after_fold()
        yield sums


def split_transcripts(host: np.ndarray, lens: Sequence[int]) -> List[Optional[list]]:
    """The host's work after the read. ``host``: [B, sum(lens) + 4] uint8,
    each row a proof's transcript bytes and then its zero flag (an int32).
    Returns each proof's messages (``lens`` bytes each) sliced out of one
    ``bytes`` object, or ``None`` for a flagged proof."""
    total = sum(lens)
    width = host.shape[1]
    blob = host.tobytes()
    cuts = list(itertools.accumulate(lens, initial=0))
    spans = list(zip(cuts[:-1], cuts[1:]))
    flags = host[:, total:].any(1).tolist()
    return [
        None if flagged else [blob[b * width + s : b * width + e] for s, e in spans]
        for b, flagged in enumerate(flags)
    ]


def fs_prove_device(
    spec: PolySpec, tables: Sequence[FArray], dst: bytes = b""
) -> Optional[list]:
    """One whole proof (1-D tables): a batch of one. Returns the serialized
    round messages, or ``None`` when a zero coefficient forces the exact
    host loop or when (spec, field, dst) is not covered."""
    out = fs_prove_device_batch(spec, [t.reshape(1, -1) for t in tables], dst)
    return None if out is None else out[0]


def fs_prove_device_sharded(
    spec: PolySpec,
    tables: Sequence[FArray],
    mesh,
    n_shard: Optional[int] = None,
    dst: bytes = b"",
    axis=None,
) -> Optional[list]:
    """One whole proof across a mesh (JAX :510): the tables (1-D, internal
    order, on any device) laid out as ``parallel.ShardedBlockPoly`` lays
    them (the trailing ``n_shard`` variables of the last block, default
    log2 of the mesh size, on the mesh), then per round the sharded round
    sums (``parallel.sharded.device_rounds``: each device's shards in one
    launch of the round kernel's batch form for a single-block product,
    else the multi-block kernel per shard and the batched tensor-core
    contraction; s(1) left out), their reduction
    (``parallel.sharded.collective``) and one FS tail launch on the first
    device, which sums the rows, fills s(1) = claim - s(0) and draws the
    next challenge. When the local variables are exhausted the residual
    [2^n_shard] tables are gathered and the last rounds run replicated. Every
    process runs the same rounds and tails, so each derives the same
    challenges. Returns the serialized round messages, byte-identical to
    the host loop and :func:`fs_prove_device`, or ``None`` where the JAX
    package's does: (spec, field, dst) not covered, or a zero serialized
    coefficient."""
    from ..parallel.sharded import ShardedBlockPoly, device_rounds

    field = tables[0].field
    if not supports_fused_fs(spec, field, dst):
        return None
    poly = ShardedBlockPoly.from_internal_tables(spec, tables, mesh, n_shard=n_shard, axis=axis)
    state = _Dispatch(spec, field, 1, mesh.primary)
    for j, rows in enumerate(device_rounds(poly, state.r, state.claim)):
        state.tail(j, rows)
    return state.read()[0]
