"""Device-side GKR bookkeeping: eq tables, gathers, the LibraW phase tables.

Counterpart of ``thaler_study_tpu/gkr/device_tables.py``, shipped defaults
only (the ``scan`` scatter mode; the ``segment`` and ``plan`` modes and the
``assoc`` core are A/B switches of the JAX package and are not ported).

The phase tables of the linear-time layer sumcheck (``gkr/linear.py``)
are exact modular scatter-adds, grid[idx[g]] += vals[g] mod p, which no
PyTorch call states (``index_add_`` wraps mod 2^64). They are kernel K2,
``csrc/phase_tables.cu``, entered through :func:`phase_tables`:

- phase 1 (key b_g, gather W[c_g]):
  a1[b] = sum_{g: b_g = b} (mul_g ? eq_r[g] W[c_g] : eq_r[g]),
  a2[b] = sum_{g: b_g = b} (mul_g ? 0 : eq_r[g] W[c_g]);
- phase 2 (key c_g, gather eq_u[b_g]), with t_g = eq_r[g] eq_u[b_g]:
  b1[c] = sum_{g: c_g = c} (mul_g ? 0 : t_g),
  b2[c] = sum_{g: c_g = c} (mul_g ? t_g : 0).

Both outputs come out of one launch, in internal MSB-first order (the
JAX package's ``lsb_to_msb``). The kernel reads the layer's static plan
(``circuit.PhasePlan``: the gates listed in output order, their gather
index and type packed in that order), so it writes each output position
once, in order; its plain version, :func:`phase_tables_plain`, scatters
by the key itself with ``index_add_`` over 32-bit halves and then bit
reverses, so the two agree only if the plan is right. The same kernel
writes a device's shard rows of the sharded layout straight
(:func:`phase_tables_rows`, for the sharded fused GKR prover; plain
version :func:`phase_tables_rows_plain`): it walks the plan of that
group of rows, which lists the rows' cells in the layout's order, so the
rows are one contiguous range of positions, as the whole table is.

Two more builders have kernels of their own, ``csrc/gkr_tables.cu``:

- :func:`eq_table_dev`, eq(x, r) over 2^n indices (plain version
  :func:`eq_table_plain`, n interleave steps), and :func:`eq_table_dot`,
  the same table of u and W~(u) = sum_x W[x] eq(x, u) in the same pass
  (plain version: the table, then :func:`dot_mod`), the phase-2 build's
  pair;
- :func:`line_restrict_coeffs` / :func:`line_restrict_chal`, the k + 1
  coefficients of q(t) = W~(u + t delta), the fused GKR prover's line
  restriction, given delta or the layer's challenge vector (u, c) with
  delta = c - u formed in the kernel (plain version
  :func:`line_restrict_coeffs_plain`, the JAX package's symbolic fold in
  FArray ops). The kernel folds in tiles (:func:`line_plan`);
  :func:`line_restrict_tiled_plain` mirrors its tiles and indexing in
  torch ops.

The gathers here are plain torch, exact (the JAX package's jnp
programs); the bit reversal (:func:`lsb_to_msb`) is ``ops/mle_kernel``'s
kernel on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from .. import _build
from ..fields import FArray, FieldConfig
from ..fields import goldilocks as gl
from ..fields.farray import word_dtype
from ..mle.dense import bitrev

THREADS = 256  # csrc/phase_tables.cu THREADS

EQ_LOW = 12  # csrc/gkr_tables.cu LOW: eq entries per block, log2
LINE_SMEM_BYTES = 96 * 1024  # csrc/gkr_tables.cu LINE_SMEM_BYTES
LINE_REG = 4  # csrc/gkr_tables.cu LINE_REG
LINE_ONE = 10  # the line restriction takes one tile up to this k
LINE_WAVE = 7  # log2 of the first tile's least block count (132 SMs)

# launches of the CUDA kernels (not of the plain versions), per instantiation:
# K2, K2 over shard rows, the eq table, the eq table with the dot, the line
# restriction's tiles
launches = {"goldilocks": 0, "mont32": 0}
rows_launches = {"goldilocks": 0, "mont32": 0}
eq_launches = {"goldilocks": 0, "mont32": 0}
eq_dot_launches = {"goldilocks": 0, "mont32": 0}
line_launches = {"goldilocks": 0, "mont32": 0}

_fn = None
_tables = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("phase_tables").ts_phase_tables_launch
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int]
            + [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _tables_lib():
    global _tables
    if _tables is None:
        lib = _build.load("gkr_tables")
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.ts_eq_table_launch.argtypes = [i, u, u, vp, i, vp, vp]
        lib.ts_eq_table_launch.restype = i
        lib.ts_eq_dot_launch.argtypes = [i, u, u, vp, i, vp, vp, vp, vp, vp, vp]
        lib.ts_eq_dot_launch.restype = i
        lib.ts_line_tile_launch.argtypes = [i, u, u, vp, i, i, vp, vp, i, vp, u, i, i, vp, vp, vp]
        lib.ts_line_tile_launch.restype = i
        _tables = lib
    return _tables


def _field_args(field: FieldConfig):
    mont32 = field.backend == "mont32"
    return int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0


def _check_cuda(name: str, dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")


def _check_vector(name: str, x: FArray, n: int) -> None:
    if x.data.dim() != 1 or x.shape[0] < n or not x.data.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D FArray of at least {n} elements, got {x.shape}")


def eq_table_dev(r: FArray, n: int) -> FArray:
    """eq(x, r) over little-endian indices (index bit j = r[j]) for the 2^n
    x, on r's device (the host ``runtime.eq_table``'s order). CPU tensors
    run :func:`eq_table_plain`; CUDA tensors launch the eq-table kernel or
    raise."""
    _check_vector("r", r, n)
    dev = r.device
    if dev.type == "cpu":
        return eq_table_plain(r, n)
    _check_cuda("eq_table_dev", dev)
    out = torch.empty(1 << n, dtype=word_dtype(r.field), device=dev)
    with torch.cuda.device(dev):
        rc = _tables_lib().ts_eq_table_launch(
            *_field_args(r.field), r.data.data_ptr(), n, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream
        )
    if rc != 0:
        raise RuntimeError(f"eq-table kernel launch failed: CUDA error {rc}")
    eq_launches[r.field.backend] += 1
    return FArray(out, r.field)


def eq_table_dot(u: FArray, w_lsb: FArray, n: int) -> Tuple[FArray, FArray]:
    """(eq(x, u) over the 2^n little-endian x, W~(u) = sum_x W[x] eq(x, u)
    as a (1,) FArray) for W in label order (``w_lsb``, 2^n values): the
    phase-2 build's eq table and the scalar K1 reads. CPU tensors run
    :func:`eq_table_plain` then :func:`dot_mod`; CUDA tensors launch the
    eq-table kernel with the dot in the same pass (one launch) or raise."""
    _check_vector("u", u, n)
    if w_lsb.shape != (1 << n,) or not w_lsb.data.is_contiguous():
        raise ValueError(f"w_lsb must be a contiguous FArray of {1 << n} values, got {w_lsb.shape}")
    dev = u.device
    if w_lsb.field != u.field or w_lsb.device != dev:
        raise ValueError("u and w_lsb must be FArrays of one field on one device")
    if dev.type == "cpu":
        eq = eq_table_plain(u, n)
        return eq, dot_mod(w_lsb, eq)
    _check_cuda("eq_table_dot", dev)
    dtype = word_dtype(u.field)
    out = torch.empty(1 << n, dtype=dtype, device=dev)
    w_u = torch.empty(1, dtype=dtype, device=dev)
    partials = torch.empty(1 << max(n - EQ_LOW, 0), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _tables_lib().ts_eq_dot_launch(
            *_field_args(u.field), u.data.data_ptr(), n, out.data_ptr(), w_lsb.data.data_ptr(), partials.data_ptr(),
            _build.ticket_counter(dev).data_ptr(), w_u.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"eq-with-dot kernel launch failed: CUDA error {rc}")
    eq_dot_launches[u.field.backend] += 1
    return FArray(out, u.field), FArray(w_u, u.field)


def eq_table_plain(r: FArray, n: int) -> FArray:
    """:func:`eq_table_dev` in plain torch ops (any device): n interleave
    steps, t -> (t (1 - r_j), t r_j) from the last variable down."""
    t = FArray.from_ints([1], r.field, device=r.device)
    for j in reversed(range(n)):
        hi = t * r[j]
        lo = t - hi
        t = FArray(torch.stack([lo.data, hi.data], dim=1).reshape(-1), r.field)
    return t


def _tile_reg(d: int, t: int) -> int:
    """The variables a tile folds in registers before shared memory:
    ``LINE_REG`` for a tile over W itself (d = 0) of more variables, else 0."""
    return LINE_REG if d == 0 and t > LINE_REG else 0


def _tile_words(d: int, t: int) -> int:
    """The shared-memory words of a line-restriction tile folding t
    variables of polynomials of degree d: its first table (the tile, or the
    register folds' 2^(t - R) polynomials of degree R) and, when a second
    shared step follows, the first step's output after it (later steps fit
    in what those two free)."""
    r = _tile_reg(d, t)
    polys = 1 << (t - r)
    first = polys * (d + r + 1)
    return first if t - r == 1 else first + (polys >> 1) * (d + r + 2)


def line_plan(k: int, word_bytes: int, first: Optional[int] = None) -> List[int]:
    """The line restriction's tiles: the number of variables each launch
    folds, in order, summing to k. Up to k = ``LINE_ONE`` one tile (one
    block); above it the first tile leaves 2^LINE_WAVE blocks or more (a
    wave of the card's SMs) and each later tile is the largest that fits
    ``LINE_SMEM_BYTES`` of shared memory. ``first``, when given, sets the
    first tile (clamped to k). Goldilocks at k = 20: [13, 7]."""
    cap = LINE_SMEM_BYTES // word_bytes

    def fit(d: int) -> int:
        return max(t for t in range(1, k - d + 1) if t == 1 or _tile_words(d, t) <= cap)

    if first is not None:
        tiles = [max(1, min(first, k))]
    elif k <= LINE_ONE:
        tiles = [k] if k else []
    else:
        tiles = [min(fit(0), k - LINE_WAVE)]
    d = sum(tiles)
    while d < k:
        tiles.append(fit(d))
        d += tiles[-1]
    return tiles


def _check_line(w_lsb: FArray, k: int, vectors) -> None:
    if w_lsb.shape != (1 << k,) or not w_lsb.data.is_contiguous():
        raise ValueError(f"w_lsb must be a contiguous FArray of {1 << k} values, got {w_lsb.shape}")
    for name, x, n in vectors:
        _check_vector(name, x, n)
        if x.field != w_lsb.field or x.device != w_lsb.device:
            raise ValueError(f"w_lsb and {name} must be FArrays of one field on one device")


def line_launches_of(tiles: List[int]) -> List[Tuple[int, int]]:
    """The launches of a tile plan as (t, tail_t) pairs: the last tile runs
    in the last block of the launch before it (tail_t), so a plan of n >= 2
    tiles is n - 1 launches (one at k = 20)."""
    if len(tiles) < 2:
        return [(t, 0) for t in tiles]
    return [(t, 0) for t in tiles[:-2]] + [(tiles[-2], tiles[-1])]


def _line_tiles(w_lsb: FArray, k: int, u: torch.Tensor, v: torch.Tensor, v_is_c: bool) -> FArray:
    """The launches of :func:`line_plan` on the card."""
    field, dev = w_lsb.field, w_lsb.device
    _check_cuda("line_restrict_coeffs", dev)
    lib, args = _tables_lib(), _field_args(field)
    stream = torch.cuda.current_stream(dev).cuda_stream
    word_bytes = w_lsb.data.element_size()
    cur, d = w_lsb.data, 0
    if k == 0:
        return FArray(cur.clone(), field)
    for t, tail in line_launches_of(line_plan(k, word_bytes)):
        blocks = 1 << (k - d - t)
        out = torch.empty(blocks * (d + t + 1), dtype=cur.dtype, device=dev)
        final = torch.empty(d + t + tail + 1, dtype=cur.dtype, device=dev) if tail else None
        words = max(_tile_words(d, t), _tile_words(d + t, tail) if tail else 0)
        with torch.cuda.device(dev):
            rc = lib.ts_line_tile_launch(
                *args, cur.data_ptr(), d, t, u.data_ptr(), v.data_ptr(), int(v_is_c), out.data_ptr(), blocks,
                words * word_bytes, tail, final.data_ptr() if tail else None, _build.ticket_counter(dev).data_ptr(),
                stream,
            )
        if rc != 0:
            raise RuntimeError(f"line-restriction kernel launch failed: CUDA error {rc}")
        line_launches[field.backend] += 1
        cur, d = (final if tail else out), d + t + tail
    return FArray(cur, field)


def line_restrict_coeffs(w_lsb: FArray, u: FArray, delta: FArray, k: int) -> FArray:
    """The coefficients (ascending powers of t) of q(t) = W~(u + t delta),
    the degree-k restriction of the multilinear W (``w_lsb``, 2^k values in
    label order) to a line: W folded one variable at a time with
    r_j(t) = u_j + t delta_j carried symbolically (``csrc/gkr_tables.cu``).
    Returns a [k + 1] FArray. CPU tensors run
    :func:`line_restrict_coeffs_plain`; CUDA tensors launch the kernel
    (:func:`line_plan`, :func:`line_launches_of`: one launch at k = 20) or
    raise."""
    _check_line(w_lsb, k, (("u", u, k), ("delta", delta, k)))
    if w_lsb.device.type == "cpu":
        return line_restrict_coeffs_plain(w_lsb, u, delta, k)
    return _line_tiles(w_lsb, k, u.data, delta.data, False)


def line_restrict_chal(w_lsb: FArray, chal: FArray, k: int) -> FArray:
    """:func:`line_restrict_coeffs` on the line through u = chal[:k] and
    c = chal[k:2k] (delta = c - u): the fused prover's form, which reads
    the layer's challenge vector as it lies on the card. CUDA tensors form
    delta inside the kernel; CPU tensors run the plain version on
    (u, c - u)."""
    _check_line(w_lsb, k, (("chal", chal, 2 * k),))
    if w_lsb.device.type == "cpu":
        u = chal[:k]
        return line_restrict_coeffs_plain(w_lsb, u, chal[k : 2 * k] - u, k)
    return _line_tiles(w_lsb, k, chal.data, chal.data[k:], True)


def line_restrict_coeffs_plain(w_lsb: FArray, u: FArray, delta: FArray, k: int) -> FArray:
    """:func:`line_restrict_coeffs` in FArray ops (any device), the JAX
    package's fold: each step turns the [2h, j + 1] table of degree-j
    polynomials into [h, j + 2], even + r_j(t) (odd - even)."""
    field = w_lsb.field
    arr = w_lsb.reshape(-1, 1)
    for j in range(k):
        pairs = arr.data.reshape(-1, 2, j + 1)
        even, odd = FArray(pairs[:, 0, :], field), FArray(pairs[:, 1, :], field)
        diff = odd - even
        zero = torch.zeros_like(even.data[:, :1])
        # r_j(t) diff(t) = u_j diff + t delta_j diff
        a = torch.cat([(diff * u[j]).data, zero], dim=1)
        b = torch.cat([zero, (diff * delta[j]).data], dim=1)
        arr = FArray(torch.cat([even.data, zero], dim=1), field) + FArray(a, field) + FArray(b, field)
    return arr.reshape(-1)


def _mirror_step(src: torch.Tensor, at: int, nout: int, deg: int, uj: FArray, dj: FArray) -> torch.Tensor:
    """One fold step of the kernel's ``line_step`` over each row of ``src``
    (a block's words): input polynomials of deg + 1 coefficients from word
    ``at``, nout * (deg + 2) output words, one per index as the kernel's
    threads take them."""
    field = uj.field
    width = deg + 2
    idx = torch.arange(nout * width, device=src.device)
    i, m = idx // width, idx % width
    e_at = at + 2 * i * (deg + 1)
    zero = torch.zeros((), dtype=src.dtype, device=src.device)

    def word(pos, ok):
        return FArray(torch.where(ok, src[:, torch.where(ok, pos, at)], zero), field)

    lo, hi = m <= deg, m >= 1
    e, o = word(e_at + m, lo), word(e_at + deg + 1 + m, lo)
    e1, o1 = word(e_at + m - 1, hi), word(e_at + deg + m, hi)
    y = FArray(torch.where(lo, (e + (o - e) * uj).data, zero), field)
    return (y + (o1 - e1) * dj).data


def line_restrict_tiled_plain(w_lsb: FArray, u: FArray, delta: FArray, k: int, first: Optional[int] = None) -> FArray:
    """The line-restriction kernel's tiles and indexing in torch ops (any
    device), to find indexing faults off the card: each tile of
    :func:`line_plan` (``first`` sets the first) folds its first R
    variables per group of 2^R words (the kernel's registers,
    :func:`_tile_reg`), lays the polynomials into a per-block buffer of
    :func:`_tile_words` words, runs the remaining steps between the
    buffer's two regions with the kernel's offsets and one output word per
    index, and writes one polynomial per tile. Equal to
    :func:`line_restrict_coeffs_plain`."""
    dev = w_lsb.device
    cur, d = w_lsb.data, 0
    for t in line_plan(k, w_lsb.data.element_size(), first):
        blocks, r = 1 << (k - d - t), _tile_reg(d, t)
        tile = cur.reshape(blocks, (1 << t) * (d + 1))
        if r:  # each group of 2^r words folded alone, as one thread does
            groups = tile.reshape(-1, 1 << r)
            for s in range(r):
                groups = _mirror_step(groups, 0, 1 << (r - s - 1), s, u[s], delta[s])
            tile = groups.reshape(blocks, -1)
        buf = torch.zeros(blocks, _tile_words(d, t), dtype=cur.dtype, device=dev)
        buf[:, : tile.shape[1]] = tile
        in_off, in_size, nin = 0, tile.shape[1], 1 << (t - r)
        for s in range(r, t):
            deg, nout = d + s, nin >> 1
            y = _mirror_step(buf, in_off, nout, deg, u[deg], delta[deg])
            out_off = in_size if in_off == 0 else 0
            if s == t - 1:
                cur = y.reshape(-1)
            else:
                buf[:, out_off : out_off + y.shape[1]] = y
            in_off, in_size, nin = out_off, y.shape[1], nout
        d += t
    return FArray(cur.reshape(-1), w_lsb.field)


def gather(table: FArray, idx: torch.Tensor) -> FArray:
    """table[idx] (a row gather of one word per element)."""
    return FArray(torch.index_select(table.data, 0, idx), table.field)


def dot_mod(a: FArray, b: FArray) -> FArray:
    """sum_i a[i] b[i] mod p, as a (1,) FArray."""
    return (a * b).sum(axis=0).reshape(1)


def lsb_to_msb(table: FArray, n: int) -> FArray:
    """Label (little-endian) order -> internal MSB-first order."""
    return bitrev(table, n)


def _scatter_add_mod(key: torch.Tensor, vals: FArray, size: int) -> FArray:
    """grid[key[g]] += vals[g] mod p over a zero grid: integer index_add_
    of the words' 32-bit halves (Goldilocks) or of the words (mont32, each
    < 2^31), exact for fewer than 2^31 contributions per cell, then one
    reduction per cell."""
    key = key.to(torch.int64)
    x = vals.data
    if vals.field.backend == "goldilocks":
        lo = torch.zeros(size, dtype=torch.int64, device=x.device).index_add_(0, key, x & gl.MASK32)
        hi = torch.zeros(size, dtype=torch.int64, device=x.device).index_add_(0, key, (x >> 32) & gl.MASK32)
        return FArray(gl.add(lo, gl.mul(hi, torch.full_like(hi, 1 << 32))), vals.field)
    s = torch.zeros(size, dtype=torch.int64, device=x.device).index_add_(0, key, x.to(torch.int64))
    return FArray((s % vals.field.p).to(torch.int32), vals.field)


def _check(phase, wiring, eq_r: FArray, table: FArray, k: int) -> None:
    g = wiring.b.shape[0]
    dev = eq_r.device
    dtype = word_dtype(eq_r.field)
    if phase not in (1, 2):
        raise ValueError(f"phase must be 1 or 2, not {phase}")
    if table.field != eq_r.field or table.data.dtype != dtype or eq_r.data.dtype != dtype:
        raise ValueError("eq_r and the gathered table must be FArrays of one field")
    if table.data.dim() != 1 or table.shape[0] < 1 << k:
        raise ValueError(f"the gathered table must hold the 2^{k} values the labels index")
    want = [(wiring.b, torch.int32, (g,)), (wiring.c, torch.int32, (g,)), (wiring.is_mul, torch.bool, (g,)),
            (eq_r.data, dtype, (g,)), (table.data, dtype, (table.shape[0],))]
    for t, dt, shape in want:
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
            raise ValueError(f"phase_tables: expected a contiguous {dt} {shape} tensor on {dev}")


def phase_tables(phase: int, wiring, eq_r: FArray, table: FArray, k: int) -> Tuple[FArray, FArray]:
    """The two phase tables of a LibraW phase (module doc), each of 2^k
    cells in internal MSB-first order.

    ``wiring``: the layer's ``circuit.LayerWiring`` (phase 1 keys on b and
    gathers at c, phase 2 keys on c and gathers at b, each over its plan);
    ``eq_r``: eq(r_i, g) over the layer's gates; ``table``: W in label
    order (phase 1) or eq_u (phase 2). CPU tensors take
    :func:`phase_tables_plain`; CUDA tensors launch kernel K2 or raise."""
    eq_r = eq_r[: wiring.b.shape[0]] if eq_r.shape[0] != wiring.b.shape[0] else eq_r
    _check(phase, wiring, eq_r, table, k)
    dev = eq_r.device
    if dev.type == "cpu":
        key, gidx = (wiring.b, wiring.c) if phase == 1 else (wiring.c, wiring.b)
        return phase_tables_plain(phase, key, gidx, wiring.is_mul, eq_r, table, k)
    _check_cuda("phase_tables", dev)
    out1, out2 = _launch(phase, wiring.plan(phase), eq_r, table, 1, 1 << k)
    launches[eq_r.field.backend] += 1
    return FArray(out1.reshape(-1), eq_r.field), FArray(out2.reshape(-1), eq_r.field)


def phase_tables_rows(phase: int, wiring, eq_r: FArray, table: FArray, k: int, n_shard: int, row0: int,
                      rows: int) -> Tuple[FArray, FArray]:
    """Shard rows ``row0 .. row0 + rows - 1`` of :func:`phase_tables`'
    two tables in the sharded layout of ``parallel/sharded.py`` (row = the
    last ``n_shard`` variables, the low bits of the MSB-first position):
    [rows, 2^(k - n_shard)] each, entry [i, j] the cell at position
    (j << n_shard) | (row0 + i). ``eq_r`` and ``table`` are whole (the gates
    of a row may gather anywhere), on the device the rows go to. CPU tensors
    take :func:`phase_tables_rows_plain`; CUDA tensors launch K2 once over
    the group's plan (``wiring.plan(phase, n_shard, row0, rows)``, made at
    the first call: its positions are the rows' words in order) or
    raise."""
    if not 0 <= n_shard <= k or rows < 1 or not 0 <= row0 <= (1 << n_shard) - rows:
        raise ValueError(f"rows {row0}..{row0 + rows - 1} are not shard rows of 2^{n_shard} over {k} variables")
    eq_r = eq_r[: wiring.b.shape[0]] if eq_r.shape[0] != wiring.b.shape[0] else eq_r
    _check(phase, wiring, eq_r, table, k)
    dev = eq_r.device
    if dev.type == "cpu":
        key, gidx = (wiring.b, wiring.c) if phase == 1 else (wiring.c, wiring.b)
        return phase_tables_rows_plain(phase, key, gidx, wiring.is_mul, eq_r, table, k, n_shard, row0, rows)
    _check_cuda("phase_tables_rows", dev)
    out1, out2 = _launch(phase, wiring.plan(phase, n_shard, row0, rows), eq_r, table, rows, 1 << (k - n_shard))
    rows_launches[eq_r.field.backend] += 1
    return FArray(out1, eq_r.field), FArray(out2, eq_r.field)


def _launch(phase: int, plan, eq_r: FArray, table: FArray, rows: int, cols: int):
    """K2 on the card over a plan of rows x cols positions (checked
    arguments): two [rows, cols] tensors, position i at word i."""
    dev, field = eq_r.device, eq_r.field
    size = rows * cols
    if (plan.starts.shape != (size + 1,) or plan.order.shape != plan.packed.shape
            or plan.order.shape[0] > eq_r.shape[0]):
        raise ValueError(f"phase_tables: the plan does not fit {size} positions of {eq_r.shape[0]} gates")
    out1 = torch.empty((rows, cols), dtype=word_dtype(field), device=dev)
    out2 = torch.empty_like(out1)
    with torch.cuda.device(dev):
        rc = _kernel()(
            *_field_args(field), phase, plan.order.data_ptr(), plan.starts.data_ptr(), plan.packed.data_ptr(),
            eq_r.data.data_ptr(), table.data.data_ptr(), out1.data_ptr(), out2.data_ptr(), size,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"phase-table kernel launch failed: CUDA error {rc}")
    return out1, out2


def phase_tables_plain(phase, key, gather_idx, is_mul, eq_r: FArray, table: FArray, k: int):
    """K2's function in plain torch ops (any device): the per-gate values
    by FArray arithmetic, an exact integer scatter-add by the key, the bit
    reversal to MSB-first order."""
    prod = eq_r * gather(table, gather_idx)
    zero = torch.zeros_like(prod.data)
    if phase == 1:
        x1 = torch.where(is_mul, prod.data, eq_r.data)
        x2 = torch.where(is_mul, zero, prod.data)
    else:
        x1 = torch.where(is_mul, zero, prod.data)
        x2 = torch.where(is_mul, prod.data, zero)
    size = 1 << k
    field: FieldConfig = eq_r.field
    return tuple(lsb_to_msb(_scatter_add_mod(key, FArray(x, field), size), k) for x in (x1, x2))


def phase_tables_rows_plain(phase, key, gather_idx, is_mul, eq_r: FArray, table: FArray, k: int, n_shard: int,
                            row0: int, rows: int):
    """:func:`phase_tables_rows` in plain torch ops (any device): the
    whole tables of :func:`phase_tables_plain`, then the shard rows' strided
    positions (``parallel.sharded.shard_factor``'s [L, S] -> [S, L])."""
    field = eq_r.field
    cols = 1 << (k - n_shard)
    return tuple(FArray(t.data.reshape(cols, 1 << n_shard)[:, row0 : row0 + rows].T.contiguous(), field)
                 for t in phase_tables_plain(phase, key, gather_idx, is_mul, eq_r, table, k))


def phase1_tables(r_i: FArray, w_lsb: FArray, wiring, k_cur: int, k: int):
    """LibraW phase-1 build: (r_i [k_cur], W in label order [2^k], the
    layer's ``circuit.LayerWiring``) -> (a1, a2 in MSB-first order,
    eq_r [2^k_cur])."""
    eq_r = eq_table_dev(r_i, k_cur)
    a1, a2 = phase_tables(1, wiring, eq_r, w_lsb, k)
    return a1, a2, eq_r


def phase2_tables(u: FArray, w_lsb: FArray, eq_r: FArray, wiring, k: int):
    """LibraW phase-2 build: (u [k], W in label order, eq_r, wiring) ->
    (b1, b2 in MSB-first order, w_u = W~(u) as a (1,) FArray); the eq table
    of u and W~(u) come out of one pass (:func:`eq_table_dot`)."""
    eq_u, w_u = eq_table_dot(u, w_lsb, k)
    b1, b2 = phase_tables(2, wiring, eq_r, eq_u, k)
    return b1, b2, w_u
