// The dense MLE's device programs, over Goldilocks or a mont32 field
// (p < 2^31): the bit reversal, the fold of a table's first k variables at
// one point (the fold chain), and the evaluation at P points in two forms
// (a big table, or a tiny one at many points).
//
// Replaces: thaler_study_tpu/mle/dense.py _device_bitrev (:44), _fold_impl
// (:176) and _eval_many_impl (:185), jnp programs that XLA compiles for the
// TPU. Their plain versions are ops/mle_kernel.bitrev_plain, fold_plain and
// eval_many_plain (the fold chain, one FArray.fold per variable).
//
// BIT REVERSAL. out[i] = in[brev_n(i)], the index computed here, no index
// table. What bounds it: every word read once and written once (2^26
// Goldilocks words, 1.07 GB at the matmul entry: 0.32 ms at 3.35 TB/s). A
// word-by-word gather reads one 32-byte sector per word; so the kernel
// moves 32 x 32 tiles: i = (a, m, b) with a and b five bits each, and
// brev(i) = (brev5(b), brev(m), brev5(a)), so for one middle m the tile's
// 32 source rows brev5(b) are each 32 contiguous words, and its 32 output
// rows a too. A block reads the rows in source order into shared memory
// (an odd pitch) and writes the output rows, whole sectors both ways.
// Tables below 2^10 words take one thread per word.
//
// FOLD. out[j] = sum_{x < 2^k} eq(r, x) t[x 2^(n-k) + j] for the table t
// of 2^n words (internal MSB-first order: variable i is bit k - 1 - i of
// the row x), one point r of k coordinates, j < M = 2^(n-k): the value of
// k fold steps lo + r (hi - lo), in one pass over the table. Field sums do
// not depend on their order, so the result is the fold chain's, word for
// word. The table is read as [2^k rows][M columns]. A block takes a tile of
// CT = min(M, 256) columns, 256 / CT lanes over the rows and one chunk of
// 2^(k-s) rows (grid y: the S = 2^s chunks). eq(r, x) splits over x's bits:
// the chunk's top s bits (one factor per block), mb middle bits (a table of
// 2^mb words in shared memory) and the lane's low c bits (one factor per
// thread). So every table word is loaded once and costs one unreduced
// product, summed without reduction (192-bit sums of 128-bit products for
// Goldilocks, 128-bit sums of raw Montgomery products for mont32); each
// thread reduces once, the lanes sum in shared memory, and with S > 1 the
// last block of a tile (a ticket) sums the chunks' partials. The wrapper's
// plan (ops/mle_kernel.plan) picks s for about 512 blocks. What bounds it:
// the bytes of the table read once (the matmul entry's fold of 13 of 26
// variables: 512 MB, 0.16 ms).
//
// EVALUATION, BIG TABLE (2^n > 2^TINY_LOG words: GKR's restriction, 21
// points over 2^20 words). out[p] = sum_x eq(r_p, x) t[x]. What bounds it:
// the products, P 2^n unreduced ones (22 million at the restriction:
// 0.0105 ms for Goldilocks at 8 IMAD each, 0.0026 ms mont32 at 2), not the
// bytes (8 MB). So the design spends nothing per word but the product: a
// block takes a chunk y of 2^m rows (grid x: S = 2^s chunks) and a group of
// PB <= 8 points (grid y; the wrapper pads P to whole groups, so PB is a
// template parameter and no product is conditional: 21 points are three
// groups of 7), and the table is read from L2 once per group. A row is x =
// (y, h, lane, v): each thread loads 16 bytes per h (V = 2 Goldilocks or 4
// mont32 words v), and each word costs one unreduced product per point,
// accumulated by carry chains in PTX (8 IMAD and 3 IADD per Goldilocks
// product into 256 bits of limbs, 2 IMAD and 1 IADD mont32), with its
// factor over the (h, v) bits from a per-point table in shared memory (16
// bytes per load, the same address for every lane). After its rows, a
// thread reduces once per point and multiplies by its lane factor over the
// c <= 8 lane bits, the product of two 16-word per-point tables. The block
// stages the group's coordinates into shared memory and builds every table
// and the chunk's factor from them once. The 256 lanes meet by
// __shfl_xor_sync within each warp, then through shared memory across the
// 8 warps, one barrier for the group's points; the block's sum times the
// chunk's factor is its partial, and the group's last block (a ticket)
// sums the S partials of each point, one warp per point. One launch per
// evaluate_many; the plan (ops/mle_kernel.eval_plan) picks s for about 256
// blocks, 32 rows per thread at the restriction: the per-block work (the
// tables, one reduction, two products and five shuffles per point and
// thread) is what more chunks would add.
//
// EVALUATION, TINY TABLE (2^n <= 2^TINY_LOG words: the PCS's 151,321 points
// over 2 variables). What bounds it: the bytes, the points read once and
// the values written once (1.8 MB for the PCS, 0.54 us at 3.35 TB/s, under
// a launch's ~1.2 us), not the 2^n - 1 folds per point. So one thread per
// point: a block stages 256 points' coordinates into shared memory by
// coalesced loads, each thread runs the fold chain over the table in
// registers (the table read once per block) and the values are stored
// coalesced. No block-wide sum.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 32;         // bit reversal: a tile of TILE x TILE words
constexpr int TILE_LOG = 5;
constexpr int MID_WORDS = 2048;  // fold: the middle eq tables' words (ops/mle_kernel.MID_WORDS)
constexpr int WARPS = THREADS / 32;
constexpr int TINY_LOG = 5;      // evaluation: tables of at most 2^TINY_LOG words take the tiny form
constexpr int EVAL_MID_LOG = 7;  // evaluation: the (h, v) factors' words per point (ops/mle_kernel.EVAL_MID_LOG)
constexpr int LANE_LOG = 8;      // evaluation: the lane bits of a row (THREADS = 2^LANE_LOG)
constexpr int EVAL_POINTS = 8;   // evaluation: the most points per block (ops/mle_kernel.EVAL_POINTS)

struct GlOps {
  using word = uint64_t;
  using Acc = gl::Acc;
  __device__ __forceinline__ word one() const { return 1; }
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
  __device__ __forceinline__ word sub(word a, word b) const { return gl::sub(a, b); }
  __device__ __forceinline__ word mul(word a, word b) const { return gl::mul(a, b); }
  __device__ __forceinline__ word fold(word lo, word hi, word r) const { return gl::fold(lo, hi, r); }
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const {
    gl::acc_add(acc, a * b, __umul64hi(a, b));
  }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return gl::acc_reduce(acc); }
  // the evaluation's accumulator: x y = x0 y0 + (x0 y1 + x1 y0) 2^32 + x1 y1
  // 2^64 in 32-bit limbs, the outer products into r[0..4] (160 bits) and
  // the cross products into r[5..7] (96 bits at 2^32), one carry chain
  // each: 8 IMAD and 3 IADD per product, no compare
  struct EvalAcc {
    uint32_t r[8];
  };
  __device__ __forceinline__ void mac(EvalAcc& a, word x, word y) const {
    const uint32_t x0 = (uint32_t)x, x1 = (uint32_t)(x >> 32), y0 = (uint32_t)y, y1 = (uint32_t)(y >> 32);
    asm("mad.lo.cc.u32 %0, %8, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "mad.lo.cc.u32 %5, %8, %11, %5;\n\t"
        "madc.hi.cc.u32 %6, %8, %11, %6;\n\t"
        "addc.u32 %7, %7, 0;\n\t"
        "mad.lo.cc.u32 %5, %9, %10, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %10, %6;\n\t"
        "addc.u32 %7, %7, 0;"
        : "+r"(a.r[0]), "+r"(a.r[1]), "+r"(a.r[2]), "+r"(a.r[3]), "+r"(a.r[4]), "+r"(a.r[5]), "+r"(a.r[6]),
          "+r"(a.r[7])
        : "r"(x0), "r"(x1), "r"(y0), "r"(y1));
  }
  __device__ __forceinline__ word mac_reduce(const EvalAcc& a) const {
    uint32_t t1, t2, t3, t4;
    asm("add.cc.u32 %0, %4, %7;\n\t"
        "addc.cc.u32 %1, %5, %8;\n\t"
        "addc.cc.u32 %2, %6, %9;\n\t"
        "addc.u32 %3, %10, 0;"
        : "=r"(t1), "=r"(t2), "=r"(t3), "=r"(t4)
        : "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(a.r[5]), "r"(a.r[6]), "r"(a.r[7]), "r"(a.r[4]));
    return gl::acc_reduce({((uint64_t)t1 << 32) | a.r[0], ((uint64_t)t3 << 32) | t2, t4});
  }
};

struct M32Ops : m32::Field {
  using word = uint32_t;
  using Acc = m32::Acc;

  __device__ __forceinline__ word one() const { return r1; }
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const { m32::acc_add(acc, (uint64_t)a * b); }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return m32::acc_reduce(*this, acc); }
  // the evaluation's accumulator: raw 64-bit products summed in three 32-bit
  // limbs by one carry chain, 2 IMAD and 1 IADD per product
  struct EvalAcc {
    uint32_t r[3];
  };
  __device__ __forceinline__ void mac(EvalAcc& a, word x, word y) const {
    asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+r"(a.r[0]), "+r"(a.r[1]), "+r"(a.r[2])
        : "r"(x), "r"(y));
  }
  __device__ __forceinline__ word mac_reduce(const EvalAcc& a) const {
    return m32::acc_reduce(*this, {((uint64_t)a.r[1] << 32) | a.r[0], a.r[2]});
  }
};

template <class W>
__global__ void __launch_bounds__(THREADS) bitrev_kernel(const W* __restrict__ in, W* __restrict__ out, int n) {
  if (n < 2 * TILE_LOG) {
    const int size = 1 << n;
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < size; i += gridDim.x * THREADS)
      out[i] = in[n ? __brev((unsigned)i) >> (32 - n) : 0];
    return;
  }
  __shared__ W tile[TILE][TILE + 1];
  const int tx = threadIdx.x & (TILE - 1), ty = threadIdx.x / TILE;
  const int mbits = n - 2 * TILE_LOG, hi = n - TILE_LOG;
  const long long m = blockIdx.x;
  const long long mrev = mbits ? __brev((unsigned)m) >> (32 - mbits) : 0;
  // source row q = brev5(b): 32 contiguous words (q, brev(m), brev5(a) = tx)
  for (int q = ty; q < TILE; q += THREADS / TILE)
    tile[q][tx] = in[((long long)q << hi) | (mrev << TILE_LOG) | tx];
  __syncthreads();
  // output row a: out[(a, m, b = tx)] = in[(brev5(b), brev(m), brev5(a))]
  const int btx = __brev((unsigned)tx) >> (32 - TILE_LOG);
  for (int a = ty; a < TILE; a += THREADS / TILE)
    out[((long long)a << hi) | (m << TILE_LOG) | tx] = tile[btx][__brev((unsigned)a) >> (32 - TILE_LOG)];
}

// the factor of eq(r, x) over `bits` bits of x: bit b of v is coordinate
// r[top - b]
template <class F>
__device__ __forceinline__ typename F::word eq_factor(const F& f, const typename F::word* r, int top, int bits,
                                                      long long v) {
  using W = typename F::word;
  const W one = f.one();
  W e = one;
  for (int b = 0; b < bits; ++b) {
    const W x = r[top - b];
    e = f.mul(e, ((v >> b) & 1) ? x : f.sub(one, x));
  }
  return e;
}

// a word another block wrote in this launch, read past L1
__device__ __forceinline__ uint64_t ldcg(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}
__device__ __forceinline__ uint32_t ldcg(const uint32_t* p) { return __ldcg(reinterpret_cast<const unsigned int*>(p)); }

// sum over the lanes of red[lane * CT + col] into red[col] (lanes a power
// of two); every thread of the block calls it
template <class F>
__device__ __forceinline__ void lane_sum(const F& f, typename F::word* red, int lanes, int ct_log) {
  const int lane = threadIdx.x >> ct_log;
  for (int w = lanes >> 1; w > 0; w >>= 1) {
    if (lane < w) red[threadIdx.x] = f.add(red[threadIdx.x], red[threadIdx.x + (w << ct_log)]);
    __syncthreads();
  }
}

template <class F>
__global__ void __launch_bounds__(THREADS)
    fold_kernel(F f, const typename F::word* __restrict__ t, const typename F::word* __restrict__ r, int k, int n,
                int ct_log, int s, int c, int mb, typename F::word* __restrict__ out,
                typename F::word* __restrict__ partial, int* __restrict__ tickets) {
  using W = typename F::word;
  __shared__ W mid[MID_WORDS];
  __shared__ W red[THREADS];
  __shared__ int last;
  const long long M = 1ll << (n - k);
  const int lanes = THREADS >> ct_log, col = threadIdx.x & ((1 << ct_log) - 1), lane = threadIdx.x >> ct_log;
  const long long j = ((long long)blockIdx.x << ct_log) + col;
  const long long S = 1ll << s, y = blockIdx.y;
  const bool active = lane < (1 << c);
  const W* src = t + (((y << (k - s)) + lane) * M) + j;  // row y 2^(k-s) + lane, column j
  // the middle factors: mid[h], bit b of h is coordinate s + mb - 1 - b
  for (int h = threadIdx.x; h < (1 << mb); h += THREADS) mid[h] = eq_factor(f, r, s + mb - 1, mb, h);
  __syncthreads();
  typename F::Acc acc = {};
  if (active) {
    // 32 bytes of the thread's loads in flight: 4 Goldilocks or 8 mont32
    // words (4 mont32 words, or 8 Goldilocks, were slower at the matmul
    // entry's fold)
#pragma unroll (32 / sizeof(W))
    for (int h = 0; h < (1 << mb); ++h) f.acc_add(acc, mid[h], src[((long long)h << c) * M]);
  }
  // the lane's low c bits: bit b is coordinate k - 1 - b
  red[threadIdx.x] = active ? f.mul(f.acc_reduce(acc), eq_factor(f, r, k - 1, c, lane)) : W(0);
  __syncthreads();
  lane_sum(f, red, lanes, ct_log);
  if (threadIdx.x < (1 << ct_log)) {
    // the chunk's top s bits: bit b of y is coordinate s - 1 - b
    const W v = f.mul(red[threadIdx.x], eq_factor(f, r, s - 1, s, y));
    if (s == 0) out[j] = v;
    else partial[y * M + j] = v;
  }
  if (s > 0) {
    __threadfence();
    __syncthreads();
    int* ticket = tickets + blockIdx.x;
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == (int)(S - 1);
    __syncthreads();
    if (last) {
      __threadfence();
      W v = 0;
      for (long long yy = lane; yy < S; yy += lanes) v = f.add(v, ldcg(partial + yy * M + j));
      red[threadIdx.x] = v;
      __syncthreads();
      lane_sum(f, red, lanes, ct_log);
      if (threadIdx.x < (1 << ct_log)) out[j] = red[threadIdx.x];
      if (threadIdx.x == 0) *ticket = 0;
    }
  }
}

template <class F>
int fold_launch(F f, const void* t, const void* r, int k, int n, int ct_log, int s, int c, int mb, void* out,
                void* partial, void* tickets, cudaStream_t st) {
  using W = typename F::word;
  const dim3 grid((unsigned)(1ll << (n - k - ct_log)), (unsigned)(1u << s));
  fold_kernel<F><<<grid, THREADS, 0, st>>>(f, static_cast<const W*>(t), static_cast<const W*>(r), k, n, ct_log, s, c,
                                           mb, static_cast<W*>(out), static_cast<W*>(partial),
                                           static_cast<int*>(tickets));
  return (int)cudaGetLastError();
}

// 16 bytes of table words as V = 2 (Goldilocks) or 4 (mont32) words
__device__ __forceinline__ void unpack16(const uint4& u, uint64_t (&w)[2]) {
  w[0] = ((uint64_t)u.y << 32) | u.x;
  w[1] = ((uint64_t)u.w << 32) | u.z;
}
__device__ __forceinline__ void unpack16(const uint4& u, uint32_t (&w)[4]) {
  w[0] = u.x;
  w[1] = u.y;
  w[2] = u.z;
  w[3] = u.w;
}

__device__ __forceinline__ uint64_t shfl_xor(uint64_t v, int m) {
  return __shfl_xor_sync(0xffffffffu, (unsigned long long)v, m);
}
__device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int m) { return __shfl_xor_sync(0xffffffffu, v, m); }

template <class F>
__device__ __forceinline__ typename F::word warp_sum(const F& f, typename F::word v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = f.add(v, shfl_xor(v, o));
  return v;
}

// The evaluation over a big table (see the note): grid x = the S = 2^s
// chunks of 2^m = 2^(n-s) rows, grid y = the point groups (`groups` of PB
// points: the wrapper pads P to groups x PB). A row is x = (y, h, lane, v):
// v < V the word in a thread's 16 bytes, lane < 2^c (threads at and above
// 2^c idle), h < 2^hb with hb = m - log2(V) - c. Bit b of x is coordinate
// n - 1 - b of a point.
template <class F, int PB>
__global__ void __launch_bounds__(THREADS, 2)
    eval_kernel(F f, const typename F::word* __restrict__ t, const typename F::word* __restrict__ rs, long long groups,
                int n, int s, int c, typename F::word* __restrict__ out, typename F::word* __restrict__ partial,
                int* __restrict__ tickets) {
  using W = typename F::word;
  constexpr int V = 16 / sizeof(W), LV = V == 2 ? 1 : 2;
  __shared__ __align__(16) W mid[PB][1 << EVAL_MID_LOG];  // the (h, v) factors: mid[q][(h << LV) | v]
  __shared__ W half[PB][32];  // the lane factors' halves: [0, 16) the low cl bits, [16, 32) the high ch bits
  __shared__ W pts[PB * 32];  // the group's coordinates
  __shared__ W chunk[PB];     // the chunk's factors
  __shared__ W red[PB][WARPS];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int m = n - s, hb = m - LV - c, cl = c < 4 ? c : 4, ch = c - cl, mid_log = hb + LV;
  const long long S = 1ll << s, y = blockIdx.x;
  const bool active = tid < (1 << c);
  const W* src = t + (y << m) + ((long long)tid << LV);
  for (long long g = blockIdx.y; g < groups; g += gridDim.y) {
    const long long p0 = g * PB;
    // the group's coordinates (coalesced), then its tables, built once per
    // block from shared memory
    for (int e = tid; e < PB * n; e += THREADS) pts[e] = rs[p0 * n + e];
    __syncthreads();
    for (int e = tid; e < PB * 32; e += THREADS) {
      const int q = e >> 5, i = e & 31;
      const W* r = pts + q * n;
      half[q][i] = i < 16 ? eq_factor(f, r, n - 1 - LV, cl, i) : eq_factor(f, r, n - 1 - LV - cl, ch, i - 16);
    }
    for (int e = tid; e < (PB << mid_log); e += THREADS) {
      const int q = e >> mid_log, i = e & ((1 << mid_log) - 1);
      const W* r = pts + q * n;
      mid[q][i] = f.mul(eq_factor(f, r, n - 1, LV, i & (V - 1)), eq_factor(f, r, n - 1 - LV - c, hb, i >> LV));
    }
    // the chunk's top s bits: bit b of y is coordinate s - 1 - b
    if (tid < PB) chunk[tid] = eq_factor(f, pts + tid * n, s - 1, s, y);
    __syncthreads();
    typename F::EvalAcc acc[PB];
#pragma unroll
    for (int q = 0; q < PB; ++q) acc[q] = {};
    if (active) {
#pragma unroll 4
      for (int h = 0; h < (1 << hb); ++h) {
        W x[V];
        unpack16(__ldg(reinterpret_cast<const uint4*>(src + ((long long)h << (c + LV)))), x);
#pragma unroll
        for (int q = 0; q < PB; ++q) {
          W e[V];
          unpack16(*reinterpret_cast<const uint4*>(&mid[q][h << LV]), e);
#pragma unroll
          for (int v = 0; v < V; ++v) f.mac(acc[q], e[v], x[v]);
        }
      }
    }
    // once per point: reduce, the lane factor, the warp's sum
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      W v = active ? f.mul(f.mac_reduce(acc[q]), f.mul(half[q][tid & 15], half[q][16 + (tid >> 4)])) : W(0);
      v = warp_sum(f, v);
      if (wl == 0) red[q][warp] = v;
    }
    __syncthreads();
    if (tid < PB) {
      W v = red[tid][0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v = f.add(v, red[tid][w]);
      v = f.mul(v, chunk[tid]);
      if (s == 0) out[p0 + tid] = v;
      else partial[(p0 + tid) * S + y] = v;
    }
    if (s > 0) {
      __threadfence();
      __syncthreads();
      if (tid == 0) last = atomicAdd(tickets + g, 1) == (int)(S - 1);
      __syncthreads();
      if (last) {
        __threadfence();
        for (int q = warp; q < PB; q += WARPS) {
          W v = 0;
          for (long long yy = wl; yy < S; yy += 32) v = f.add(v, ldcg(partial + (p0 + q) * S + yy));
          v = warp_sum(f, v);
          if (wl == 0) out[p0 + q] = v;
        }
        if (tid == 0) tickets[g] = 0;
      }
    }
    __syncthreads();
  }
}

// The evaluation over a tiny table of 2^N words (see the note): one thread
// per point, the table in registers, the coordinates staged through shared
// memory.
template <class F, int N>
__global__ void __launch_bounds__(THREADS)
    eval_tiny_kernel(F f, const typename F::word* __restrict__ t, const typename F::word* __restrict__ rs,
                     long long points, typename F::word* __restrict__ out) {
  using W = typename F::word;
  __shared__ W tab[1 << N];
  __shared__ W pts[THREADS * N];
  if (threadIdx.x < (1 << N)) tab[threadIdx.x] = t[threadIdx.x];
  for (long long p0 = (long long)blockIdx.x * THREADS; p0 < points; p0 += (long long)gridDim.x * THREADS) {
    const int cnt = points - p0 < THREADS ? (int)(points - p0) : THREADS;
    __syncthreads();
    for (int e = threadIdx.x; e < cnt * N; e += THREADS) pts[e] = rs[p0 * N + e];
    __syncthreads();
    if (threadIdx.x < cnt) {
      W v[1 << N];
#pragma unroll
      for (int j = 0; j < (1 << N); ++j) v[j] = tab[j];
      // variable i (bit N - 1 - i of x) folds the current table's halves
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const W r = pts[threadIdx.x * N + i];
#pragma unroll
        for (int j = 0; j < (1 << (N - 1 - i)); ++j) v[j] = f.fold(v[j], v[j + (1 << (N - 1 - i))], r);
      }
      out[p0 + threadIdx.x] = v[0];
    }
  }
}

template <class F, int PB>
void eval_big(F f, dim3 grid, cudaStream_t st, const typename F::word* t, const typename F::word* rs, long long groups,
              int n, int s, int c, typename F::word* out, void* partial, void* tickets) {
  eval_kernel<F, PB><<<grid, THREADS, 0, st>>>(f, t, rs, groups, n, s, c, out,
                                               static_cast<typename F::word*>(partial), static_cast<int*>(tickets));
}

template <class F>
int eval_launch(F f, const void* t, const void* rs, long long points, int n, long long groups, int pb, int s, int c,
                void* out, void* partial, void* tickets, cudaStream_t st) {
  using W = typename F::word;
  const W* tw = static_cast<const W*>(t);
  const W* rw = static_cast<const W*>(rs);
  W* o = static_cast<W*>(out);
  if (n <= TINY_LOG) {
    const long long need = (points + THREADS - 1) / THREADS;
    const unsigned blocks = (unsigned)(need < 65535 ? need : 65535);
    switch (n) {
      case 1: eval_tiny_kernel<F, 1><<<blocks, THREADS, 0, st>>>(f, tw, rw, points, o); break;
      case 2: eval_tiny_kernel<F, 2><<<blocks, THREADS, 0, st>>>(f, tw, rw, points, o); break;
      case 3: eval_tiny_kernel<F, 3><<<blocks, THREADS, 0, st>>>(f, tw, rw, points, o); break;
      case 4: eval_tiny_kernel<F, 4><<<blocks, THREADS, 0, st>>>(f, tw, rw, points, o); break;
      default: eval_tiny_kernel<F, 5><<<blocks, THREADS, 0, st>>>(f, tw, rw, points, o); break;
    }
  } else {
    const dim3 grid((unsigned)(1u << s), (unsigned)(groups < 65535 ? groups : 65535));
    switch (pb) {
      case 1: eval_big<F, 1>(f, grid, st, tw, rw, groups, n, s, c, o, partial, tickets); break;
      case 2: eval_big<F, 2>(f, grid, st, tw, rw, groups, n, s, c, o, partial, tickets); break;
      case 3: eval_big<F, 3>(f, grid, st, tw, rw, groups, n, s, c, o, partial, tickets); break;
      case 4: eval_big<F, 4>(f, grid, st, tw, rw, groups, n, s, c, o, partial, tickets); break;
      case 5: eval_big<F, 5>(f, grid, st, tw, rw, groups, n, s, c, o, partial, tickets); break;
      case 6: eval_big<F, 6>(f, grid, st, tw, rw, groups, n, s, c, o, partial, tickets); break;
      case 7: eval_big<F, 7>(f, grid, st, tw, rw, groups, n, s, c, o, partial, tickets); break;
      default: eval_big<F, 8>(f, grid, st, tw, rw, groups, n, s, c, o, partial, tickets); break;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point returns cudaGetLastError() after the launch (0 =
// launched); the wrapper (ops/mle_kernel.py) checks every argument first.

// in, out: 2^n words of word_bytes (8 or 4) bytes, n <= 31.
extern "C" int ts_bitrev_launch(int word_bytes, const void* in, void* out, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > 31 || (word_bytes != 8 && word_bytes != 4)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = n < 2 * TILE_LOG ? (unsigned)(((1 << n) + THREADS - 1) / THREADS) : 1u << (n - 2 * TILE_LOG);
  if (word_bytes == 8)
    bitrev_kernel<uint64_t><<<blocks, THREADS, 0, s>>>(static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n);
  else
    bitrev_kernel<uint32_t><<<blocks, THREADS, 0, s>>>(static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

// The fold of t's first k variables (t: 2^n words) at one point (r: k
// words), out: 2^(n-k) words; the plan ct_log, s, c, mb as
// ops/mle_kernel.plan makes it. With s > 0, partial holds 2^s x 2^(n-k)
// words and tickets one int per tile, all 0 (and 0 again after the
// kernel). mont32 = 0 takes Goldilocks words; mont32 = 1 Montgomery words
// of the field with modulus p < 2^31 and pinv = -p^-1 mod 2^32.
extern "C" int ts_fold_launch(int mont32, unsigned p, unsigned pinv, const void* t, const void* r, int k, int n,
                              int ct_log, int s, int c, int mb, void* out, void* partial, void* tickets,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > n || ct_log < 0 || ct_log > 8 || ct_log > n - k || s < 0 || s > 15 || c < 0 || c > 8 - ct_log ||
      mb < 0 || (1 << mb) > MID_WORDS || s + c + mb != k)
    return (int)cudaErrorInvalidValue;
  if (mont32) return fold_launch(M32Ops{{p, pinv}}, t, r, k, n, ct_log, s, c, mb, out, partial, tickets, st);
  return fold_launch(GlOps{}, t, r, k, n, ct_log, s, c, mb, out, partial, tickets, st);
}

// The evaluation of t (2^n words, 16-byte aligned) at `points` points (rs:
// points x n words), out: `points` words. n <= TINY_LOG takes the tiny
// form (groups, pb, s, c unused); else the big form over the plan groups,
// pb, s, c as ops/mle_kernel.eval_plan makes it, points = groups x pb (the
// wrapper pads): with s > 0, partial holds points x 2^s words and tickets
// one int per group, all 0 (and 0 again after the kernel). mont32 as for
// ts_fold_launch.
extern "C" int ts_eval_launch(int mont32, unsigned p, unsigned pinv, const void* t, const void* rs, long long points,
                              int n, long long groups, int pb, int s, int c, void* out, void* partial, void* tickets,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lv = mont32 ? 2 : 1;
  if (points < 1 || n < 1 || n > 31) return (int)cudaErrorInvalidValue;
  if (n > TINY_LOG && (groups < 1 || pb < 1 || pb > EVAL_POINTS || groups * pb != points || s < 0 || s > 30 ||
                       c < 0 || c > LANE_LOG || n - s - lv - c < 0 || n - s - c > EVAL_MID_LOG))
    return (int)cudaErrorInvalidValue;
  if (mont32)
    return eval_launch(M32Ops{{p, pinv}}, t, rs, points, n, groups, pb, s, c, out, partial, tickets, st);
  return eval_launch(GlOps{}, t, rs, points, n, groups, pb, s, c, out, partial, tickets, st);
}
