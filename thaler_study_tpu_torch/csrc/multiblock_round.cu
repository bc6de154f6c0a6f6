// Multi-block sumcheck round (fold + round sums) of one proof, and the
// flat fold, over Goldilocks or a mont32 field (p < 2^31).
//
// Replaces: the XLA programs of thaler_study_tpu/ops/round_kernel.py that
// run every spec the Pallas kernel does not take (pallas_round.supports
// :397): _fold_tables :110, _round_sums :218 with the broadcast branch of
// _term_total :165, and sum_products :407 (c_1 is s(0) + s(1) of a round
// without fold). The specs: up to three variable blocks, up to MAX_TABLES
// factor tables each over a subset of the blocks (0-block scalars too), up
// to MAX_TERMS terms, degree up to MAX_D: the triangle IP's Y and Z phases
// and small X phases, GKR's dense W in both phases, every c_1, and the
// single-block products the round kernel (round_kernel.cu) does not take
// (k = 1, k >= 4, scalars other than the LibraW shapes). Its plain version
// is ops/multiblock.round_sums_plain / fold_tables_plain; the plan and the
// tile layout below come from ops/multiblock.round_plan / layout.
//
// What it computes. The grid is the spec's block grid after the fold, block
// 0 halved: g = (i0, i1, i2), MSB-first. At g a table reads lo = T[idx(g)]
// and, where it covers block 0, hi = T[idx + half0 * stride0] (else hi =
// lo); v(t) = lo + t (hi - lo). With a fold, a table the round folds is
// the previous spec's table folded at r on the fly, T'[j] = fold(T[j],
// T[j + h], r), and T' is written out entry by entry, each entry once. The
// sums: s(t) = sum over g of sum over terms of prod v_k(t)^count, t =
// 0..D; SKIP1 leaves the t = 1 products out and writes s(1) = claim - s(0)
// (or 0 without a claim: the caller fills it). Summing a term over grid
// blocks it misses multiplies it by 2^(their variables), the JAX program's
// 2^missing factor (_round_sums :277-280): the same field value.
//
// How. The grid is read as rows (every grid block but the last non-empty
// one) times the last block, the inner one, and cut into tiles of rows x a
// span of the inner block; the blocks (as many as fit on the card, two per
// SM under a 128-register cap) each walk a contiguous range of tiles.
// Neighbouring threads take neighbouring inner points, two at a time
// (16-byte Goldilocks, 8-byte mont32 words pairs, where the tables are
// aligned). The tables are split, per round, into
//   - row tables (they miss the inner block): read and folded once per
//     tile row into shared memory; each term's row factors are multiplied
//     there once per row and t (the row products);
//   - inner tables: read per point. The folded ones that miss a row
//     coordinate (f3(X, Z) of a triangle X round, f3(Z) at X -> Y) are
//     folded once per span into shared memory (again only where a tile's
//     span or row coordinate a changes); the ones streamed once (they miss
//     no row coordinate) reach each thread through a two-stage cp.async
//     pipeline in shared memory, so that the next step's words are in
//     flight without registers; the rest are loaded at their point.
// A term's inner product is summed along a row into lazy accumulators
// (carry-chain adds), reduced once at the row's end and multiplied by the
// row product: sum_z f1(y) f2(y, z) f3(z) = f1(y) sum_z f2(y, z) f3(z),
// with f1's fold and product once per row instead of at every point. Where
// at most one of its inner factors varies with t the product is linear in
// t, and the row keeps its value at t = 0 and its slope (two products per
// point, no per-t adds; s(t) = A + tB at the row's end); else its values
// at t = 0..D. Every folded entry is written by one owner: the tile, row
// and point whose coordinates in the row blocks the table misses are 0
// (and, for a row table, the tile's first span). Index arithmetic is
// 32-bit (the wrapper holds every table below 2^31 entries).
//
// The sums are finished in the kernel: each block writes its s(t)
// partials, takes a ticket, and the last block sums every block's partials
// (read from L2) and writes s(0..D) and s(1) (K1's TAIL epilogue pattern,
// round_kernel.cu); it resets the ticket counter to 0, so a round is one
// launch. The counter is one int per device: launches run one at a time on
// the caller's stream. With `scaled` the sums are written times the word
// `scale`: the sharded rounds' terms over replicated tables only, summed
// once for all 2^n_shard shard rows (parallel/sharded.py; JAX _mb_sums
// :548), and `sums` may point into a row of the round's rows buffer.
//
// What bounds it on the H100: device memory where a table is streamed (a
// 2^24-entry triangle table read once in the first Y round), else the
// 64-bit products and the latency of small grids. The descriptor (Args) is
// a run-time argument, so one build serves every spec; the point loop is
// templated on the terms, the degree and the inner tables (NT, D, NI) for
// the shapes the paths run (the triangle, dense W, the LibraW and matmul
// c_1), with every accumulator in registers; NT = 0 is the generic
// instantiation (any spec within the maxima, accumulators in local memory,
// no pipeline).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TABLES = 8;
constexpr int MAX_TERMS = 8;
constexpr int MAX_D = 8;
// blocks per SM the templated instantiations are held to (at most 128
// registers a thread): more warps to hide the loads' latency
constexpr int MIN_BLOCKS = 2;

struct GlOps {
  using word = uint64_t;
  using word2 = ulonglong2;
  using Acc = gl::Acc;
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
  __device__ __forceinline__ word sub(word a, word b) const { return gl::sub(a, b); }
  __device__ __forceinline__ word mul(word a, word b) const { return gl::mul(a, b); }
  __device__ __forceinline__ word fold(word lo, word hi, word r) const { return gl::fold(lo, hi, r); }
  __device__ __forceinline__ word one() const { return 1; }
  __device__ __forceinline__ word small(int t) const { return (word)t; }
  // acc += a b (128-bit, unreduced); acc_add1: acc += a. One carry chain
  // (gl::acc_add's sum, with the carries in the adds' flags).
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const {
    asm("add.cc.u64 %0, %0, %3;\n\taddc.cc.u64 %1, %1, %4;\n\taddc.u64 %2, %2, 0;"
        : "+l"(acc.lo), "+l"(acc.hi), "+l"(acc.top)
        : "l"(a * b), "l"(__umul64hi(a, b)));
  }
  __device__ __forceinline__ void acc_add1(Acc& acc, word a) const {
    asm("add.cc.u64 %0, %0, %3;\n\taddc.cc.u64 %1, %1, 0;\n\taddc.u64 %2, %2, 0;"
        : "+l"(acc.lo), "+l"(acc.hi), "+l"(acc.top)
        : "l"(a));
  }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return gl::acc_reduce(acc); }
};

// mont32 words are Montgomery words x R mod p (R = 2^32). The accumulator
// sums raw products x y R^2; acc_add1 enters a word as its product with
// R mod p (m32::Field's r1), so that every entry has that form.
struct M32Ops : m32::Field {
  using word = uint32_t;
  using word2 = uint2;
  using Acc = m32::Acc;
  __device__ __forceinline__ word one() const { return r1; }
  __device__ __forceinline__ word small(int t) const { return redc((uint64_t)t * r2); }
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const { acc_raw(acc, (uint64_t)a * b); }
  __device__ __forceinline__ void acc_add1(Acc& acc, word a) const { acc_raw(acc, (uint64_t)a * r1); }
  // m32::acc_add as one carry chain
  __device__ __forceinline__ void acc_raw(Acc& acc, uint64_t t) const {
    asm("add.cc.u64 %0, %0, %2;\n\taddc.u64 %1, %1, 0;" : "+l"(acc.lo), "+l"(acc.hi) : "l"(t));
  }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return m32::acc_reduce(*this, acc); }
};

__device__ __forceinline__ uint32_t shfl_down(uint32_t x, int off) {
  return __shfl_down_sync(0xffffffffu, x, off);
}
__device__ __forceinline__ uint64_t shfl_down(uint64_t x, int off) {
  return (uint64_t)__shfl_down_sync(0xffffffffu, (unsigned long long)x, off);
}
__device__ __forceinline__ uint32_t ldcg(const uint32_t* p) { return __ldcg(p); }
__device__ __forceinline__ uint64_t ldcg(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}
__device__ __forceinline__ void split(const ulonglong2& v, uint64_t& x, uint64_t& y) { x = v.x, y = v.y; }
__device__ __forceinline__ void split(const uint2& v, uint32_t& x, uint32_t& y) { x = v.x, y = v.y; }
__device__ __forceinline__ ulonglong2 join(uint64_t x, uint64_t y) { return make_ulonglong2(x, y); }
__device__ __forceinline__ uint2 join(uint32_t x, uint32_t y) { return make_uint2(x, y); }

// The round's descriptor, built by ops/multiblock.py (its ctypes mirror
// _Args) and passed by value. Tables in kernel order: the ni inner tables,
// then the row tables. Row r of the grid has row coordinates a = r >> rl1
// and b = r & (2^rl1 - 1) (the grid blocks before the inner one); table k
// reads entry a * ra[k] + b * rb[k] (+ the inner coordinate, for an inner
// table).
struct Args {
  unsigned long long in[MAX_TABLES], out[MAX_TABLES];  // out[k] 0 where not folded
  unsigned long long r, claim, sums, partials, counter;  // r, claim: 0 where absent
  int ra[MAX_TABLES], rb[MAX_TABLES];
  int hi[MAX_TABLES];     // offset of the upper block-0 half (0: misses block 0)
  int fold[MAX_TABLES];   // fold half h (0: not folded this round)
  int miss[MAX_TABLES];   // bit 0 / 1: misses row coordinate a / b
  int stage[MAX_TABLES];  // inner tables: shared-memory word offset of its span (-1: per point)
  unsigned icount[MAX_TERMS], rcount[MAX_TERMS];  // factor counts, 4 bits per inner / row table
  int nf[MAX_TERMS], f0[MAX_TERMS], f1[MAX_TERMS];  // NT > 0: inner factors (at most 2) of each term
  int tmode[MAX_TERMS];  // NT > 0: 0 constant in t, 1 / 2 linear (factor f0 / f1 varies), 3 both vary
  int tvals;             // some term has tmode 3
  int ntables, ni, nterms, degree, skip1, vec;
  int rl1, span, spans, rt, tpr, rpi;  // tile: rt rows x span inner points; tpr x rpi threads
  int ntiles, max_blocks;              // the tiles; the most blocks (the partials' rows)
  int rp;                              // shared-memory word offset of the row products (row values at 0)
  int nstaged, stage_a;                // staged tables; some of them cover row coordinate a
  int pslot[MAX_TABLES];               // inner tables read per point: first pipeline slot (-1: none)
  int pipe_k, pipe_stages, pipe_off;   // slots per stage, stages (2, or 0: loads), shared-memory word offset
  int scaled;                          // the sums are written times `scale` (a word of the field)
  unsigned long long scale;
};

__device__ __forceinline__ bool owner(int miss, int a, int b) {
  return (((miss & 1) ? a : 0) | ((miss & 2) ? b : 0)) == 0;
}

// Entry idx of table k (lo and, where it covers block 0, hi), folded at r
// where the round folds it; the owner writes the folded entries.
template <class F>
__device__ __forceinline__ void entry(const F& f, const Args& d, int k, int idx, typename F::word r, bool own,
                                      typename F::word& lo, typename F::word& hv) {
  using W = typename F::word;
  const W* src = reinterpret_cast<const W*>(d.in[k]);
  const int h = d.fold[k], o = d.hi[k];
  if (h) {
    lo = f.fold(src[idx], src[idx + h], r);
    hv = o ? f.fold(src[idx + o], src[idx + o + h], r) : lo;
    if (own) {
      W* out = reinterpret_cast<W*>(d.out[k]);
      out[idx] = lo;
      if (o) out[idx + o] = hv;
    }
  } else {
    lo = src[idx];
    hv = o ? src[idx + o] : lo;
  }
}

// Inner table i at points jj and jj + 1 of the span (the second where
// `two`), from its staged span or with one load per word (a table that is
// not aligned for pairs): lo and hi - lo of each.
template <class F>
__device__ __forceinline__ void inner_pair(const F& f, const Args& d, int i, int base, int jj, bool two,
                                           bool own, typename F::word r, const typename F::word* sm,
                                           typename F::word (&lo)[2], typename F::word (&dl)[2]) {
  using W = typename F::word;
  const int o = d.hi[i];
  if (d.stage[i] >= 0) {
    const W* s = sm + d.stage[i];
    lo[0] = s[jj];
    lo[1] = two ? s[jj + 1] : W(0);
    dl[0] = o ? s[d.span + jj] : W(0);
    dl[1] = o && two ? s[d.span + jj + 1] : W(0);
    return;
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    W hv = 0;
    lo[p] = 0;
    if (p == 0 || two) entry(f, d, i, base + jj + p, r, own, lo[p], hv);
    dl[p] = f.sub(hv, lo[p]);
  }
}

// Inner table i at points jj, jj + 1 of the span (the second where
// `two`) into column i of lo and dl (lo and hi - lo): from shared memory
// where staged, one load per word where not vec; else from src = the
// table at the row's base, word pairs from this thread's pipeline slots or
// 16-byte (Goldilocks) / 8-byte (mont32) loads, folded where due (the
// owner writing the folded pair).
template <class F, int N>
__device__ __forceinline__ void load_pair(const F& f, const Args& d, int i, const typename F::word* src, int base,
                                          int jj, bool two, bool own, typename F::word r,
                                          const typename F::word* sm, const typename F::word2* pipe,
                                          typename F::word (&lo)[2][N], typename F::word (&dl)[2][N]) {
  using W = typename F::word;
  using W2 = typename F::word2;
  const int o = d.hi[i], h = d.fold[i];
  if (d.stage[i] >= 0 || !d.vec) {
    W l2[2], d2[2];
    inner_pair(f, d, i, base, jj, two, own, r, sm, l2, d2);
    lo[0][i] = l2[0], lo[1][i] = l2[1], dl[0][i] = d2[0], dl[1][i] = d2[1];
    return;
  }
  // the step's words: from this thread's pipeline slots where they were
  // copied ahead, else loaded now
  const W* s = src + jj;
  const W2* b = pipe && d.pslot[i] >= 0 ? pipe + d.pslot[i] * THREADS + threadIdx.x : nullptr;
  int k = 0;
  auto get = [&](int off) -> W2 { return b ? b[THREADS * k++] : __ldg(reinterpret_cast<const W2*>(s + off)); };
  W l0, l1, h0, h1;
  split(get(0), l0, l1);
  if (o) split(get(o), h0, h1);
  if (h) {
    W u0, u1;
    split(get(h), u0, u1);
    l0 = f.fold(l0, u0, r);
    l1 = f.fold(l1, u1, r);
    if (o) {
      split(get(o + h), u0, u1);
      h0 = f.fold(h0, u0, r);
      h1 = f.fold(h1, u1, r);
    }
    if (own) {
      W* out = reinterpret_cast<W*>(d.out[i]) + base + jj;
      *reinterpret_cast<W2*>(out) = join(l0, l1);
      if (o) *reinterpret_cast<W2*>(out + o) = join(h0, h1);
    }
  }
  lo[0][i] = l0, lo[1][i] = l1;
  dl[0][i] = o ? f.sub(h0, l0) : W(0);
  dl[1][i] = o ? f.sub(h1, l1) : W(0);
}

// Copy the words of one step (points jj, jj + 1) of every pipelined inner
// table into this thread's slots of a pipeline stage (cp.async: no
// registers hold them in flight), then commit the group (empty past the
// span, so that every step commits one).
template <class F, int N>
__device__ __forceinline__ void pipe_copy(const Args& d, const typename F::word* const (&src)[N], int ni, int jj,
                                           typename F::word2* stage) {
  using W2 = typename F::word2;
  if (jj < d.span) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i >= ni || d.pslot[i] < 0) continue;
      const int o = d.hi[i], h = d.fold[i];
      const auto* s = src[i] + jj;
      W2* b = stage + d.pslot[i] * THREADS + threadIdx.x;
      __pipeline_memcpy_async(b, s, sizeof(W2));
      if (o) __pipeline_memcpy_async(b += THREADS, s + o, sizeof(W2));
      if (h) {
        __pipeline_memcpy_async(b += THREADS, s + h, sizeof(W2));
        if (o) __pipeline_memcpy_async(b += THREADS, s + o + h, sizeof(W2));
      }
    }
  }
  __pipeline_commit();
}

template <int N, class W>
__device__ __forceinline__ W pick(const W (&v)[N], int i) {
  W x = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (i == k) x = v[k];
  return x;
}

// The accumulators of one row: NT > 0 keeps them in registers and each
// term's (at most two) inner factors at fixed positions; NT = 0 (generic)
// indexes them at run time (local memory) and multiplies any factor counts.
template <class F, int NT, int D, int NI>
struct Point {
  using W = typename F::word;
  typename F::Acc acc[NT][D + 1];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int t = 0; t <= D; ++t) acc[j][t] = typename F::Acc{};
  }
  // A term whose inner product varies with at most one factor (tmode 0-2)
  // is linear in t: its row sums are kept as two coefficients, the value
  // at t = 0 and the slope (two products per point, none for a term of
  // one factor); a term with two varying factors (tmode 3) as its values
  // at t = 0..D.
  __device__ __forceinline__ void add(const F& f, const Args& d, const W (&lo)[NI], const W (&dl)[NI]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = d.nf[j], m = d.tmode[j];
      if (m == 3) continue;
      if (n >= 2) {
        const W a = pick(lo, d.f0[j]), b = pick(lo, d.f1[j]);
        f.acc_add(acc[j][0], a, b);
        if (m == 1) f.acc_add(acc[j][1], pick(dl, d.f0[j]), b);
        else if (m == 2) f.acc_add(acc[j][1], a, pick(dl, d.f1[j]));
      } else {
        f.acc_add1(acc[j][0], n ? pick(lo, d.f0[j]) : f.one());
        if (m) f.acc_add1(acc[j][1], pick(dl, d.f0[j]));
      }
    }
    if (!d.tvals) return;
    W v[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) v[i] = lo[i];
#pragma unroll
    for (int t = 0; t <= D; ++t) {
      if (t) {
#pragma unroll
        for (int i = 0; i < NI; ++i)
          if (d.hi[i]) v[i] = f.add(v[i], dl[i]);  // v(t) = lo + t (hi - lo)
      }
      if (t == 1 && d.skip1) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (d.tmode[j] == 3) f.acc_add(acc[j][t], pick(v, d.f0[j]), pick(v, d.f1[j]));
    }
  }
  // out[t] += rp[j][t] * (this row's sum of term j at t)
  __device__ __forceinline__ void flush(const F& f, const Args& d, const W* rp, typename F::Acc (&out)[D + 1]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = d.tmode[j];
      W c0 = 0, c1 = 0;
      if (m != 3) {
        c0 = f.acc_reduce(acc[j][0]);
        if (m) c1 = f.acc_reduce(acc[j][1]);
      }
#pragma unroll
      for (int t = 0; t <= D; ++t) {
        if (t == 1 && d.skip1) continue;
        const W x = m == 3 ? f.acc_reduce(acc[j][t]) : t && m ? f.add(c0, f.mul(f.small(t), c1)) : c0;
        f.acc_add(out[t], rp[j * (D + 1) + t], x);
      }
    }
  }
};

template <class F>
struct Point<F, 0, 0, 0> {
  using W = typename F::word;
  typename F::Acc acc[MAX_TERMS][MAX_D + 1];
  __device__ __forceinline__ void zero() {
    for (int j = 0; j < MAX_TERMS; ++j)
      for (int t = 0; t <= MAX_D; ++t) acc[j][t] = typename F::Acc{};
  }
  __device__ __forceinline__ void add(const F& f, const Args& d, const W (&lo)[MAX_TABLES],
                                      const W (&dl)[MAX_TABLES]) {
#pragma unroll 1
    for (int j = 0; j < d.nterms; ++j) {
      W cur[MAX_TABLES];
#pragma unroll
      for (int i = 0; i < MAX_TABLES; ++i) cur[i] = lo[i];
#pragma unroll 1
      for (int t = 0; t <= d.degree; ++t) {
        if (t) {
#pragma unroll
          for (int i = 0; i < MAX_TABLES; ++i)
            if (i < d.ni) cur[i] = f.add(cur[i], dl[i]);
        }
        if (t == 1 && d.skip1) continue;
        // the product of the term's inner factors: all but the last
        // reduced, the last into the accumulator (none: the word 1)
        W a = f.one(), pend = f.one();
        int n = 0;
#pragma unroll
        for (int i = 0; i < MAX_TABLES; ++i) {
          if (i >= d.ni) break;
#pragma unroll 1
          for (unsigned c = 0; c < ((d.icount[j] >> (4 * i)) & 15u); ++c) {
            if (n == 1) a = pend;
            else if (n > 1) a = f.mul(a, pend);
            pend = cur[i];
            ++n;
          }
        }
        if (n <= 1) f.acc_add1(acc[j][t], pend);
        else f.acc_add(acc[j][t], a, pend);
      }
    }
  }
  __device__ __forceinline__ void flush(const F& f, const Args& d, const W* rp, typename F::Acc (&out)[MAX_D + 1]) {
#pragma unroll 1
    for (int j = 0; j < d.nterms; ++j)
#pragma unroll 1
      for (int t = 0; t <= d.degree; ++t) {
        if (t == 1 && d.skip1) continue;
        f.acc_add(out[t], rp[j * (d.degree + 1) + t], f.acc_reduce(acc[j][t]));
      }
  }
};

// The staged inner table i over one span (it is folded this round): lo,
// then hi - lo where it covers block 0, into s. Each thread starts SG
// entries' loads before it folds them.
template <class F>
__device__ __forceinline__ void stage_span(const F& f, const Args& d, int i, int base, typename F::word r,
                                           typename F::word* s) {
  using W = typename F::word;
  constexpr int SG = 4;
  const W* src = reinterpret_cast<const W*>(d.in[i]) + base;
  const int h = d.fold[i], o = d.hi[i], span = d.span;
#pragma unroll 1
  for (int j = threadIdx.x; j < span; j += SG * THREADS) {
    W lo[SG], lh[SG], hi[SG], hh[SG];
#pragma unroll
    for (int g = 0; g < SG; ++g) {
      const int jj = j + g * THREADS;
      lo[g] = lh[g] = hi[g] = hh[g] = 0;
      if (jj < span) {
        lo[g] = src[jj], lh[g] = src[jj + h];
        if (o) hi[g] = src[jj + o], hh[g] = src[jj + o + h];
      }
    }
#pragma unroll
    for (int g = 0; g < SG; ++g) {
      const int jj = j + g * THREADS;
      if (jj >= span) continue;
      const W l = f.fold(lo[g], lh[g], r);
      s[jj] = l;
      if (o) s[span + jj] = f.sub(f.fold(hi[g], hh[g], r), l);
    }
  }
}

// One round (see the file note). The blocks walk the tiles, each a
// contiguous range of them; tile x is rows [x / spans * rt, + rt) and span
// x % spans of the inner block. A block's threads: tpr along a row, rpi
// rows at once (thread = rsub * tpr + lane). The staged spans are folded
// again only where a tile's differ from the last tile's.
template <class F, int NT, int D, int NI>
__global__ void __launch_bounds__(THREADS, NT ? MIN_BLOCKS : 1) mb_round_kernel(F f, const Args d) {
  using W = typename F::word;
  using W2 = typename F::word2;
  using Acc = typename F::Acc;
  constexpr bool GEN = NT == 0;
  constexpr int DM = GEN ? MAX_D : D, NIM = GEN ? MAX_TABLES : NI;
  const int nterms = GEN ? d.nterms : NT, degree = GEN ? d.degree : D, ni = GEN ? d.ni : NI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* sm = reinterpret_cast<W*>(smem_raw);
  const int mask = (1 << d.rl1) - 1;
  const W rr = d.r ? reinterpret_cast<const W*>(d.r)[0] : W(0);
  const int nrow = d.ntables - ni;
  const int per = (d.ntiles + gridDim.x - 1) / gridDim.x;
  const int first = blockIdx.x * per, stop = min(first + per, d.ntiles);
  const int lane = threadIdx.x % d.tpr, rsub = threadIdx.x / d.tpr;
  Acc out[DM + 1];
#pragma unroll
  for (int t = 0; t <= DM; ++t) out[t] = Acc{};
  int staged_key = -1;

#pragma unroll 1
  for (int x = first; x < stop; ++x) {
    const int tile = x / d.spans, span = x - tile * d.spans;
    const int r0 = tile * d.rt, j0 = span * d.span;
    const int a0 = r0 >> d.rl1, b0 = r0 & mask;
    const int key = (d.stage_a ? a0 : 0) * d.spans + span;
    __syncthreads();  // the last tile's shared memory is read
    // 1. the row tables at the tile's rows (the owner, in the first span,
    // writes the folded entries), and the staged inner tables over the span
    // where they change: (lo, hi - lo) in shared memory
    for (int y = threadIdx.x; y < d.rt * nrow; y += THREADS) {
      const int rho = y / nrow, k = ni + y - rho * nrow;
      const int r = r0 + rho, a = r >> d.rl1, b = r & mask;
      W lo, hv;
      entry(f, d, k, a * d.ra[k] + b * d.rb[k], rr, span == 0 && owner(d.miss[k], a, b), lo, hv);
      sm[2 * y] = lo;
      sm[2 * y + 1] = f.sub(hv, lo);
    }
    if (d.nstaged && key != staged_key) {
#pragma unroll 1
      for (int i = 0; i < ni; ++i)
        if (d.stage[i] >= 0) stage_span(f, d, i, a0 * d.ra[i] + b0 * d.rb[i] + j0, rr, sm + d.stage[i]);
      staged_key = key;
    }
    __syncthreads();
    // 2. the row products (term j's row factors at row rho and t), and the
    // staged tables' folded entries where this tile owns them
    for (int y = threadIdx.x; y < d.rt * nterms; y += THREADS) {
      const int rho = y / nterms, j = y - rho * nterms;
      const W* rv = sm + 2 * rho * nrow;
#pragma unroll 1
      for (int t = 0; t <= degree; ++t) {
        const W tw = f.small(t);
        W prod = f.one();
#pragma unroll 1
        for (int q = 0; q < nrow; ++q) {
          const unsigned c = (d.rcount[j] >> (4 * q)) & 15u;
          if (!c) continue;
          const W v = f.add(rv[2 * q], f.mul(tw, rv[2 * q + 1]));
#pragma unroll 1
          for (unsigned e = 0; e < c; ++e) prod = f.mul(prod, v);
        }
        sm[d.rp + y * (degree + 1) + t] = prod;
      }
    }
    if (d.nstaged) {
#pragma unroll 1
      for (int i = 0; i < ni; ++i) {
        if (d.stage[i] < 0 || !owner(d.miss[i], a0, b0)) continue;
        W* o = reinterpret_cast<W*>(d.out[i]) + a0 * d.ra[i] + b0 * d.rb[i] + j0;
        const W* s = sm + d.stage[i];
        for (int jj = threadIdx.x; jj < d.span; jj += THREADS) {
          o[jj] = s[jj];
          if (d.hi[i]) o[jj + d.hi[i]] = f.add(s[jj], s[d.span + jj]);
        }
      }
    }
    __syncthreads();

    // 3. the points: a row's inner sums per term and t, then the row product
    if (rsub < d.rpi) {
      Point<F, NT, D, NI> pt;
#pragma unroll 1
      for (int rho = rsub; rho < d.rt; rho += d.rpi) {
        const int r = r0 + rho, a = r >> d.rl1, b = r & mask;
        int base[NIM];
        bool own[NIM];
#pragma unroll
        for (int i = 0; i < NIM; ++i) {
          base[i] = i < ni ? a * d.ra[i] + b * d.rb[i] + j0 : 0;
          own[i] = i < ni && owner(d.miss[i], a, b);
        }
        pt.zero();
        const W* src[NIM];
#pragma unroll
        for (int i = 0; i < NIM; ++i) src[i] = reinterpret_cast<const W*>(d.in[i < ni ? i : 0]) + base[i];
        // the pipeline: the next step copied ahead of the one in use
        const int step = 2 * d.tpr;
        const bool piped = !GEN && d.vec && d.pipe_stages;
        W2* const pipe = reinterpret_cast<W2*>(sm + d.pipe_off);
        const int ssize = d.pipe_k * THREADS;
        if (piped) pipe_copy<F, NIM>(d, src, ni, 2 * lane, pipe);
        int cur = 0;
#pragma unroll 1
        for (int jj = 2 * lane; jj < d.span; jj += step) {
          const bool two = jj + 1 < d.span;
          const W2* pb = nullptr;
          if (piped) {
            pipe_copy<F, NIM>(d, src, ni, jj + step, pipe + (cur ^ 1) * ssize);
            __pipeline_wait_prior(1);
            pb = pipe + cur * ssize;
            cur ^= 1;
          }
          W lo[2][NIM], dl[2][NIM];
#pragma unroll
          for (int i = 0; i < NIM; ++i) {
            if (i < ni) {
              load_pair<F, NIM>(f, d, i, src[i], base[i], jj, two, own[i], rr, sm, pb, lo, dl);
            } else {
              lo[0][i] = lo[1][i] = dl[0][i] = dl[1][i] = 0;
            }
          }
          pt.add(f, d, lo[0], dl[0]);
          if (two) pt.add(f, d, lo[1], dl[1]);
        }
        pt.flush(f, d, sm + d.rp + rho * nterms * (degree + 1), out);
      }
    }
  }

  // 4. the block's s(t), then the last block's sum over blocks and s(1)
  __shared__ W red[THREADS / 32][MAX_D + 1];
  __shared__ W tot[MAX_D + 1];
  __shared__ int last;
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  W* part = reinterpret_cast<W*>(d.partials);
#pragma unroll
  for (int t = 0; t <= DM; ++t) {
    if (t > degree) break;
    W x = f.acc_reduce(out[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = f.add(x, shfl_down(x, off));
    if (wl == 0) red[warp][t] = x;
  }
  __syncthreads();
  if (threadIdx.x <= degree) {
    W s = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s = f.add(s, red[w][threadIdx.x]);
    tot[threadIdx.x] = s;
    if (gridDim.x > 1) {
      part[blockIdx.x * (degree + 1) + threadIdx.x] = s;
      __threadfence();
    }
  }
  __syncthreads();
  if (gridDim.x > 1) {
    int* counter = reinterpret_cast<int*>(d.counter);
    if (threadIdx.x == 0) last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    W s[DM + 1];
#pragma unroll
    for (int t = 0; t <= DM; ++t) s[t] = 0;
    for (int x = threadIdx.x; x < (int)gridDim.x; x += THREADS) {
#pragma unroll
      for (int t = 0; t <= DM; ++t)
        if (t <= degree) s[t] = f.add(s[t], ldcg(part + x * (degree + 1) + t));
    }
#pragma unroll
    for (int t = 0; t <= DM; ++t) {
      if (t > degree) break;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[t] = f.add(s[t], shfl_down(s[t], off));
      if (wl == 0) red[warp][t] = s[t];
    }
    __syncthreads();
    if (threadIdx.x <= degree) {
      W x = 0;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) x = f.add(x, red[w][threadIdx.x]);
      tot[threadIdx.x] = x;
    }
    __syncthreads();
    if (threadIdx.x == 0) *counter = 0;
  }
  if (threadIdx.x == 0) {
    W* sums = reinterpret_cast<W*>(d.sums);
    for (int t = 0; t <= degree; ++t) sums[t] = d.scaled ? f.mul(tot[t], (W)d.scale) : tot[t];
    if (d.skip1) sums[1] = d.claim ? f.sub(reinterpret_cast<const W*>(d.claim)[0], sums[0]) : W(0);
  }
}

// The flat fold: out[k][j] = fold(in[k][j], in[k][j + half[k]], r) for
// j < half[k], every table at once (half[k] = 0: not folded).
template <class W>
struct FoldDesc {
  const W* in[MAX_TABLES];
  W* out[MAX_TABLES];
  long long half[MAX_TABLES];
  int ntables;
  long long most;  // the largest half
};

template <class F>
__global__ void __launch_bounds__(THREADS)
    mb_fold_kernel(F f, FoldDesc<typename F::word> d, const typename F::word* __restrict__ r) {
  using W = typename F::word;
  const W rr = r[0];
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x; j < d.most; j += (long long)gridDim.x * THREADS) {
#pragma unroll
    for (int k = 0; k < MAX_TABLES; ++k) {
      if (k >= d.ntables) break;
      const long long h = d.half[k];
      if (j < h) d.out[k][j] = f.fold(d.in[k][j], d.in[k][j + h], rr);
    }
  }
}

// Blocks of a round: as many as fit on the card at once (its SMs times the
// kernel's occupancy), no more than the tiles or the partials' rows.
template <class K>
int grid_for(K kernel, int smem, const Args& a) {
  int dev = 0, sms = 1, occ = 1;
  if (smem > 48 * 1024) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, smem);
  const int g = sms * (occ > 0 ? occ : 1);
  return g < a.ntiles ? (g < a.max_blocks ? g : a.max_blocks) : (a.ntiles < a.max_blocks ? a.ntiles : a.max_blocks);
}

// The instantiations: the paths' shapes (terms, degree, inner tables) and
// the generic one.
template <class F>
int launch_round(const F& f, const Args& a, int smem, cudaStream_t s) {
  if (a.ntables < 1 || a.ntables > MAX_TABLES || a.ni < 0 || a.ni > a.ntables || a.nterms < 1 ||
      a.nterms > MAX_TERMS || a.degree < 0 || a.degree > MAX_D || a.ntiles < 1 || a.max_blocks < 1 ||
      a.tpr < 1 || a.rpi < 1 || a.tpr * a.rpi > THREADS || a.span < 1 || a.rt < 1 || a.spans < 1 ||
      a.ntiles % a.spans != 0)
    return (int)cudaErrorInvalidValue;
  bool fast = true;
  for (int j = 0; j < a.nterms; ++j) fast = fast && a.nf[j] >= 0 && a.nf[j] <= 2;
#define MB_CASE(NT_, D_, NI_)                                                          \
  if (fast && a.nterms == NT_ && a.degree == D_ && a.ni == NI_) {                     \
    auto kernel = mb_round_kernel<F, NT_, D_, NI_>;                                    \
    kernel<<<grid_for(kernel, smem, a), THREADS, smem, s>>>(f, a);                     \
    return 0;                                                                          \
  }
  MB_CASE(1, 1, 2)  // the triangle's and the matmul entry's c_1
  MB_CASE(1, 2, 2)  // the triangle's rounds
  MB_CASE(2, 1, 3)  // the LibraW c_1
  MB_CASE(3, 1, 3)  // dense W's c_1
  MB_CASE(3, 2, 3)  // dense W's rounds
#undef MB_CASE
  auto kernel = mb_round_kernel<F, 0, 0, 0>;
  kernel<<<grid_for(kernel, smem, a), THREADS, smem, s>>>(f, a);
  return 0;
}

template <class F>
int launch_fold(const F& f, int ntables, const void* const* in, void* const* out, const long long* half,
                const void* r, int blocks, cudaStream_t s) {
  using W = typename F::word;
  if (ntables < 1 || ntables > MAX_TABLES) return (int)cudaErrorInvalidValue;
  FoldDesc<W> d{};
  d.most = 0;
  for (int k = 0; k < ntables; ++k) {
    d.in[k] = static_cast<const W*>(in[k]);
    d.out[k] = static_cast<W*>(out[k]);
    d.half[k] = half[k];
    if (half[k] > d.most) d.most = half[k];
  }
  d.ntables = ntables;
  mb_fold_kernel<F><<<blocks, THREADS, 0, s>>>(f, d, static_cast<const W*>(r));
  return 0;
}

}  // namespace

// One round (see the file note); args points to an Args. smem: the dynamic
// shared memory in bytes (row values, row products, staged spans). mont32 = 0 takes
// Goldilocks int64 words; mont32 = 1 Montgomery words of the field with
// modulus p < 2^31 and pinv = -p^-1 mod 2^32. Returns cudaGetLastError()
// after the launch (0 = launched); the wrapper checks every argument first.
extern "C" int ts_mb_round_launch(int mont32, unsigned p, unsigned pinv, const void* args_, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args* args = static_cast<const Args*>(args_);
  int rc;
  if (mont32) {
    rc = launch_round(M32Ops{{p, pinv}}, *args, smem, s);
  } else {
    rc = launch_round(GlOps{}, *args, smem, s);
  }
  return rc ? rc : (int)cudaGetLastError();
}

// The size of Args, for the wrapper's check of its ctypes mirror.
extern "C" int ts_mb_args_size() { return (int)sizeof(Args); }

// The flat fold of ntables tables (half[k] = 0: table k is not folded and
// out[k] may be null). Returns as above.
extern "C" int ts_mb_fold_launch(int mont32, unsigned p, unsigned pinv, int ntables, const void* const* in,
                                 void* const* out, const long long* half, const void* r, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = mont32 ? launch_fold(M32Ops{{p, pinv}}, ntables, in, out, half, r, blocks, s)
                        : launch_fold(GlOps{}, ntables, in, out, half, r, blocks, s);
  return rc ? rc : (int)cudaGetLastError();
}
