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
// and small X phases, GKR's dense W in both phases, and the single-block
// products the round kernel (round_kernel.cu) does not take (k = 1,
// k >= 4, scalars other than the LibraW shapes). Its plain version is
// ops/multiblock.round_partials_plain / fold_tables_plain.
//
// What it computes. The grid is the spec's block grid after the fold, block
// 0 halved: g = (i0, i1, i2) with i0 < half0 (MSB-first, i2 fastest).
// Table k is flat over the blocks it covers; stride[k][b] is its index
// stride for grid block b (0 where it does not cover b). At grid point g a
// table reads lo = T[idx] and, where it covers block 0, hi = T[idx + half0
// * stride[k][0]] (else hi = lo). With FOLD, a table with fold_half[k] =
// h > 0 is the previous spec's table of 2h entries folded at r on the fly,
// T'[j] = fold(T[j], T[j + h], r) (its first variable is the round's, the
// MSB), and T' is written to out[k] by the one grid point that owns each
// entry: the one whose coordinates in the blocks T' does not cover are 0.
// The sums: s(t) = sum over g of sum over terms of prod_k v_k(t)^count[j][k]
// with v(0) = lo, v(t) = v(t - 1) + (hi - lo), t = 0..D; SKIP1 leaves s(1)
// out (0: the caller sets claim - s(0)). Summing a term over grid blocks it
// does not cover multiplies it by 2^(their variables), which is the
// JAX program's 2^missing factor (_round_sums :277-280): the same field
// value, at the cost of the repeated work. Each block writes its partial
// sums to partials[block][t]; the caller sums them mod p.
//
// What bounds it on the H100: device memory where the tables are large
// against the grid (a 2^24-entry triangle table read and half written in
// the Y phase's first round), the 64-bit products where a table is read
// many times over (a table that misses a grid block is re-read and, with
// FOLD, re-folded at every point of that block; dense W's Wb). Neighbouring
// threads take neighbouring grid points, so a table over the last grid
// block is read coalesced and one that misses it is one broadcast load per
// warp. The sums stay unreduced in registers (K1's lazy accumulators: one
// reduction per thread per t). The descriptor is a run-time argument: one
// build serves every spec. Loops over the tables are unrolled to the
// maximum with guards, so the register arrays are indexed statically and
// every thread takes the same branches; the loops over t and the terms
// are not unrolled, so the product code exists once.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TABLES = 8;
constexpr int MAX_TERMS = 8;
constexpr int MAX_D = 8;

struct GlOps {
  using word = uint64_t;
  using Acc = gl::Acc;
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
  __device__ __forceinline__ word sub(word a, word b) const { return gl::sub(a, b); }
  __device__ __forceinline__ word mul(word a, word b) const { return gl::mul(a, b); }
  __device__ __forceinline__ word fold(word lo, word hi, word r) const { return gl::fold(lo, hi, r); }
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const {
    gl::acc_add(acc, a * b, __umul64hi(a, b));
  }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return gl::acc_reduce(acc); }
  __device__ __forceinline__ void acc_merge(Acc& acc, const Acc& b) const {
    gl::acc_add(acc, b.lo, b.hi);
    acc.top += b.top;
  }
};

struct M32Ops : m32::Field {
  using word = uint32_t;
  using Acc = m32::Acc;
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const {
    m32::acc_add(acc, (uint64_t)a * b);
  }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return m32::acc_reduce(*this, acc); }
  __device__ __forceinline__ void acc_merge(Acc& acc, const Acc& b) const {
    m32::acc_add(acc, b.lo);
    acc.hi += b.hi;
  }
};

__device__ __forceinline__ uint32_t shfl_down(uint32_t x, int off) {
  return __shfl_down_sync(0xffffffffu, x, off);
}
__device__ __forceinline__ uint64_t shfl_down(uint64_t x, int off) {
  return (uint64_t)__shfl_down_sync(0xffffffffu, (unsigned long long)x, off);
}

// The round's descriptor (see the file note), passed by value.
template <class W>
struct Desc {
  const W* in[MAX_TABLES];
  W* out[MAX_TABLES];
  long long stride[MAX_TABLES][3];
  long long fold_half[MAX_TABLES];
  uint32_t count[MAX_TERMS];  // term j: table k's multiplicity in bits 4k..4k+3
  int ntables, nterms, degree;
  int log1, log2;  // grid blocks 1 and 2: log2 of their sizes (0 where absent)
  long long half0, grid;
};

// acc += the term's product: every factor but the last multiplied and
// reduced, the last one into the lazy accumulator; a single-factor term
// enters as a product with the field's one (the raw product then has the
// form of every other: mont32 R^2 x). count: 4 bits per table.
template <class F>
__device__ __forceinline__ void add_term(const F& f, typename F::Acc& acc, const typename F::word (&v)[MAX_TABLES],
                                         uint32_t count, int ntables, typename F::word one) {
  using W = typename F::word;
  W a = 0, pend = 0;
  int n = 0;
#pragma unroll
  for (int k = 0; k < MAX_TABLES; ++k) {
    if (k >= ntables) break;
#pragma unroll 1
    for (uint32_t c = 0; c < ((count >> (4 * k)) & 15u); ++c) {
      if (n == 1) a = pend;
      else if (n > 1) a = f.mul(a, pend);
      pend = v[k];
      ++n;
    }
  }
  if (n == 1) f.acc_add(acc, pend, one);
  else if (n > 1) f.acc_add(acc, a, pend);
}

// grid = (blocks). Block x covers grid points [x * chunk, min((x + 1) *
// chunk, grid)), its threads striding by THREADS; partials[x][t], t = 0..D.
template <class F, bool FOLD, bool SKIP1>
__global__ void __launch_bounds__(THREADS)
    mb_round_kernel(F f, Desc<typename F::word> d, const typename F::word* __restrict__ r, typename F::word one,
                    typename F::word* __restrict__ partials, long long chunk) {
  using W = typename F::word;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < d.grid ? begin + chunk : d.grid;
  const W rr = FOLD ? r[0] : 0;
  const long long mask1 = (1ll << d.log1) - 1, mask2 = (1ll << d.log2) - 1;
  // the terms' factor counts, packed and read from shared memory by the
  // (not unrolled) term loop
  __shared__ uint32_t counts[MAX_TERMS];
#pragma unroll
  for (int j = 0; j < MAX_TERMS; ++j)
    if (threadIdx.x == j) counts[j] = d.count[j];
  __syncthreads();

  typename F::Acc acc[MAX_D + 1];
#pragma unroll
  for (int t = 0; t <= MAX_D; ++t) acc[t] = typename F::Acc{};

  for (long long g = begin + threadIdx.x; g < end; g += THREADS) {
    const long long i2 = g & mask2, i1 = (g >> d.log2) & mask1, i0 = g >> (d.log1 + d.log2);
    W v[MAX_TABLES], delta[MAX_TABLES];
#pragma unroll
    for (int k = 0; k < MAX_TABLES; ++k) {
      if (k >= d.ntables) break;
      const long long s0 = d.stride[k][0], s1 = d.stride[k][1], s2 = d.stride[k][2];
      const long long lo_i = i0 * s0 + i1 * s1 + i2 * s2;
      const long long hi_i = lo_i + d.half0 * s0;
      const W* src = d.in[k];
      W lo, hi;
      if (FOLD && d.fold_half[k]) {
        const long long h = d.fold_half[k];
        lo = f.fold(src[lo_i], src[lo_i + h], rr);
        hi = s0 ? f.fold(src[hi_i], src[hi_i + h], rr) : lo;
        // the owner: 0 in every grid block this table does not cover
        if (((s0 ? 0 : i0) | (s1 ? 0 : i1) | (s2 ? 0 : i2)) == 0) {
          d.out[k][lo_i] = lo;
          if (s0) d.out[k][hi_i] = hi;
        }
      } else {
        lo = src[lo_i];
        hi = s0 ? src[hi_i] : lo;
      }
      v[k] = lo;
      delta[k] = f.sub(hi, lo);
    }
    // t and the terms in loops that are not unrolled (one copy of the
    // product code); each t's sum enters its accumulator by a static select
#pragma unroll 1
    for (int t = 0; t <= d.degree; ++t) {
      if (t > 0) {
#pragma unroll
        for (int k = 0; k < MAX_TABLES; ++k)
          if (k < d.ntables) v[k] = f.add(v[k], delta[k]);
      }
      if (SKIP1 && t == 1) continue;
      typename F::Acc cur{};
#pragma unroll 1
      for (int j = 0; j < d.nterms; ++j) add_term(f, cur, v, counts[j], d.ntables, one);
#pragma unroll
      for (int s = 0; s <= MAX_D; ++s)
        if (s == t) f.acc_merge(acc[s], cur);
    }
  }

  __shared__ W warp_sums[THREADS / 32][MAX_D + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t <= MAX_D; ++t) {
    if (t > d.degree) break;
    W x = f.acc_reduce(acc[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = f.add(x, shfl_down(x, off));
    if (lane == 0) warp_sums[warp][t] = x;
  }
  __syncthreads();
  if (threadIdx.x <= d.degree) {
    W total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total = f.add(total, warp_sums[w][threadIdx.x]);
    partials[(long long)blockIdx.x * (d.degree + 1) + threadIdx.x] = total;
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

template <class F>
int launch_round(const F& f, typename F::word one, int fold, int skip_t1, int ntables, const void* const* in,
                 void* const* out, const long long* strides, const long long* fold_half, int nterms,
                 const unsigned char* counts, int degree, int log1, int log2, long long half0, const void* r,
                 void* partials, int blocks, long long chunk, cudaStream_t s) {
  using W = typename F::word;
  if (ntables < 1 || ntables > MAX_TABLES || nterms < 1 || nterms > MAX_TERMS || degree < 0 || degree > MAX_D)
    return (int)cudaErrorInvalidValue;
  Desc<W> d{};
  for (int k = 0; k < ntables; ++k) {
    d.in[k] = static_cast<const W*>(in[k]);
    d.out[k] = static_cast<W*>(out[k]);
    for (int b = 0; b < 3; ++b) d.stride[k][b] = strides[3 * k + b];
    d.fold_half[k] = fold_half[k];
  }
  for (int j = 0; j < nterms; ++j)
    for (int k = 0; k < ntables; ++k) {
      if (counts[j * ntables + k] > 15) return (int)cudaErrorInvalidValue;
      d.count[j] |= (uint32_t)counts[j * ntables + k] << (4 * k);
    }
  d.ntables = ntables;
  d.nterms = nterms;
  d.degree = degree;
  d.log1 = log1;
  d.log2 = log2;
  d.half0 = half0;
  d.grid = half0 << (log1 + log2);
  const W* rp = static_cast<const W*>(r);
  W* pp = static_cast<W*>(partials);
  if (fold && skip_t1) mb_round_kernel<F, true, true><<<blocks, THREADS, 0, s>>>(f, d, rp, one, pp, chunk);
  else if (fold) mb_round_kernel<F, true, false><<<blocks, THREADS, 0, s>>>(f, d, rp, one, pp, chunk);
  else if (skip_t1) mb_round_kernel<F, false, true><<<blocks, THREADS, 0, s>>>(f, d, rp, one, pp, chunk);
  else mb_round_kernel<F, false, false><<<blocks, THREADS, 0, s>>>(f, d, rp, one, pp, chunk);
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

// One round (see the file note). in/out: ntables pointers (out[k] null
// where fold_half[k] = 0); strides: ntables x 3; counts: nterms x ntables;
// the grid is half0 x 2^log1 x 2^log2 points; r: one word (null without
// fold); partials: blocks x (degree + 1) words. mont32 = 0 takes
// Goldilocks int64 words; mont32 = 1 Montgomery words of the field with
// modulus p < 2^31 and pinv = -p^-1 mod 2^32. Returns cudaGetLastError()
// after the launch (0 = launched); the wrapper checks every argument first.
extern "C" int ts_mb_round_launch(int mont32, unsigned p, unsigned pinv, int fold, int skip_t1, int ntables,
                                  const void* const* in, void* const* out, const long long* strides,
                                  const long long* fold_half, int nterms, const unsigned char* counts, int degree,
                                  int log1, int log2, long long half0, const void* r, void* partials, int blocks,
                                  long long chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (mont32) {
    const uint32_t one = (uint32_t)((1ull << 32) % p);  // the Montgomery word of 1
    rc = launch_round(M32Ops{{p, pinv}}, one, fold, skip_t1, ntables, in, out, strides, fold_half, nterms, counts,
                      degree, log1, log2, half0, r, partials, blocks, chunk, s);
  } else {
    rc = launch_round(GlOps{}, (uint64_t)1, fold, skip_t1, ntables, in, out, strides, fold_half, nterms, counts,
                      degree, log1, log2, half0, r, partials, blocks, chunk, s);
  }
  return rc ? rc : (int)cudaGetLastError();
}

// The flat fold of ntables tables (half[k] = 0: table k is not folded and
// out[k] may be null). Returns as above.
extern "C" int ts_mb_fold_launch(int mont32, unsigned p, unsigned pinv, int ntables, const void* const* in,
                                 void* const* out, const long long* half, const void* r, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = mont32 ? launch_fold(M32Ops{{p, pinv}}, ntables, in, out, half, r, blocks, s)
                        : launch_fold(GlOps{}, ntables, in, out, half, r, blocks, s);
  return rc ? rc : (int)cudaGetLastError();
}
