// The dense MLE's device programs, over Goldilocks or a mont32 field
// (p < 2^31): the bit reversal, and the fold of a table's first k
// variables at P points in two forms, one point (the fold chain) and a
// batch of points (the evaluation at many points).
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
// FOLD. out[p][j] = sum_{x < 2^k} eq(r_p, x) t[x 2^(n-k) + j] for the
// table t of 2^n words (internal MSB-first order: variable i is bit
// k - 1 - i of the row x), P points of k coordinates, j < M = 2^(n-k):
// the value of k fold steps lo + r (hi - lo), in one pass over the table.
// Field sums do not depend on their order, so the result is the fold
// chain's, word for word. The table is read as [2^k rows][M columns]. A
// block takes a tile of CT = min(M, 256) columns, 256 / CT lanes over the
// rows, one chunk of 2^(k-s) rows (grid y: the S = 2^s chunks) and PB
// points (grid z). eq(r_p, x) splits over x's bits: the chunk's top s bits
// (one factor per block and point), mb middle bits (a table of 2^mb words
// per point in shared memory) and the lane's low c bits (one factor per
// thread and point). So every table word is loaded once per block and
// costs one unreduced product per point, summed without reduction (192-bit
// sums of 128-bit products for Goldilocks, 128-bit sums of raw Montgomery
// products for mont32); each thread reduces once per point, the lanes sum
// in shared memory, and with S > 1 the last block of a tile and point
// chunk (a ticket) sums the chunks' partials. The wrapper's plan
// (ops/mle_kernel.plan) picks s for about 512 blocks. What bounds it: the
// products, P 2^n of them, and the bytes of the table read once (the
// matmul entry's fold of 13 of 26 variables: 512 MB, 0.16 ms; the GKR
// flagship's 21 points over 2^20 words: 22 million products).
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 32;         // bit reversal: a tile of TILE x TILE words
constexpr int TILE_LOG = 5;
constexpr int MID_WORDS = 2048;  // fold: the middle eq tables' words (ops/mle_kernel.MID_WORDS)

struct GlOps {
  using word = uint64_t;
  using Acc = gl::Acc;
  __device__ __forceinline__ word one() const { return 1; }
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
  __device__ __forceinline__ word sub(word a, word b) const { return gl::sub(a, b); }
  __device__ __forceinline__ word mul(word a, word b) const { return gl::mul(a, b); }
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const {
    gl::acc_add(acc, a * b, __umul64hi(a, b));
  }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return gl::acc_reduce(acc); }
};

struct M32Ops : m32::Field {
  using word = uint32_t;
  using Acc = m32::Acc;
  __device__ __forceinline__ word one() const { return r1; }
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const { m32::acc_add(acc, (uint64_t)a * b); }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return m32::acc_reduce(*this, acc); }
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

template <class F, int PB>
__global__ void __launch_bounds__(THREADS)
    fold_kernel(F f, const typename F::word* __restrict__ t, const typename F::word* __restrict__ rs,
                long long points, int k, int n, int ct_log, int s, int c, int mb, typename F::word* __restrict__ out,
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
  const long long zchunks = (points + PB - 1) / PB;
  for (long long zc = blockIdx.z; zc < zchunks; zc += gridDim.z) {
    const long long p0 = zc * PB;
    const int np = points - p0 < PB ? (int)(points - p0) : PB;
    // the middle factors: mid[q 2^mb + h], bit b of h is coordinate s + mb - 1 - b
    for (int e = threadIdx.x; e < (np << mb); e += THREADS)
      mid[e] = eq_factor(f, rs + (p0 + (e >> mb)) * k, s + mb - 1, mb, e & ((1 << mb) - 1));
    __syncthreads();
    typename F::Acc acc[PB];
#pragma unroll
    for (int q = 0; q < PB; ++q) acc[q] = {};
    if (active) {
#pragma unroll 4
      for (int h = 0; h < (1 << mb); ++h) {
        const W x = src[((long long)h << c) * M];
#pragma unroll
        for (int q = 0; q < PB; ++q)
          if (q < np) f.acc_add(acc[q], mid[(q << mb) | h], x);
      }
    }
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      if (q >= np) break;
      const W* r = rs + (p0 + q) * k;
      // the lane's low c bits: bit b is coordinate k - 1 - b
      red[threadIdx.x] = active ? f.mul(f.acc_reduce(acc[q]), eq_factor(f, r, k - 1, c, lane)) : W(0);
      __syncthreads();
      lane_sum(f, red, lanes, ct_log);
      if (threadIdx.x < (1 << ct_log)) {
        // the chunk's top s bits: bit b of y is coordinate s - 1 - b
        const W v = f.mul(red[threadIdx.x], eq_factor(f, r, s - 1, s, y));
        if (s == 0) out[(p0 + q) * M + j] = v;
        else partial[((p0 + q) * S + y) * M + j] = v;
      }
      __syncthreads();
    }
    if (s > 0) {
      __threadfence();
      __syncthreads();
      int* ticket = tickets + zc * gridDim.x + blockIdx.x;
      if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == (int)(S - 1);
      __syncthreads();
      if (last) {
        __threadfence();
        for (int q = 0; q < np; ++q) {
          W v = 0;
          for (long long yy = lane; yy < S; yy += lanes) {
            v = f.add(v, ldcg(partial + ((p0 + q) * S + yy) * M + j));
          }
          red[threadIdx.x] = v;
          __syncthreads();
          lane_sum(f, red, lanes, ct_log);
          if (threadIdx.x < (1 << ct_log)) out[(p0 + q) * M + j] = red[threadIdx.x];
          __syncthreads();
        }
        if (threadIdx.x == 0) *ticket = 0;
      }
    }
    __syncthreads();
  }
}

template <class F>
int fold_launch(F f, int pb, const void* t, const void* rs, long long points, int k, int n, int ct_log, int s, int c,
                int mb, void* out, void* partial, void* tickets, cudaStream_t st) {
  using W = typename F::word;
  const long long zchunks = (points + pb - 1) / pb;
  const dim3 grid((unsigned)(1ll << (n - k - ct_log)), (unsigned)(1u << s),
                  (unsigned)(zchunks < 65535 ? zchunks : 65535));
  const W* tw = static_cast<const W*>(t);
  const W* rw = static_cast<const W*>(rs);
  W* o = static_cast<W*>(out);
  W* pa = static_cast<W*>(partial);
  int* tk = static_cast<int*>(tickets);
  if (pb == 1)
    fold_kernel<F, 1><<<grid, THREADS, 0, st>>>(f, tw, rw, points, k, n, ct_log, s, c, mb, o, pa, tk);
  else
    fold_kernel<F, 4><<<grid, THREADS, 0, st>>>(f, tw, rw, points, k, n, ct_log, s, c, mb, o, pa, tk);
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

// The fold of t's first k variables (t: 2^n words) at `points` points
// (rs: points x k words), out: points x 2^(n-k) words, pb = 1 (one point)
// or 4 (a batch) points per block; the plan ct_log, s, c, mb as
// ops/mle_kernel.plan makes it. With s > 0, partial holds points x 2^s x
// 2^(n-k) words and tickets one int per tile and point chunk, all 0 (and 0
// again after the kernel). mont32 = 0 takes Goldilocks words; mont32 = 1
// Montgomery words of the field with modulus p < 2^31 and pinv = -p^-1 mod
// 2^32.
extern "C" int ts_fold_launch(int mont32, unsigned p, unsigned pinv, int pb, const void* t, const void* rs,
                              long long points, int k, int n, int ct_log, int s, int c, int mb, void* out,
                              void* partial, void* tickets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((pb != 1 && pb != 4) || points < 1 || k < 1 || k > n || ct_log < 0 || ct_log > 8 || ct_log > n - k || s < 0 ||
      s > 15 || c < 0 || c > 8 - ct_log || mb < 0 || (pb << mb) > MID_WORDS || s + c + mb != k)
    return (int)cudaErrorInvalidValue;
  if (mont32) return fold_launch(M32Ops{{p, pinv}}, pb, t, rs, points, k, n, ct_log, s, c, mb, out, partial, tickets, st);
  return fold_launch(GlOps{}, pb, t, rs, points, k, n, ct_log, s, c, mb, out, partial, tickets, st);
}
