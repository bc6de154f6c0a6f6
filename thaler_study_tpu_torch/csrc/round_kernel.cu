// Fused sumcheck round (fold + round sums) for a batch of single-block
// product polynomials, over Goldilocks or a mont32 field (p < 2^31).
//
// Replaces: thaler_study_tpu/ops/pallas_round.py, _make_kernel (the
// pl.pallas_call at :341), which computes one round of one proof for a
// k-factor product in either field (_field_ops :71-109); this kernel
// computes it for B proofs at once, k = 1 to 8 (MAX_K, the multi-block
// kernel's MAX_TABLES too), each proof with its own challenge. Its plain
// version is ops/cuda_round.round_partials_plain. libra_round_kernel (below) is the
// same pass for the two multi-term shapes of the GKR layer sumcheck
// (gkr/linear.py's LibraW phases), which the Pallas kernel does not take
// (pallas_round.py:403-404: the JAX package runs them in XLA).
//
// What it computes, for each proof b and factor tables T_f[b] of n entries
// (MSB-first, so the round variable splits each table in halves):
//   FOLD:  f = T[:n/2] + r[b] * (T[n/2:] - T[:n/2]), written to out_f[b]
//          (never in place: the caller's tables stay unchanged); the sums
//          then run over f's halves. Without FOLD they run over T's halves.
//   sums:  s(t) = sum_x prod_f (lo_f[x] + t * (hi_f[x] - lo_f[x])),
//          t = 0..D with D = K (a single factor: s(t) = sum_x of the
//          factor at t). SKIP1 leaves s(1) out (written as 0): the
//          caller knows the round claim c and sets s(1) = c - s(0).
// Each block writes one partial per t to partials[b][block][t]; the
// per-block partials are summed mod p by the caller (the FS tail kernel,
// or torch for a single round). Modular addition is exact, so the order
// of the sums cannot change a bit. mont32 words stay Montgomery throughout:
// the partials are the Montgomery words of the sums. libra_round_kernel
// (K1) can finish its round in its last block instead: the sums s(0..2)
// with the claim's s(1), or on the fused GKR path the GKR round tail
// (TAIL, tail_epilogue below; csrc/gkr_tail.cuh), so that a round is one
// launch.
//
// What bounds it on the H100: device memory. A FOLD round reads 2 x 4 and
// writes 2 x 2 words per table per quarter index, 8 or 4 bytes each; the
// arithmetic is a few 64-bit multiplies per element. So each thread
// streams its element indices with neighbouring threads on neighbouring
// addresses (coalesced loads), folds and sums in registers, and keeps the
// sums as unreduced accumulators: 192-bit sums of 128-bit products for
// Goldilocks, 128-bit sums of raw 64-bit Montgomery products for mont32
// (one modular reduction per thread per t, not per product; for mont32
// four REDCs, no division; the Pallas kernel's _lane_reduce_words does the
// same per tile). The TPU kernel's sequential-grid accumulator has no
// counterpart: blocks run in parallel and reduce their threads' sums in
// shared memory.
#include <cuda_runtime.h>

#include "gkr_tail.cuh"
#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int THREADS = 256;

// The field as the kernel sees it: one word type, fold/add/sub/mul, and an
// accumulator of unreduced products.
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
  __device__ __forceinline__ word one() const { return 1; }
};

struct M32Ops : m32::Field {
  using word = uint32_t;
  using Acc = m32::Acc;
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const {
    m32::acc_add(acc, (uint64_t)a * b);
  }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return m32::acc_reduce(*this, acc); }
  __device__ __forceinline__ word one() const { return r1; }  // the Montgomery word of 1
};

__device__ __forceinline__ uint32_t shfl_xor(uint32_t x, int off) {
  return __shfl_xor_sync(0xffffffffu, x, off);
}
__device__ __forceinline__ uint64_t shfl_xor(uint64_t x, int off) {
  return (uint64_t)__shfl_xor_sync(0xffffffffu, (unsigned long long)x, off);
}

// x[0..N-1] summed over the block's threads, in every thread
template <class F, int N>
__device__ __forceinline__ void block_sum(const F& f, typename F::word (&x)[N]) {
  using W = typename F::word;
  __shared__ W warp_sums[THREADS / 32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < N; ++e) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x[e] = f.add(x[e], shfl_xor(x[e], off));
    if (lane == 0) warp_sums[warp][e] = x[e];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < N; ++e) {
    x[e] = warp_sums[0][e];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) x[e] = f.add(x[e], warp_sums[w][e]);
  }
  __syncthreads();  // warp_sums free for the next call
}

constexpr int MAX_K = 8;

template <class W, int K>
struct Tables {
  const W* in[K];
  W* out[K];
};

// the product of v[0..K-1] into the lazy accumulator: K - 2 reduced
// products and one raw one; a single factor enters as a product with the
// field's one (so that every raw product has the same Montgomery scale)
template <class F, int K>
__device__ __forceinline__ void add_product(const F& f, typename F::Acc& acc,
                                            const typename F::word (&v)[K]) {
  if constexpr (K == 1) {
    f.acc_add(acc, v[0], f.one());
  } else {
    typename F::word a = v[0];
#pragma unroll
    for (int i = 1; i < K - 1; ++i) a = f.mul(a, v[i]);
    f.acc_add(acc, a, v[K - 1]);
  }
}

// grid = (blocks, B). Block x of proof b covers pair indices
// [x * chunk, min((x + 1) * chunk, half)), its threads striding by THREADS.
template <class F, int K, bool FOLD, bool SKIP1>
__global__ void __launch_bounds__(THREADS)
    round_kernel(F f, Tables<typename F::word, K> t, const typename F::word* __restrict__ r,
                 typename F::word* __restrict__ partials, long long n, long long chunk) {
  using W = typename F::word;
  constexpr int D = K;
  const long long b = blockIdx.y;
  const long long half = FOLD ? n / 4 : n / 2;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < half ? begin + chunk : half;
  const W rb = FOLD ? r[b] : 0;

  typename F::Acc acc[D + 1];
#pragma unroll
  for (int s = 0; s <= D; ++s) acc[s] = typename F::Acc{};

  for (long long i = begin + threadIdx.x; i < end; i += THREADS) {
    W lo[K], hi[K];
#pragma unroll
    for (int g = 0; g < K; ++g) {
      const W* src = t.in[g] + b * n;
      if (FOLD) {
        // quarters q0..q3 of T: f_lo = fold(q0, q2), f_hi = fold(q1, q3)
        lo[g] = f.fold(src[i], src[i + 2 * half], rb);
        hi[g] = f.fold(src[i + half], src[i + 3 * half], rb);
        W* dst = t.out[g] + b * (n / 2);
        dst[i] = lo[g];
        dst[i + half] = hi[g];
      } else {
        lo[g] = src[i];
        hi[g] = src[i + half];
      }
    }
    add_product<F, K>(f, acc[0], lo);
    if (!SKIP1) add_product<F, K>(f, acc[1], hi);
    W v[K], delta[K];
#pragma unroll
    for (int g = 0; g < K; ++g) {
      delta[g] = f.sub(hi[g], lo[g]);
      v[g] = hi[g];
    }
#pragma unroll
    for (int s = 2; s <= D; ++s) {
#pragma unroll
      for (int g = 0; g < K; ++g) v[g] = f.add(v[g], delta[g]);
      add_product<F, K>(f, acc[s], v);
    }
  }

  W sums[D + 1];
#pragma unroll
  for (int s = 0; s <= D; ++s) sums[s] = f.acc_reduce(acc[s]);
  block_sum<F, D + 1>(f, sums);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s <= D; ++s) partials[(b * gridDim.x + blockIdx.x) * (D + 1) + s] = sums[s];
  }
}

// ---- the LibraW shapes (GKR layer sumcheck, gkr/linear.py): K1 ------------
//
// Three folded tables T0, T1, T2 and, in phase 2, one scalar s per proof
// (w_u = W~(u), a 0-block table: never folded, broadcast to every x):
//   PHASE 1: g = T0 T1 + T2            terms ((0, 1), (2,)): W A1 + A2
//   PHASE 2: g = T0 s + T0 T2 + T1 s T2
//            terms ((0, 3), (0, 2), (1, 3, 2)): B1 w_u + B1 Wc + B2 w_u Wc
// Both are degree 2: s(t), t = 0, 1, 2, with the single-factor term T2 of
// phase 1 evaluated at t = 2 like every other. Term membership is compiled
// in (one instantiation per shape, not run-time bitmasks): only these two
// shapes are on the path, and fixed terms leave no per-element branch.
// Each term's products go into the same lazy accumulator; a single-factor
// term enters as a product with the field's one (Goldilocks 1, mont32
// R mod p, so the raw product is R^2 x like every other).
//
// The grid (ops/cuda_round.libra_blocks): at most one wave of blocks, one
// block for tables of up to 2^10 entries; block x of proof b owns the pair
// indices [x * chunk, min((x + 1) * chunk, half)), the plain version's
// split. Its threads walk the range in 16-byte groups (four mont32 or two
// Goldilocks words per table and quarter: 12 loads and, folding, 6 stores
// of 16 bytes per group, all loads issued before the first store),
// neighbouring threads on neighbouring groups; the entries before the
// range's first whole group and after its last go one at a time, and so
// does the whole range where the wrapper clears `vec` (a half below one
// group, tables not 16-byte aligned). Each thread reduces its lazy
// accumulators once per t: for mont32 four REDCs (m32::acc_reduce), no
// 64-bit division. Every block writes its partial sums; with `sums` given,
// the last block (a ticket counter, 0 between launches) adds every block's
// partials and writes s(0..2) per proof, s(1) = claim - s(0) where a claim
// is given, so that a round is one launch. The TAIL form (Goldilocks, one
// proof) runs the GKR round tail on those sums instead.
template <class F, int PHASE>
__device__ __forceinline__ void add_libra(const F& f, typename F::Acc& acc,
                                          const typename F::word (&v)[3], typename F::word s) {
  if (PHASE == 1) {
    f.acc_add(acc, v[0], v[1]);
    f.acc_add(acc, v[2], f.one());
  } else {
    f.acc_add(acc, v[0], f.add(s, v[2]));  // T0 s + T0 T2
    f.acc_add(acc, f.mul(v[1], s), v[2]);  // T1 s T2
  }
}

// One pair index: the three tables' (folded) values lo and hi into s(0),
// s(1) (left out with SKIP1) and s(2).
template <class F, int PHASE, bool SKIP1>
__device__ __forceinline__ void add_point(const F& f, typename F::Acc (&acc)[3], const typename F::word (&lo)[3],
                                          const typename F::word (&hi)[3], typename F::word s) {
  add_libra<F, PHASE>(f, acc[0], lo, s);
  if (!SKIP1) add_libra<F, PHASE>(f, acc[1], hi, s);
  typename F::word v2[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) v2[g] = f.add(hi[g], f.sub(hi[g], lo[g]));
  add_libra<F, PHASE>(f, acc[2], v2, s);
}

// 16 bytes of words: one vector load or store
template <class W>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(W);
  W w[N];
};

__device__ __forceinline__ uint32_t ldcg(const uint32_t* p) { return __ldcg(p); }
__device__ __forceinline__ uint64_t ldcg(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

// Thread 0 makes the block's writes visible device-wide (one fence) and
// takes a ticket; true in every thread of the grid's last block.
__device__ __forceinline__ bool last_block(int* counter, unsigned blocks) {
  __shared__ int last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == (int)blocks - 1;
  }
  __syncthreads();
  return last;
}

// Proof b's sums over its `blocks` partials (read from L2), in every thread
template <class F>
__device__ __forceinline__ void grid_sums(const F& f, const typename F::word* partials, long long b, int blocks,
                                          typename F::word (&s)[3]) {
#pragma unroll
  for (int e = 0; e < 3; ++e) s[e] = 0;
  for (int x = threadIdx.x; x < blocks; x += THREADS) {
#pragma unroll
    for (int e = 0; e < 3; ++e) s[e] = f.add(s[e], ldcg(partials + (b * blocks + x) * 3 + e));
  }
  block_sum<F, 3>(f, s);
}

// Where a launch's sums go: partials[b][block][3] always; with `sums`,
// s(0..2) per proof ([b][3]) from the last block, counter its ticket and
// claim null or [batch] words.
template <class W>
struct LibraOut {
  W* partials;
  W* sums;
  const W* claim;
  int* counter;
};

template <class F>
__device__ __forceinline__ void write_sums(const F& f, const LibraOut<typename F::word>& o, long long b,
                                           const typename F::word (&s)[3]) {
  typename F::word* out = o.sums + 3 * b;
  out[0] = s[0];
  out[1] = o.claim ? f.sub(o.claim[b], s[0]) : s[1];
  out[2] = s[2];
}

// The GKR round tail as the epilogue of a TAIL launch (Goldilocks, one
// proof): the last block (or a grid's only block) has the round sums, and
// one warp runs gkr_tail::round_tail on them; the chain's inputs were
// copied into `in` when the block started. The fence and the ticket hold
// each block a little longer, which a grid of one wave pays once.
template <class F>
__device__ __forceinline__ void tail_epilogue(const F& f, const uint64_t* partials, uint64_t (&s)[3],
                                              const gkr_tail::RoundArgs& t, const gkr_tail::ChainIn& in) {
  __pipeline_wait_prior(0);
  __syncthreads();
  if (gridDim.x > 1) {
    if (!last_block(t.counter, gridDim.x)) return;
    grid_sums(f, partials, 0, gridDim.x, s);
    if (threadIdx.x == 0) *t.counter = 0;
  }
  if (threadIdx.x < 32) gkr_tail::round_tail(s, in, t);
}

template <class F, int PHASE, bool FOLD, bool SKIP1, bool TAIL>
__global__ void __launch_bounds__(THREADS)
    libra_round_kernel(F f, Tables<typename F::word, 3> t, const typename F::word* __restrict__ r,
                       const typename F::word* __restrict__ scalar, LibraOut<typename F::word> o, long long n,
                       long long chunk, int vec, gkr_tail::RoundArgs tail) {
  using W = typename F::word;
  using P = Pack<W>;
  constexpr int V = P::N;
  __shared__ gkr_tail::ChainIn chain_in;
  if constexpr (TAIL) gkr_tail::load_chain_async(chain_in, tail);
  const long long b = blockIdx.y;
  const long long half = FOLD ? n / 4 : n / 2;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < half ? begin + chunk : half;
  const W rb = FOLD ? r[b] : 0;
  const W s = PHASE == 2 ? scalar[b] : 0;
  const W* src[3];
  W* dst[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    src[g] = t.in[g] + b * n;
    dst[g] = FOLD ? t.out[g] + b * (n / 2) : nullptr;
  }

  typename F::Acc acc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) acc[j] = typename F::Acc{};

  const auto one_point = [&](long long i) {
    W lo[3], hi[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      if (FOLD) {
        // quarters q0..q3 of T: f_lo = fold(q0, q2), f_hi = fold(q1, q3)
        lo[g] = f.fold(src[g][i], src[g][i + 2 * half], rb);
        hi[g] = f.fold(src[g][i + half], src[g][i + 3 * half], rb);
        dst[g][i] = lo[g];
        dst[g][i + half] = hi[g];
      } else {
        lo[g] = src[g][i];
        hi[g] = src[g][i + half];
      }
    }
    add_point<F, PHASE, SKIP1>(f, acc, lo, hi, s);
  };

  // the range's whole groups [vb, ve), and the entries around them
  long long vb = end, ve = end;
  if (vec) {
    vb = (begin + V - 1) / V * V;
    vb = vb < end ? vb : end;
    ve = end / V * V;
    ve = ve > vb ? ve : vb;
  }
  for (long long i = begin + threadIdx.x; i < vb; i += THREADS) one_point(i);
  for (long long i = ve + threadIdx.x; i < end; i += THREADS) one_point(i);
  const long long hq = half / V;  // a quarter in groups
  for (long long q = vb / V + threadIdx.x; q < ve / V; q += THREADS) {
    P lo[3], hi[3];
    if (FOLD) {
      P x[3][4];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int h = 0; h < 4; ++h) x[g][h] = reinterpret_cast<const P*>(src[g])[q + h * hq];
      }
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          lo[g].w[j] = f.fold(x[g][0].w[j], x[g][2].w[j], rb);
          hi[g].w[j] = f.fold(x[g][1].w[j], x[g][3].w[j], rb);
        }
        reinterpret_cast<P*>(dst[g])[q] = lo[g];
        reinterpret_cast<P*>(dst[g])[q + hq] = hi[g];
      }
    } else {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        lo[g] = reinterpret_cast<const P*>(src[g])[q];
        hi[g] = reinterpret_cast<const P*>(src[g])[q + hq];
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const W l[3] = {lo[0].w[j], lo[1].w[j], lo[2].w[j]};
      const W h[3] = {hi[0].w[j], hi[1].w[j], hi[2].w[j]};
      add_point<F, PHASE, SKIP1>(f, acc, l, h, s);
    }
  }

  W sums[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) sums[j] = f.acc_reduce(acc[j]);
  block_sum<F, 3>(f, sums);
  if (threadIdx.x == 0) {
    W* part = o.partials + (b * gridDim.x + blockIdx.x) * 3;
    part[0] = sums[0];
    part[1] = sums[1];
    part[2] = sums[2];
  }
  if constexpr (TAIL) {
    tail_epilogue(f, o.partials, sums, tail, chain_in);
  } else if (o.sums) {
    if (gridDim.x == 1) {
      if (threadIdx.x == 0) write_sums(f, o, b, sums);
      return;
    }
    if (!last_block(o.counter, gridDim.x * gridDim.y)) return;
    for (long long pb = 0; pb < gridDim.y; ++pb) {
      grid_sums(f, o.partials, pb, gridDim.x, sums);
      if (threadIdx.x == 0) write_sums(f, o, pb, sums);
    }
    if (threadIdx.x == 0) *o.counter = 0;
  }
}

template <class F>
using LibraKernel = void (*)(F, Tables<typename F::word, 3>, const typename F::word*, const typename F::word*,
                             LibraOut<typename F::word>, long long, long long, int, gkr_tail::RoundArgs);

// The instantiation for (phase, fold, skip_t1), or null for a phase other
// than 1 and 2.
template <class F, bool TAIL>
LibraKernel<F> libra_kernel(int phase, int fold, int skip_t1) {
  if (phase == 1) {
    if (fold) return skip_t1 ? libra_round_kernel<F, 1, true, true, TAIL> : libra_round_kernel<F, 1, true, false, TAIL>;
    return skip_t1 ? libra_round_kernel<F, 1, false, true, TAIL> : libra_round_kernel<F, 1, false, false, TAIL>;
  }
  if (phase == 2) {
    if (fold) return skip_t1 ? libra_round_kernel<F, 2, true, true, TAIL> : libra_round_kernel<F, 2, true, false, TAIL>;
    return skip_t1 ? libra_round_kernel<F, 2, false, true, TAIL> : libra_round_kernel<F, 2, false, false, TAIL>;
  }
  return nullptr;
}

template <class F, bool TAIL>
int launch_libra(const F& f, int phase, int fold, int skip_t1, const void* const* in, void* const* out,
                 const void* r, const void* scalar, const LibraOut<typename F::word>& o, long long batch, long long n,
                 int blocks, long long chunk, int vec, const gkr_tail::RoundArgs& tail, cudaStream_t stream) {
  using W = typename F::word;
  const LibraKernel<F> kernel = libra_kernel<F, TAIL>(phase, fold, skip_t1);
  if (!kernel) return (int)cudaErrorInvalidValue;
  Tables<W, 3> t;
  for (int g = 0; g < 3; ++g) {
    t.in[g] = static_cast<const W*>(in[g]);
    t.out[g] = static_cast<W*>(out[g]);
  }
  kernel<<<dim3(blocks, (unsigned)batch), THREADS, 0, stream>>>(f, t, static_cast<const W*>(r),
                                                                 static_cast<const W*>(scalar), o, n, chunk, vec,
                                                                 tail);
  return 0;
}

// Blocks of one wave of an instantiation on the current device: its SMs
// times the blocks of that kernel resident on one SM; -1 on an error.
template <class F, bool TAIL>
int libra_wave(int phase, int fold, int skip_t1) {
  const LibraKernel<F> kernel = libra_kernel<F, TAIL>(phase, fold, skip_t1);
  int device = 0, sms = 0, per_sm = 0;
  if (!kernel || cudaGetDevice(&device) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0))
    return -1;
  return sms * per_sm;
}

template <class F, int K, bool FOLD, bool SKIP1>
void launch(const F& f, const void* const* in, void* const* out, const void* r, void* partials,
            long long batch, long long n, int blocks, long long chunk, cudaStream_t stream) {
  using W = typename F::word;
  Tables<W, K> t;
  for (int g = 0; g < K; ++g) {
    t.in[g] = static_cast<const W*>(in[g]);
    t.out[g] = FOLD ? static_cast<W*>(out[g]) : nullptr;
  }
  dim3 grid(blocks, (unsigned)batch);
  round_kernel<F, K, FOLD, SKIP1><<<grid, THREADS, 0, stream>>>(
      f, t, static_cast<const W*>(r), static_cast<W*>(partials), n, chunk);
}

template <class F, int K>
void launch_k(const F& f, int fold, int skip_t1, const void* const* in, void* const* out,
              const void* r, void* partials, long long batch, long long n, int blocks,
              long long chunk, cudaStream_t s) {
  if (fold && skip_t1) launch<F, K, true, true>(f, in, out, r, partials, batch, n, blocks, chunk, s);
  else if (fold) launch<F, K, true, false>(f, in, out, r, partials, batch, n, blocks, chunk, s);
  else if (skip_t1) launch<F, K, false, true>(f, in, out, r, partials, batch, n, blocks, chunk, s);
  else launch<F, K, false, false>(f, in, out, r, partials, batch, n, blocks, chunk, s);
}

// the instantiation for k among K, K + 1, ..., MAX_K
template <class F, int K = 1>
int launch_field(const F& f, int k, int fold, int skip_t1, const void* const* in,
                 void* const* out, const void* r, void* partials, long long batch, long long n,
                 int blocks, long long chunk, cudaStream_t s) {
  if (k == K) {
    launch_k<F, K>(f, fold, skip_t1, in, out, r, partials, batch, n, blocks, chunk, s);
    return 0;
  }
  if constexpr (K < MAX_K) {
    return launch_field<F, K + 1>(f, k, fold, skip_t1, in, out, r, partials, batch, n, blocks, chunk, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). mont32 = 0
// takes Goldilocks int64 words; mont32 = 1 takes Montgomery words of the
// field with modulus p < 2^31 and pinv = -p^-1 mod 2^32. in: k table
// pointers, 1 <= k <= 8; out: k output pointers when folding (else
// ignored). The wrapper checks every argument first.
extern "C" int ts_round_launch(int mont32, unsigned p, unsigned pinv, int k, int fold, int skip_t1,
                               const void* const* in, void* const* out, const void* r, void* partials,
                               long long batch, long long n, int blocks, long long chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = mont32 ? launch_field(M32Ops{{p, pinv}}, k, fold, skip_t1, in, out, r, partials,
                                       batch, n, blocks, chunk, s)
                        : launch_field(GlOps{}, k, fold, skip_t1, in, out, r, partials, batch, n,
                                       blocks, chunk, s);
  return rc ? rc : (int)cudaGetLastError();
}

// The LibraW shapes (phase = 1 or 2, see libra_round_kernel): three input
// tables, three outputs when folding, scalar = the [batch] phase-2 scalars
// (null in phase 1); partials are [batch][blocks][3], and with sums (else
// null) [batch][3] the round's s(0..2), claim null or [batch] words,
// counter one int that is 0 (and is 0 again after the kernel). vec = 1:
// every table 16-byte aligned and half a multiple of 16 bytes' words.
// Returns as above.
extern "C" int ts_libra_round_launch(int mont32, unsigned p, unsigned pinv, int phase, int fold,
                                     int skip_t1, const void* in0, const void* in1, const void* in2,
                                     void* out0, void* out1, void* out2, const void* r,
                                     const void* scalar, void* partials, void* sums, const void* claim,
                                     void* counter, long long batch, long long n, int blocks, long long chunk,
                                     int vec, void* stream) {
  const void* in[3] = {in0, in1, in2};
  void* out[3] = {out0, out1, out2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const gkr_tail::RoundArgs none{};
  int* ticket = static_cast<int*>(counter);
  int rc;
  if (mont32) {
    const LibraOut<uint32_t> o{static_cast<uint32_t*>(partials), static_cast<uint32_t*>(sums),
                               static_cast<const uint32_t*>(claim), ticket};
    rc = launch_libra<M32Ops, false>(M32Ops{{p, pinv}}, phase, fold, skip_t1, in, out, r, scalar, o, batch, n,
                                     blocks, chunk, vec, none, s);
  } else {
    const LibraOut<uint64_t> o{static_cast<uint64_t*>(partials), static_cast<uint64_t*>(sums),
                               static_cast<const uint64_t*>(claim), ticket};
    rc = launch_libra<GlOps, false>(GlOps{}, phase, fold, skip_t1, in, out, r, scalar, o, batch, n, blocks, chunk,
                                    vec, none, s);
  }
  return rc ? rc : (int)cudaGetLastError();
}

// Blocks of one wave of the instantiation (mont32, phase, fold, skip_t1,
// tail) on the current device; tail = 1 only with mont32 = 0. Returns -1
// on a CUDA error or a phase other than 1 and 2.
extern "C" int ts_libra_wave_blocks(int mont32, int phase, int fold, int skip_t1, int tail) {
  if (tail) return mont32 ? -1 : libra_wave<GlOps, true>(phase, fold, skip_t1);
  return mont32 ? libra_wave<M32Ops, false>(phase, fold, skip_t1) : libra_wave<GlOps, false>(phase, fold, skip_t1);
}

// The LibraW shapes over Goldilocks for one proof (batch 1) with the GKR
// round tail as the launch's epilogue (TAIL; gkr_tail.cuh, RoundArgs):
// the same partials as ts_libra_round_launch, then the tail's outputs.
// counter must be 0 (the last block leaves it 0). Returns as above.
extern "C" int ts_libra_round_tail_launch(int phase, int fold, int skip_t1, const void* in0, const void* in1,
                                          const void* in2, void* out0, void* out1, void* out2, const void* r,
                                          const void* scalar, void* partials, long long n, int blocks,
                                          long long chunk, int vec, void* counter, void* state, void* buf,
                                          long long nbytes, void* msg, void* zero, void* claim, void* chal,
                                          int chal_idx, int draws, int start, long long layer, int k,
                                          void* stream) {
  if (draws != 1 && draws != 2) return (int)cudaErrorInvalidValue;
  const void* in[3] = {in0, in1, in2};
  void* out[3] = {out0, out1, out2};
  const gkr_tail::RoundArgs tail{static_cast<int*>(counter), static_cast<uint32_t*>(state),
                                 static_cast<uint8_t*>(buf), nbytes, static_cast<uint8_t*>(msg),
                                 static_cast<int*>(zero), static_cast<uint64_t*>(claim),
                                 static_cast<uint64_t*>(chal), chal_idx, draws, start, k, layer};
  const LibraOut<uint64_t> o{static_cast<uint64_t*>(partials), nullptr, nullptr, static_cast<int*>(counter)};
  const int rc = launch_libra<GlOps, true>(GlOps{}, phase, fold, skip_t1, in, out, r, scalar, o, 1, n, blocks,
                                           chunk, vec, tail, static_cast<cudaStream_t>(stream));
  return rc ? rc : (int)cudaGetLastError();
}
