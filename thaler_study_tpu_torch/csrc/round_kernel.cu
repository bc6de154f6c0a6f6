// Fused sumcheck round (fold + round sums) for a batch of single-block
// product polynomials, over Goldilocks or a mont32 field (p < 2^31).
//
// Replaces: thaler_study_tpu/ops/pallas_round.py, _make_kernel (the
// pl.pallas_call at :341), which computes one round of one proof for a
// k-factor product in either field (_field_ops :71-109); this kernel
// computes it for B proofs at once, k = 2 or 3. Its plain version is
// ops/cuda_round.round_partials_plain. libra_round_kernel (below) is the
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
//          t = 0..D with D = K. SKIP1 leaves s(1) out (written as 0): the
//          caller knows the round claim c and sets s(1) = c - s(0).
// Each block writes one partial per t to partials[b][block][t]; the
// per-block partials are summed mod p by the caller (the FS tail kernel,
// or torch for a single round). Modular addition is exact, so the order
// of the sums cannot change a bit. mont32 words stay Montgomery throughout:
// the partials are the Montgomery words of the sums. On the fused GKR path
// libra_round_kernel also runs the GKR round tail on them in its last
// block (TAIL, tail_epilogue below; csrc/gkr_tail.cuh), so that a round
// is one launch.
//
// What bounds it on the H100: device memory. A FOLD round reads 2 x 4 and
// writes 2 x 2 words per table per quarter index, 8 or 4 bytes each; the
// arithmetic is a few 64-bit multiplies per element. So each thread
// streams its element indices with neighbouring threads on neighbouring
// addresses (coalesced loads), folds and sums in registers, and keeps the
// sums as unreduced accumulators: 192-bit sums of 128-bit products for
// Goldilocks, 128-bit sums of raw 64-bit Montgomery products for mont32
// (one modular reduction, and for mont32 one REDC, per thread per t, not
// per product; the Pallas kernel's _lane_reduce_words does the same per
// tile). The TPU kernel's sequential-grid accumulator has no counterpart:
// blocks run in parallel and reduce their threads' sums in shared memory.
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
};

struct M32Ops : m32::Field {
  using word = uint32_t;
  using Acc = m32::Acc;
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const {
    m32::acc_add(acc, (uint64_t)a * b);
  }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return m32::acc_reduce(*this, acc); }
};

__device__ __forceinline__ uint32_t shfl_down(uint32_t x, int off) {
  return __shfl_down_sync(0xffffffffu, x, off);
}
__device__ __forceinline__ uint64_t shfl_down(uint64_t x, int off) {
  return (uint64_t)__shfl_down_sync(0xffffffffu, (unsigned long long)x, off);
}

template <class W, int K>
struct Tables {
  const W* in[K];
  W* out[K];
};

template <class F, int K>
__device__ __forceinline__ void add_product(const F& f, typename F::Acc& acc,
                                            const typename F::word (&v)[K]) {
  typename F::word a = v[0];
#pragma unroll
  for (int i = 1; i < K - 1; ++i) a = f.mul(a, v[i]);
  f.acc_add(acc, a, v[K - 1]);
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

  __shared__ W warp_sums[THREADS / 32][D + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s <= D; ++s) {
    W x = f.acc_reduce(acc[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = f.add(x, shfl_down(x, off));
    if (lane == 0) warp_sums[warp][s] = x;
  }
  __syncthreads();
  if (threadIdx.x <= D) {
    W total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total = f.add(total, warp_sums[w][threadIdx.x]);
    partials[(b * gridDim.x + blockIdx.x) * (D + 1) + threadIdx.x] = total;
  }
}

// ---- the LibraW shapes (GKR layer sumcheck, gkr/linear.py) ----------------
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
template <class F, int PHASE>
__device__ __forceinline__ void add_libra(const F& f, typename F::Acc& acc,
                                          const typename F::word (&v)[3], typename F::word s,
                                          typename F::word one) {
  if (PHASE == 1) {
    f.acc_add(acc, v[0], v[1]);
    f.acc_add(acc, v[2], one);
  } else {
    f.acc_add(acc, v[0], f.add(s, v[2]));  // T0 s + T0 T2
    f.acc_add(acc, f.mul(v[1], s), v[2]);  // T1 s T2
  }
}

// The GKR round tail as the epilogue of a libra_round_kernel launch (TAIL,
// Goldilocks, batch 1): each block has written its partials (and
// block_sums, the same three words, to shared memory); thread 0 makes the
// block's writes visible device-wide (one fence, after the barrier) and
// takes a ticket. The last block resets the counter, sums every block's
// partials (read from L2) with all its threads, and one warp runs
// gkr_tail::round_tail on the round sums; the chain's inputs were copied
// into `in` when the block started. A grid of one block (the rounds over
// tables of up to 2^10 entries) skips the ticket and takes its own sums.
// The fence and the ticket hold each block a little longer, so the
// wrapper launches one wave of blocks (ts_libra_round_tail_blocks) and
// pays them once.
__device__ __forceinline__ void tail_epilogue(const uint64_t* partials, const uint64_t* block_sums,
                                              const gkr_tail::RoundArgs& t, const gkr_tail::ChainIn& in) {
  __shared__ int last;
  __shared__ uint64_t sums[THREADS / 32][3];
  __pipeline_wait_prior(0);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t s[3];
  if (gridDim.x == 1) {
    if (warp != 0) return;
#pragma unroll
    for (int e = 0; e < 3; ++e) s[e] = block_sums[e];
    gkr_tail::round_tail(s, in, t);
    return;
  }
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(t.counter, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int e = 0; e < 3; ++e) s[e] = 0;
  for (int x = threadIdx.x; x < (int)gridDim.x; x += THREADS) {
#pragma unroll
    for (int e = 0; e < 3; ++e)
      s[e] = gl::add(s[e], __ldcg(reinterpret_cast<const unsigned long long*>(partials) + 3 * x + e));
  }
#pragma unroll
  for (int e = 0; e < 3; ++e) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[e] = gl::add(s[e], __shfl_xor_sync(0xffffffffu, s[e], o));
    if (lane == 0) sums[warp][e] = s[e];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    s[e] = sums[0][e];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) s[e] = gl::add(s[e], sums[w][e]);
  }
  if (lane == 0) *t.counter = 0;
  gkr_tail::round_tail(s, in, t);
}

template <class F, int PHASE, bool FOLD, bool SKIP1, bool TAIL>
__global__ void __launch_bounds__(THREADS)
    libra_round_kernel(F f, Tables<typename F::word, 3> t, const typename F::word* __restrict__ r,
                       const typename F::word* __restrict__ scalar, typename F::word one,
                       typename F::word* __restrict__ partials, long long n, long long chunk,
                       gkr_tail::RoundArgs tail) {
  using W = typename F::word;
  constexpr int K = 3, D = 2;
  __shared__ gkr_tail::ChainIn chain_in;
  if constexpr (TAIL) gkr_tail::load_chain_async(chain_in, tail);
  const long long b = blockIdx.y;
  const long long half = FOLD ? n / 4 : n / 2;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < half ? begin + chunk : half;
  const W rb = FOLD ? r[b] : 0;
  const W s = PHASE == 2 ? scalar[b] : 0;

  typename F::Acc acc[D + 1];
#pragma unroll
  for (int j = 0; j <= D; ++j) acc[j] = typename F::Acc{};

  for (long long i = begin + threadIdx.x; i < end; i += THREADS) {
    W lo[K], hi[K];
#pragma unroll
    for (int g = 0; g < K; ++g) {
      const W* src = t.in[g] + b * n;
      if (FOLD) {
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
    add_libra<F, PHASE>(f, acc[0], lo, s, one);
    if (!SKIP1) add_libra<F, PHASE>(f, acc[1], hi, s, one);
    W v2[K];
#pragma unroll
    for (int g = 0; g < K; ++g) v2[g] = f.add(hi[g], f.sub(hi[g], lo[g]));
    add_libra<F, PHASE>(f, acc[2], v2, s, one);
  }

  __shared__ W warp_sums[THREADS / 32][D + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j <= D; ++j) {
    W x = f.acc_reduce(acc[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = f.add(x, shfl_down(x, off));
    if (lane == 0) warp_sums[warp][j] = x;
  }
  __syncthreads();
  __shared__ W block_sums[D + 1];
  if (threadIdx.x <= D) {
    W total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total = f.add(total, warp_sums[w][threadIdx.x]);
    partials[(b * gridDim.x + blockIdx.x) * (D + 1) + threadIdx.x] = total;
    if constexpr (TAIL) block_sums[threadIdx.x] = total;
  }
  if constexpr (TAIL) tail_epilogue(partials, block_sums, tail, chain_in);
}

template <class F, int PHASE, bool FOLD, bool SKIP1, bool TAIL>
void launch_libra(const F& f, const void* const* in, void* const* out, const void* r, const void* scalar,
                  typename F::word one, void* partials, long long batch, long long n, int blocks,
                  long long chunk, const gkr_tail::RoundArgs& tail, cudaStream_t stream) {
  using W = typename F::word;
  Tables<W, 3> t;
  for (int g = 0; g < 3; ++g) {
    t.in[g] = static_cast<const W*>(in[g]);
    t.out[g] = static_cast<W*>(out[g]);
  }
  dim3 grid(blocks, (unsigned)batch);
  libra_round_kernel<F, PHASE, FOLD, SKIP1, TAIL><<<grid, THREADS, 0, stream>>>(
      f, t, static_cast<const W*>(r), static_cast<const W*>(scalar), one, static_cast<W*>(partials), n,
      chunk, tail);
}

template <class F, int PHASE, bool TAIL>
void launch_libra_modes(const F& f, int fold, int skip_t1, const void* const* in, void* const* out,
                        const void* r, const void* scalar, typename F::word one, void* partials,
                        long long batch, long long n, int blocks, long long chunk,
                        const gkr_tail::RoundArgs& tail, cudaStream_t s) {
  if (fold && skip_t1)
    launch_libra<F, PHASE, true, true, TAIL>(f, in, out, r, scalar, one, partials, batch, n, blocks, chunk, tail, s);
  else if (fold)
    launch_libra<F, PHASE, true, false, TAIL>(f, in, out, r, scalar, one, partials, batch, n, blocks, chunk, tail, s);
  else if (skip_t1)
    launch_libra<F, PHASE, false, true, TAIL>(f, in, out, r, scalar, one, partials, batch, n, blocks, chunk, tail, s);
  else
    launch_libra<F, PHASE, false, false, TAIL>(f, in, out, r, scalar, one, partials, batch, n, blocks, chunk, tail, s);
}

template <class F, bool TAIL>
int launch_libra_field(const F& f, int phase, int fold, int skip_t1, const void* const* in, void* const* out,
                       const void* r, const void* scalar, typename F::word one, void* partials,
                       long long batch, long long n, int blocks, long long chunk,
                       const gkr_tail::RoundArgs& tail, cudaStream_t s) {
  if (phase == 1)
    launch_libra_modes<F, 1, TAIL>(f, fold, skip_t1, in, out, r, scalar, one, partials, batch, n, blocks, chunk,
                                   tail, s);
  else if (phase == 2)
    launch_libra_modes<F, 2, TAIL>(f, fold, skip_t1, in, out, r, scalar, one, partials, batch, n, blocks, chunk,
                                   tail, s);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <class F, int K, bool FOLD, bool SKIP1>
void launch(const F& f, const void* const* in, void* const* out, const void* r, void* partials,
            long long batch, long long n, int blocks, long long chunk, cudaStream_t stream) {
  using W = typename F::word;
  Tables<W, K> t;
  for (int g = 0; g < K; ++g) {
    t.in[g] = static_cast<const W*>(in[g]);
    t.out[g] = static_cast<W*>(out[g]);
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

template <class F>
int launch_field(const F& f, int k, int fold, int skip_t1, const void* const* in,
                 void* const* out, const void* r, void* partials, long long batch, long long n,
                 int blocks, long long chunk, cudaStream_t s) {
  if (k == 2) launch_k<F, 2>(f, fold, skip_t1, in, out, r, partials, batch, n, blocks, chunk, s);
  else if (k == 3) launch_k<F, 3>(f, fold, skip_t1, in, out, r, partials, batch, n, blocks, chunk, s);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). mont32 = 0
// takes Goldilocks int64 words; mont32 = 1 takes Montgomery words of the
// field with modulus p < 2^31 and pinv = -p^-1 mod 2^32. k must be 2 or 3
// (the wrapper checks every argument first). Unused pointers are null.
extern "C" int ts_round_launch(int mont32, unsigned p, unsigned pinv, int k, int fold, int skip_t1,
                               const void* in0, const void* in1, const void* in2, void* out0,
                               void* out1, void* out2, const void* r, void* partials,
                               long long batch, long long n, int blocks, long long chunk,
                               void* stream) {
  const void* in[3] = {in0, in1, in2};
  void* out[3] = {out0, out1, out2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = mont32 ? launch_field(M32Ops{{p, pinv}}, k, fold, skip_t1, in, out, r, partials,
                                       batch, n, blocks, chunk, s)
                        : launch_field(GlOps{}, k, fold, skip_t1, in, out, r, partials, batch, n,
                                       blocks, chunk, s);
  return rc ? rc : (int)cudaGetLastError();
}

// The LibraW shapes (phase = 1 or 2, see libra_round_kernel): three input
// tables, three outputs when folding, scalar = the [batch] phase-2 scalars
// (null in phase 1); partials are [batch][blocks][3]. Returns as above.
extern "C" int ts_libra_round_launch(int mont32, unsigned p, unsigned pinv, int phase, int fold,
                                     int skip_t1, const void* in0, const void* in1, const void* in2,
                                     void* out0, void* out1, void* out2, const void* r,
                                     const void* scalar, void* partials, long long batch,
                                     long long n, int blocks, long long chunk, void* stream) {
  const void* in[3] = {in0, in1, in2};
  void* out[3] = {out0, out1, out2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const gkr_tail::RoundArgs none{};
  int rc;
  if (mont32) {
    const uint32_t one = (uint32_t)((1ull << 32) % p);  // the Montgomery word of 1
    rc = launch_libra_field<M32Ops, false>(M32Ops{{p, pinv}}, phase, fold, skip_t1, in, out, r, scalar, one,
                                          partials, batch, n, blocks, chunk, none, s);
  } else {
    rc = launch_libra_field<GlOps, false>(GlOps{}, phase, fold, skip_t1, in, out, r, scalar, (uint64_t)1,
                                         partials, batch, n, blocks, chunk, none, s);
  }
  return rc ? rc : (int)cudaGetLastError();
}

namespace {

template <int PHASE, bool FOLD, bool SKIP1>
int wave_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, libra_round_kernel<GlOps, PHASE, FOLD, SKIP1, true>,
                                                    THREADS, 0))
    return -1;
  return sms * per_sm;
}

}  // namespace

// Blocks of one wave of the TAIL instantiation (phase, fold, skip_t1) on
// the current device: its SMs times the blocks of that kernel resident on
// one SM. Returns -1 on a CUDA error.
extern "C" int ts_libra_round_tail_blocks(int phase, int fold, int skip_t1) {
  if (phase == 1) {
    if (fold) return skip_t1 ? wave_blocks<1, true, true>() : wave_blocks<1, true, false>();
    return skip_t1 ? wave_blocks<1, false, true>() : wave_blocks<1, false, false>();
  }
  if (phase == 2) {
    if (fold) return skip_t1 ? wave_blocks<2, true, true>() : wave_blocks<2, true, false>();
    return skip_t1 ? wave_blocks<2, false, true>() : wave_blocks<2, false, false>();
  }
  return -1;
}

// The LibraW shapes over Goldilocks for one proof (batch 1) with the GKR
// round tail as the launch's epilogue (TAIL; gkr_tail.cuh, RoundArgs):
// the same partials as ts_libra_round_launch, then the tail's outputs.
// counter must be 0 (the last block leaves it 0). Returns as above.
extern "C" int ts_libra_round_tail_launch(int phase, int fold, int skip_t1, const void* in0, const void* in1,
                                          const void* in2, void* out0, void* out1, void* out2, const void* r,
                                          const void* scalar, void* partials, long long n, int blocks,
                                          long long chunk, void* counter, void* state, void* buf,
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
  const int rc = launch_libra_field<GlOps, true>(GlOps{}, phase, fold, skip_t1, in, out, r, scalar, (uint64_t)1,
                                                 partials, 1, n, blocks, chunk, tail,
                                                 static_cast<cudaStream_t>(stream));
  return rc ? rc : (int)cudaGetLastError();
}
