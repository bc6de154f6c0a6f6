// Fused sumcheck round (fold + round sums) for a batch of single-block
// product polynomials over Goldilocks.
//
// Replaces: thaler_study_tpu/ops/pallas_round.py, _make_kernel (the
// pl.pallas_call at :341), which computes one round of one proof for a
// k-factor product; this kernel computes it for B proofs at once, k = 2
// or 3. Its plain version is ops/cuda_round.round_partials_plain.
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
// of the sums cannot change a bit.
//
// What bounds it on the H100: device memory. A FOLD round reads 8K bytes
// and writes 4K bytes per table entry pair; the arithmetic is a few 64-bit
// multiplies per element. So each thread streams its element indices with
// neighbouring threads on neighbouring addresses (coalesced 8-byte loads),
// folds and sums in registers, and keeps the sums as unreduced 192-bit
// accumulators (one modular reduction per thread per t, not per product).
// The TPU kernel's sequential-grid accumulator has no counterpart: blocks
// run in parallel and reduce their threads' sums in shared memory.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;

template <int K>
struct Tables {
  const uint64_t* in[K];
  uint64_t* out[K];
};

template <int K>
__device__ __forceinline__ void add_product(gl::Acc& acc, const uint64_t (&v)[K]) {
  uint64_t a = v[0];
#pragma unroll
  for (int f = 1; f < K - 1; ++f) a = gl::mul(a, v[f]);
  gl::acc_add(acc, a * v[K - 1], __umul64hi(a, v[K - 1]));
}

// grid = (blocks, B). Block x of proof b covers pair indices
// [x * chunk, min((x + 1) * chunk, half)), its threads striding by THREADS.
template <int K, bool FOLD, bool SKIP1>
__global__ void __launch_bounds__(THREADS)
    round_kernel(Tables<K> t, const uint64_t* __restrict__ r,
                 uint64_t* __restrict__ partials, long long n, long long chunk) {
  constexpr int D = K;
  const long long b = blockIdx.y;
  const long long half = FOLD ? n / 4 : n / 2;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < half ? begin + chunk : half;
  const uint64_t rb = FOLD ? r[b] : 0;

  gl::Acc acc[D + 1];
#pragma unroll
  for (int s = 0; s <= D; ++s) acc[s] = gl::Acc{0, 0, 0};

  for (long long i = begin + threadIdx.x; i < end; i += THREADS) {
    uint64_t lo[K], hi[K];
#pragma unroll
    for (int f = 0; f < K; ++f) {
      const uint64_t* src = t.in[f] + b * n;
      if (FOLD) {
        // quarters q0..q3 of T: f_lo = fold(q0, q2), f_hi = fold(q1, q3)
        lo[f] = gl::fold(src[i], src[i + 2 * half], rb);
        hi[f] = gl::fold(src[i + half], src[i + 3 * half], rb);
        uint64_t* dst = t.out[f] + b * (n / 2);
        dst[i] = lo[f];
        dst[i + half] = hi[f];
      } else {
        lo[f] = src[i];
        hi[f] = src[i + half];
      }
    }
    add_product<K>(acc[0], lo);
    if (!SKIP1) add_product<K>(acc[1], hi);
    uint64_t v[K], delta[K];
#pragma unroll
    for (int f = 0; f < K; ++f) {
      delta[f] = gl::sub(hi[f], lo[f]);
      v[f] = hi[f];
    }
#pragma unroll
    for (int s = 2; s <= D; ++s) {
#pragma unroll
      for (int f = 0; f < K; ++f) v[f] = gl::add(v[f], delta[f]);
      add_product<K>(acc[s], v);
    }
  }

  __shared__ uint64_t warp_sums[THREADS / 32][D + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s <= D; ++s) {
    uint64_t x = gl::acc_reduce(acc[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x = gl::add(x, (uint64_t)__shfl_down_sync(0xffffffffu, (unsigned long long)x, off));
    }
    if (lane == 0) warp_sums[warp][s] = x;
  }
  __syncthreads();
  if (threadIdx.x <= D) {
    uint64_t total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total = gl::add(total, warp_sums[w][threadIdx.x]);
    partials[(b * gridDim.x + blockIdx.x) * (D + 1) + threadIdx.x] = total;
  }
}

template <int K, bool FOLD, bool SKIP1>
void launch(const void* const* in, void* const* out, const void* r, void* partials,
            long long batch, long long n, int blocks, long long chunk, cudaStream_t stream) {
  Tables<K> t;
  for (int f = 0; f < K; ++f) {
    t.in[f] = static_cast<const uint64_t*>(in[f]);
    t.out[f] = static_cast<uint64_t*>(out[f]);
  }
  dim3 grid(blocks, (unsigned)batch);
  round_kernel<K, FOLD, SKIP1><<<grid, THREADS, 0, stream>>>(
      t, static_cast<const uint64_t*>(r), static_cast<uint64_t*>(partials), n, chunk);
}

template <int K>
void launch_k(int fold, int skip_t1, const void* const* in, void* const* out, const void* r,
              void* partials, long long batch, long long n, int blocks, long long chunk,
              cudaStream_t s) {
  if (fold && skip_t1) launch<K, true, true>(in, out, r, partials, batch, n, blocks, chunk, s);
  else if (fold) launch<K, true, false>(in, out, r, partials, batch, n, blocks, chunk, s);
  else if (skip_t1) launch<K, false, true>(in, out, r, partials, batch, n, blocks, chunk, s);
  else launch<K, false, false>(in, out, r, partials, batch, n, blocks, chunk, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); k must be 2
// or 3 (the wrapper checks every argument first). Unused pointers are null.
extern "C" int ts_round_launch(int k, int fold, int skip_t1, const void* in0, const void* in1,
                               const void* in2, void* out0, void* out1, void* out2,
                               const void* r, void* partials, long long batch, long long n,
                               int blocks, long long chunk, void* stream) {
  const void* in[3] = {in0, in1, in2};
  void* out[3] = {out0, out1, out2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 2) launch_k<2>(fold, skip_t1, in, out, r, partials, batch, n, blocks, chunk, s);
  else if (k == 3) launch_k<3>(fold, skip_t1, in, out, r, partials, batch, n, blocks, chunk, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
