// Two table builders of the fused GKR prover, over Goldilocks or a mont32
// field (p < 2^31): the eq table and the line restriction.
//
// Replaces: thaler_study_tpu/gkr/device_tables.py eq_table_dev (:316) and
// line_restrict_coeffs (:454), jnp programs that XLA compiles for the TPU.
// Their plain versions are gkr/device_tables.eq_table_plain and
// line_restrict_coeffs_plain.
//
// EQ TABLE. out[x] = prod_{j < n} (bit_j(x) ? r[j] : 1 - r[j]) over the
// 2^n little-endian indices x. Block b writes the 2^low entries
// [b 2^low, (b + 1) 2^low), low = min(n, LOW): it builds eq over the low
// bits in shared memory by doubling (2^low products in all, ping-pong
// buffers, one barrier per variable), takes the product over the high bits
// of b (n - low products), and stores lo[x] * hi, coalesced. So the table
// costs about two products per entry, and the result is exact whatever the
// association, since field products do not round. What bounds it on the
// H100: the bytes it writes, 2^n words (8 MB at n = 20, 2.5 us at
// 3.35 TB/s).
//
// LINE RESTRICTION. The coefficients of q(t) = W~(u + t delta) for the
// multilinear W of 2^k values in label order: W is folded one variable at a
// time with r_j(t) = u_j + t delta_j carried symbolically, so entry i of
// step j is a polynomial of degree j in t. One launch per step j, one
// thread per output entry: from the even and odd rows e, o (j + 1
// coefficients each) it writes the j + 2 coefficients
//   out[m] = e[m] + u_j (o[m] - e[m]) + delta_j (o[m-1] - e[m-1]).
// What bounds it: the bytes of the k steps, sum_j 2^(k-j) (j + 1) words
// read and 2^(k-j-1) (j + 2) written, ~59 MB at k = 20 (the function's own
// floor is reading W once, 8 MB); merging the first steps in shared memory
// is later work.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LOW = 10;  // eq: the low bits one block builds in shared memory

struct GlOps {
  using word = uint64_t;
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
  __device__ __forceinline__ word sub(word a, word b) const { return gl::sub(a, b); }
  __device__ __forceinline__ word mul(word a, word b) const { return gl::mul(a, b); }
};

struct M32Ops : m32::Field {
  using word = uint32_t;
};

// grid = 2^(n - low) blocks of THREADS threads
template <class F>
__global__ void __launch_bounds__(THREADS)
    eq_table_kernel(F f, typename F::word one, const typename F::word* __restrict__ r, int n, int low,
                    typename F::word* __restrict__ out) {
  using W = typename F::word;
  __shared__ W tab[2][1 << LOW];
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  // the factor of the high bits, n - low products (every thread, no barrier)
  W hi = one;
  for (int j = low; j < n; ++j) {
    const W rj = r[j];
    hi = f.mul(hi, (b >> (j - low)) & 1 ? rj : f.sub(one, rj));
  }
  // eq over the low bits by doubling, from the last low variable down:
  // after variable j, index bit 0 is variable j
  if (tid == 0) tab[0][0] = one;
  __syncthreads();
  int cur = 0;
  for (int j = low - 1; j >= 0; --j) {
    const int size = 1 << (low - 1 - j);
    const W rj = r[j];
    for (int i = tid; i < size; i += THREADS) {
      const W w = tab[cur][i];
      const W h = f.mul(w, rj);
      tab[cur ^ 1][2 * i + 1] = h;
      tab[cur ^ 1][2 * i] = f.sub(w, h);
    }
    cur ^= 1;
    __syncthreads();
  }
  W* o = out + (b << low);
  for (int x = tid; x < (1 << low); x += THREADS) o[x] = f.mul(tab[cur][x], hi);
}

// step j: in [2 half, j + 1] -> out [half, j + 2], row-major
template <class F>
__global__ void __launch_bounds__(THREADS)
    line_fold_kernel(F f, const typename F::word* __restrict__ in, int j,
                     const typename F::word* __restrict__ u, const typename F::word* __restrict__ delta,
                     typename F::word* __restrict__ out, long long half) {
  using W = typename F::word;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= half) return;
  const W uj = u[j], dj = delta[j];
  const W* e = in + 2 * i * (j + 1);
  const W* o = e + (j + 1);
  W* y = out + i * (j + 2);
  W prev = 0;  // o[m-1] - e[m-1]
  for (int m = 0; m <= j; ++m) {
    const W d = f.sub(o[m], e[m]);
    y[m] = f.add(e[m], f.add(f.mul(uj, d), f.mul(dj, prev)));
    prev = d;
  }
  y[j + 1] = f.mul(dj, prev);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). mont32 = 0
// takes Goldilocks int64 words; mont32 = 1 takes Montgomery words of the
// field with modulus p < 2^31 and pinv = -p^-1 mod 2^32. r holds at least
// n words, out 2^n (the wrapper checks every argument first).
extern "C" int ts_eq_table_launch(int mont32, unsigned p, unsigned pinv, const void* r, int n,
                                  void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int low = n < LOW ? n : LOW;
  const unsigned blocks = 1u << (n - low);
  if (mont32)
    eq_table_kernel<<<blocks, THREADS, 0, s>>>(M32Ops{{p, pinv}}, (uint32_t)((1ull << 32) % p),
                                               static_cast<const uint32_t*>(r), n, low,
                                               static_cast<uint32_t*>(out));
  else
    eq_table_kernel<<<blocks, THREADS, 0, s>>>(GlOps{}, (uint64_t)1, static_cast<const uint64_t*>(r), n,
                                               low, static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}

// One fold step j of the line restriction: in [2 half, j + 1] words,
// out [half, j + 2]; u and delta hold at least j + 1 words. Returns
// cudaGetLastError() after the launch.
extern "C" int ts_line_fold_launch(int mont32, unsigned p, unsigned pinv, const void* in, int j,
                                   const void* u, const void* delta, void* out, long long half,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((half + THREADS - 1) / THREADS);
  if (mont32)
    line_fold_kernel<<<blocks, THREADS, 0, s>>>(M32Ops{{p, pinv}}, static_cast<const uint32_t*>(in), j,
                                                static_cast<const uint32_t*>(u),
                                                static_cast<const uint32_t*>(delta),
                                                static_cast<uint32_t*>(out), half);
  else
    line_fold_kernel<<<blocks, THREADS, 0, s>>>(GlOps{}, static_cast<const uint64_t*>(in), j,
                                                static_cast<const uint64_t*>(u),
                                                static_cast<const uint64_t*>(delta),
                                                static_cast<uint64_t*>(out), half);
  return (int)cudaGetLastError();
}
