// Exact modular matrix product C = A B^T mod p, over Goldilocks or a
// mont32 field (p < 2^31), with the triangle IP's round-sum epilogue.
//
// Replaces: thaler_study_tpu/ops/modmatmul.py, modmatmul_impl :35 (a
// K-chunked broadcast of modular products) and _mxu_modmatmul_impl :160
// (int8 digits on the TPU's matrix unit), which compute the same field
// values: C[m][n] = sum_k A[m][k] B[n][k] for A [M, K] and B [N, K]. The
// JAX package takes them for the triangle IP's X-phase contraction
// (ops/round_kernel.py _term_total :186-208): s = sum_{x,y} f1[x][y] *
// (f3 @ f2^T)[x][y]. Its plain version is ops/modmatmul.modmatmul_plain /
// contract_partials_plain.
//
// Modes (template flags):
//   plain:  C written, [M, N] row-major.
//   DOT:    C is not written; each block writes one partial sum of
//           D[m][n] * C[m][n] over its tile (D [M, N]), which the caller sums
//           mod p: the round sum of the contraction (c_1 without VIEW).
//   VIEW:   A and D are the views at t of two-halved tables: A_t = A_lo +
//           t (A_hi - A_lo) with A_hi the M rows after A_lo, formed while a
//           tile is staged (t is a field word: Montgomery for mont32), so
//           the views of a round are never written to device memory.
//
// What bounds it on the H100: integer operations. A tile of BM x BN
// outputs costs BM BN K products against (BM + BN) K loads, so at the
// X phase's shapes (M up to 2^12, N = K = 2^12) it runs O(K) products per
// word read. Each block stages BK-deep slabs of A and B in shared memory;
// each thread keeps TM x TN outputs in registers and sums their raw
// products lazily: Goldilocks 64 x 64 -> 128-bit products (a * b and
// __umul64hi) in a 192-bit accumulator, one reduction per output; mont32
// raw 32 x 32 -> 64-bit products of Montgomery words (each (aR)(bR) < p^2)
// in a 128-bit accumulator, then one reduction and one REDC: sum (aR)(bR) =
// (sum ab) R^2, whose REDC is the Montgomery word of sum ab, the word the
// JAX programs give (_mxu_modmatmul_impl :202-217). No product is reduced on
// its own. Ragged edges load zeros (a zero contributes nothing) and mask
// their stores. The int8 tensor-core digit form of the TPU's matrix unit is
// a later redesign.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int TX = 16, TY = 16, THREADS = TX * TY;
constexpr int TM = 4, TN = 4;                   // outputs per thread
constexpr int BM = TY * TM, BN = TX * TN, BK = 16;  // 64 x 64 outputs per block

struct GlOps {
  using word = uint64_t;
  using Acc = gl::Acc;
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
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

// grid = (ceil(N / BN), ceil(M / BM)). Thread (tx, ty) owns outputs
// (row0 + ty + TY i, col0 + tx + TX j): neighbouring threads on
// neighbouring columns, so C and D are read and written coalesced.
template <class F, bool VIEW, bool DOT>
__global__ void __launch_bounds__(THREADS)
    modmatmul_kernel(F f, const typename F::word* __restrict__ a, const typename F::word* __restrict__ b,
                     typename F::word* __restrict__ c, const typename F::word* __restrict__ dt,
                     typename F::word t, typename F::word* __restrict__ partials, int M, int N, int K) {
  using W = typename F::word;
  __shared__ W as[BK][BM + 1];
  __shared__ W bs[BK][BN + 1];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const long long a_hi = (long long)M * K;  // VIEW: A_hi starts M rows after A_lo

  typename F::Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = typename F::Acc{};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage A[row0 .. +BM][k0 .. +BK] and B[col0 .. +BN][k0 .. +BK]: thread
    // e loads column e % BK of rows e / BK (+ THREADS / BK ...), so 16
    // neighbouring threads read 16 neighbouring words of one row
#pragma unroll
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int kk = e % BK, mm = e / BK;
      const int row = row0 + mm, col = k0 + kk;
      W x = 0;
      if (row < M && col < K) {
        const long long i = (long long)row * K + col;
        x = VIEW ? f.fold(a[i], a[i + a_hi], t) : a[i];
      }
      as[kk][mm] = x;
    }
#pragma unroll
    for (int e = threadIdx.x; e < BN * BK; e += THREADS) {
      const int kk = e % BK, nn = e / BK;
      const int row = col0 + nn, col = k0 + kk;
      bs[kk][nn] = (row < N && col < K) ? b[(long long)row * K + col] : (W)0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      W av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) f.acc_add(acc[i][j], av[i], bv[j]);
    }
    __syncthreads();
  }

  if (!DOT) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col0 + tx + TX * j;
        if (row < M && col < N) c[(long long)row * N + col] = f.acc_reduce(acc[i][j]);
      }
    }
    return;
  }
  // DOT: sum over the tile of D_t * C, lazily, then one partial per block
  const long long d_hi = (long long)M * N;
  typename F::Acc dot{};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + TY * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + TX * j;
      if (row < M && col < N) {
        const long long idx = (long long)row * N + col;
        const W dv = VIEW ? f.fold(dt[idx], dt[idx + d_hi], t) : dt[idx];
        f.acc_add(dot, dv, f.acc_reduce(acc[i][j]));
      }
    }
  }
  __shared__ W warp_sums[THREADS / 32];
  W x = f.acc_reduce(dot);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = f.add(x, shfl_down(x, off));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    W total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total = f.add(total, warp_sums[w]);
    partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

template <class F>
int launch(const F& f, int mode, const void* a, const void* b, void* c, const void* d, uint64_t t, void* partials,
           int M, int N, int K, cudaStream_t s) {
  using W = typename F::word;
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const W* ap = static_cast<const W*>(a);
  const W* bp = static_cast<const W*>(b);
  const W* dp = static_cast<const W*>(d);
  W* cp = static_cast<W*>(c);
  W* pp = static_cast<W*>(partials);
  if (mode == 0) modmatmul_kernel<F, false, false><<<grid, THREADS, 0, s>>>(f, ap, bp, cp, dp, (W)t, pp, M, N, K);
  else if (mode == 1) modmatmul_kernel<F, false, true><<<grid, THREADS, 0, s>>>(f, ap, bp, cp, dp, (W)t, pp, M, N, K);
  else if (mode == 2) modmatmul_kernel<F, true, true><<<grid, THREADS, 0, s>>>(f, ap, bp, cp, dp, (W)t, pp, M, N, K);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// mode 0: C = A B^T (c: [M, N]); mode 1: DOT (partials: one word per
// block of the (ceil(N / 64), ceil(M / 64)) grid, row-major, d: [M, N]);
// mode 2: VIEW and DOT (a: [2M, K], d: [2M, N], t a word of the field).
// Unused pointers are null. mont32 = 0 takes Goldilocks int64 words;
// mont32 = 1 Montgomery words of the field with modulus p < 2^31 and pinv
// = -p^-1 mod 2^32. Returns cudaGetLastError() after the launch (0 =
// launched); the wrapper checks every argument first.
extern "C" int ts_modmatmul_launch(int mont32, unsigned p, unsigned pinv, int mode, const void* a, const void* b,
                                   void* c, const void* d, unsigned long long t, void* partials, int M, int N, int K,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = mont32 ? launch(M32Ops{{p, pinv}}, mode, a, b, c, d, t, partials, M, N, K, s)
                        : launch(GlOps{}, mode, a, b, c, d, t, partials, M, N, K, s);
  return rc ? rc : (int)cudaGetLastError();
}
