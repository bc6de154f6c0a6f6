// Two table builders of the GKR prover, over Goldilocks or a mont32 field
// (p < 2^31): the eq table (alone, or with the dot product W~(u) in the same
// pass) and the line restriction.
//
// Replaces: thaler_study_tpu/gkr/device_tables.py eq_table_dev (:316), with
// dot_mod (:350) as phase2_tables (:411) applies it, and
// line_restrict_coeffs (:454), jnp programs that XLA compiles for the TPU.
// Their plain versions are gkr/device_tables.eq_table_plain (then dot_mod)
// and line_restrict_coeffs_plain.
//
// EQ TABLE. out[x] = prod_{j < n} (bit_j(x) ? r[j] : 1 - r[j]) over the
// 2^n little-endian indices x. Block b writes the 2^low entries
// [b 2^low, (b + 1) 2^low), low = min(n, LOW). The low bits split into
// la = min(low, 5) and lb = low - la bits: warp 0 builds the 2^la products
// over bits 0..la-1 (one thread per entry, la factors each), the next
// warps the 2^lb (up to 128) products over bits la..low-1 times the factor
// of b's high bits (n - low factors), into two tables in shared memory
// (one barrier); then
// every entry is ONE product, ta[x mod 2^la] * tb[x >> la], and each thread
// stores 16 bytes at a time, neighbouring threads on neighbouring
// addresses. Exact whatever the association: field products do not round.
// What bounds it on the H100: the bytes it writes, 2^n words (8.4 MB at
// n = 20, 2.5 us at 3.35 TB/s).
//
// EQ WITH THE DOT (DOT). The same pass also reads W (label order, 16-byte
// loads) and accumulates W[x] eq[x] per thread without reduction (192-bit
// sums of 128-bit products for Goldilocks, 128-bit sums of raw Montgomery
// products for mont32, as the round kernel does), reduces per warp and per
// block, and writes one partial per block; the last block to take a ticket
// sums the partials, writes W~(u) and resets the counter (the round
// kernel's TAIL epilogue does the same). One block (n <= LOW) writes W~(u)
// itself. Bound: eq written and W read, 16.8 MB at n = 20 (5.0 us).
//
// LINE RESTRICTION. The coefficients of q(t) = W~(u + t delta) for the
// multilinear W of 2^k values in label order: W is folded one variable at a
// time with r_j(t) = u_j + t delta_j carried symbolically, so after j folds
// an entry is a polynomial of degree j in t. Fold step j turns the even and
// odd rows e, o (j + 1 coefficients each) into j + 2 coefficients
//   y[m] = e[m] + u_j (o[m] - e[m]) + delta_j (o[m-1] - e[m-1]).
// The fold runs in TILES (the wrapper's plan): a tile over polynomials of
// degree d folds variables d..d+t-1, each block taking 2^t consecutive
// polynomials (a tile of consecutive labels holds its t variables whole).
// The block copies its tile into shared memory with coalesced 16-byte
// loads, runs the t steps there between two regions of one buffer (a
// step's output never overlaps its input), one output word per thread and
// iteration, and writes its one polynomial of degree d + t. A tile over W
// itself first folds LINE_REG variables in registers, each thread from
// 2^LINE_REG consecutive words. The last tile runs in the last block of the
// launch before it, by ticket. At k = 20 over Goldilocks, one launch: 128
// blocks fold variables 0..12 (one wave), then the last of them folds
// 13..19 over the 128 polynomials of 14 coefficients. delta_j is u_j's
// partner: either given (the JAX signature) or formed here as c_j - u_j
// from the layer's challenge vector (u, c), so the caller issues no
// subtraction. What bounds it: reading W once, 8.4 MB at k = 20 (2.5 us),
// is the bytes bound; the arithmetic, about 4 * 2^k field products of ~30
// integer instructions each plus the reductions, takes longer on this
// card, and the one-block tail tile runs its steps at the latency of a
// dependent chain.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LOW = 12;  // eq: the low bits of one block's entries
constexpr int LA = 5;    // eq: the bits of the first factor table
// line restriction: the most dynamic shared memory a tile may take (the
// wrapper's plan, gkr/device_tables.LINE_SMEM_BYTES, sizes tiles to fit)
constexpr int LINE_SMEM_BYTES = 96 * 1024;
// line restriction: the variables a tile over W folds in registers
// (gkr/device_tables.LINE_REG)
constexpr int LINE_REG = 4;
// line restriction: threads per block (more warps to hide the steps' latency)
constexpr int LINE_THREADS = 512;
constexpr int MAX_DEVICES = 64;  // devices a process may launch on (per-device opt-ins)
constexpr int LINE_MAX_T = 32;  // line restriction: the most variables of one tile

struct GlOps {
  using word = uint64_t;
  using Acc = gl::Acc;
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
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const {
    m32::acc_add(acc, (uint64_t)a * b);
  }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return m32::acc_reduce(*this, acc); }
};

// 16 bytes at a time: two Goldilocks words or four mont32 words
__device__ __forceinline__ void load_vec(const uint64_t* p, uint64_t (&v)[2]) {
  const ulonglong2 x = *reinterpret_cast<const ulonglong2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void load_vec(const uint32_t* p, uint32_t (&v)[4]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void store_vec(uint64_t* p, const uint64_t (&v)[2]) {
  *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(uint32_t* p, const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load_vec_cg(const uint64_t* p, uint64_t (&v)[2]) {
  const ulonglong2 x = __ldcg(reinterpret_cast<const ulonglong2*>(p));
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void load_vec_cg(const uint32_t* p, uint32_t (&v)[4]) {
  const uint4 x = __ldcg(reinterpret_cast<const uint4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

__device__ __forceinline__ uint32_t shfl_down(uint32_t x, int off) {
  return __shfl_down_sync(0xffffffffu, x, off);
}
__device__ __forceinline__ uint64_t shfl_down(uint64_t x, int off) {
  return (uint64_t)__shfl_down_sync(0xffffffffu, (unsigned long long)x, off);
}
__device__ __forceinline__ uint32_t ldcg(const uint32_t* p) { return __ldcg(reinterpret_cast<const unsigned int*>(p)); }
__device__ __forceinline__ uint64_t ldcg(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

// the block's sum of one word per thread (every thread calls it; thread 0
// gets the sum)
template <class F>
__device__ __forceinline__ typename F::word block_sum(const F& f, typename F::word s, typename F::word* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = f.add(s, shfl_down(s, off));
  if (lane == 0) sums[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) s = f.add(s, sums[w]);
  }
  return s;
}

// grid = 2^(n - low) blocks of THREADS threads. DOT: w holds the 2^n words
// of W, partials one word per block, *counter is 0 on entry and on exit,
// *w_u receives sum_x W[x] out[x].
template <class F, bool DOT>
__global__ void __launch_bounds__(THREADS)
    eq_table_kernel(F f, typename F::word one, const typename F::word* __restrict__ r, int n,
                    typename F::word* __restrict__ out, const typename F::word* __restrict__ w,
                    typename F::word* __restrict__ partials, int* __restrict__ counter,
                    typename F::word* __restrict__ w_u) {
  using W = typename F::word;
  constexpr int VEC = 16 / sizeof(W);
  __shared__ W ta[1 << LA], tb[1 << (LOW - LA)];
  constexpr int ITERS = (1 << LOW) / (VEC * THREADS);  // 16-byte stores per thread at low = LOW
  const int low = n < LOW ? n : LOW, la = low < LA ? low : LA, lb = low - la;
  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  W* o = out + (blk << low);
  const W* wb = DOT ? w + (blk << low) : nullptr;
  // the full-width path: W's words are loaded before the factor tables are
  // built, so their latency hides behind the tables and the barrier
  const bool vec = low == LOW && aligned16(o) && (!DOT || aligned16(wb));
  W pre[ITERS][VEC];
  if (DOT && vec) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) load_vec(wb + (it * THREADS + tid) * VEC, pre[it]);
  }
  if (tid < (1 << la)) {
    W x = one;
    for (int j = 0; j < la; ++j) x = f.mul(x, (tid >> j) & 1 ? r[j] : f.sub(one, r[j]));
    ta[tid] = x;
  } else if (tid >= 32 && tid < 32 + (1 << lb)) {
    const int b = tid - 32;
    W x = one;
    for (int j = 0; j < lb; ++j) x = f.mul(x, (b >> j) & 1 ? r[la + j] : f.sub(one, r[la + j]));
    for (int j = low; j < n; ++j) x = f.mul(x, (blk >> (j - low)) & 1 ? r[j] : f.sub(one, r[j]));
    tb[b] = x;
  }
  __syncthreads();

  const int size = 1 << low, amask = (1 << la) - 1;
  typename F::Acc acc{};
  if (vec) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int x = (it * THREADS + tid) * VEC;
      const W hi = tb[x >> la];
      W v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = f.mul(ta[(x + e) & amask], hi);
      store_vec(o + x, v);
      if (DOT) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f.acc_add(acc, v[e], pre[it][e]);
      }
    }
  } else {
    for (int x = tid; x < size; x += THREADS) {
      const W v = f.mul(ta[x & amask], tb[x >> la]);
      o[x] = v;
      if (DOT) f.acc_add(acc, v, wb[x]);
    }
  }
  if constexpr (DOT) {
    __shared__ W sums[THREADS / 32];
    __shared__ int last;
    const W s = block_sum(f, f.acc_reduce(acc), sums);
    if (tid == 0) {
      if (gridDim.x == 1) {
        *w_u = s;
        last = 0;
      } else {
        partials[blk] = s;
        __threadfence();
        last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
      }
    }
    __syncthreads();
    if (!last) return;
    W t = 0;
    for (int x = tid; x < (int)gridDim.x; x += THREADS) t = f.add(t, ldcg(partials + x));
    t = block_sum(f, t, sums);
    if (tid == 0) {
      *w_u = t;
      *counter = 0;
    }
  }
}

// y[m] = e[m] + u_j (o[m] - e[m]) + delta_j (o[m-1] - e[m-1]), the first
// term for m <= deg, the second for m >= 1
template <class F>
__device__ __forceinline__ typename F::word fold_coeff(const F& f, const typename F::word* e,
                                                       const typename F::word* o, int m, int deg,
                                                       typename F::word uj, typename F::word dj) {
  typename F::word y = 0;
  if (m <= deg) y = f.add(e[m], f.mul(uj, f.sub(o[m], e[m])));
  if (m >= 1) y = f.add(y, f.mul(dj, f.sub(o[m - 1], e[m - 1])));
  return y;
}

// One fold step over `nout` output polynomials of deg + 2 coefficients from
// 2 nout input polynomials of deg + 1 (row-major, src and dst disjoint).
template <class F>
__device__ __forceinline__ void line_step(const F& f, const typename F::word* __restrict__ src,
                                          typename F::word* __restrict__ dst, int nout, int deg,
                                          typename F::word uj, typename F::word dj) {
  const int width = deg + 2, total = nout * width;
  // output word idx = i * width + m, advanced by LINE_THREADS without a
  // division
  const int di = LINE_THREADS / width, dm = LINE_THREADS % width;
  int i = threadIdx.x / width, m = threadIdx.x % width;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < total; idx += LINE_THREADS) {
    const typename F::word* e = src + 2 * i * (deg + 1);
    dst[idx] = fold_coeff(f, e, e + deg + 1, m, deg, uj, dj);
    i += di;
    m += dm;
    if (m >= width) {
      m -= width;
      ++i;
    }
  }
}

// The first R variables of 2^R consecutive words of W, folded in registers:
// c[0][0..R] is the polynomial of degree R (fully unrolled: every index is
// a constant, so c stays in registers).
template <class F, int R>
__device__ __forceinline__ void reg_fold(const F& f, typename F::word (&c)[1 << R][R + 1],
                                         const typename F::word* su, const typename F::word* sd) {
  using W = typename F::word;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const W uj = su[s], dj = sd[s];
#pragma unroll
    for (int q = 0; q < (1 << (R - s - 1)); ++q) {
      W y[R + 1];
#pragma unroll
      for (int m = 0; m <= s + 1; ++m) y[m] = fold_coeff(f, c[2 * q], c[2 * q + 1], m, s, uj, dj);
#pragma unroll
      for (int m = 0; m <= s + 1; ++m) c[q][m] = y[m];
    }
  }
}

// One block folds t variables of 2^t consecutive polynomials of d + 1
// coefficients at src (row-major) into one polynomial of d + t + 1
// coefficients at dst; su / sd hold u_j and delta_j of those variables.
// R > 0 (d = 0, t > R): each thread loads 2^R consecutive words of W and
// folds variables 0..R-1 in registers, so the steps in shared memory start
// from 2^(t-R) polynomials of degree R. R = 0: the block copies its tile
// into shared memory first (CG: through L2 only, for a tile that other
// blocks of this launch wrote). buf: the dynamic shared memory, the first
// table (the tile, or the register folds' output) and, if a second shared
// step follows, the first step's output after it
// (gkr/device_tables._tile_words). Ends in a barrier.
template <class F, int R, bool CG>
__device__ __forceinline__ void fold_tile(const F& f, const typename F::word* __restrict__ src, int d, int t,
                                          const typename F::word* su, const typename F::word* sd,
                                          typename F::word* buf, typename F::word* __restrict__ dst) {
  using W = typename F::word;
  constexpr int VEC = 16 / sizeof(W);
  const int tile = (1 << t) * (d + 1);
  int nin = 1 << (t - R), in_size;
  if constexpr (R > 0) {
    constexpr int N = 1 << R;
    const bool vec = aligned16(src);
    for (int q = threadIdx.x; q < nin; q += LINE_THREADS) {
      W c[N][R + 1];
      W a[N];
      if (vec) {
#pragma unroll
        for (int x = 0; x < N; x += VEC) {
          W part[VEC];
          load_vec(src + q * N + x, part);
#pragma unroll
          for (int e = 0; e < VEC; ++e) a[x + e] = part[e];
        }
      } else {
#pragma unroll
        for (int x = 0; x < N; ++x) a[x] = src[q * N + x];
      }
#pragma unroll
      for (int x = 0; x < N; ++x) c[x][0] = a[x];
      reg_fold<F, R>(f, c, su, sd);
#pragma unroll
      for (int m = 0; m <= R; ++m) buf[q * (R + 1) + m] = c[0][m];
    }
    in_size = nin * (R + 1);
  } else {
    if (tile % VEC == 0 && aligned16(src)) {
#pragma unroll 4
      for (int x = threadIdx.x * VEC; x < tile; x += VEC * LINE_THREADS) {
        W a[VEC];
        if (CG)
          load_vec_cg(src + x, a);
        else
          load_vec(src + x, a);
        store_vec(buf + x, a);
      }
    } else {
      for (int x = threadIdx.x; x < tile; x += LINE_THREADS) buf[x] = CG ? ldcg(src + x) : src[x];
    }
    in_size = tile;
  }
  __syncthreads();
  // a step reads [in_off, in_off + in_size) and writes after it, or at 0
  // when it read after 0 (outputs shrink, so they never overlap the input)
  int in_off = 0;
  for (int s = R; s < t; ++s) {
    const int deg = d + s;
    const int nout = nin >> 1;
    const int out_off = in_off == 0 ? in_size : 0;
    line_step(f, buf + in_off, s == t - 1 ? dst : buf + out_off, nout, deg, su[s], sd[s]);
    __syncthreads();
    in_off = out_off;
    in_size = nout * (deg + 2);
    nin = nout;
  }
}

// grid = (number of input polynomials) / 2^t blocks; block b folds
// variables d..d+t-1 of its 2^t polynomials of d + 1 coefficients in `in`
// into polynomial b of d + t + 1 coefficients in `out`. u and v hold at
// least d + t + tail_t words: v is delta, or c when v_is_c
// (delta_j = c_j - u_j); the block keeps u_j and delta_j of its variables
// in shared memory. tail_t > 0: the last block to take a ticket (*counter,
// 0 on entry and on exit) then folds the tail_t variables that follow
// over all the blocks' polynomials (2^tail_t of them, read back from
// `out` through L2) into tail_out, d + t + tail_t + 1 coefficients.
template <class F, int R>
__global__ void __launch_bounds__(LINE_THREADS)
    line_tile_kernel(F f, const typename F::word* __restrict__ in, int d, int t,
                     const typename F::word* __restrict__ u, const typename F::word* __restrict__ v, int v_is_c,
                     typename F::word* out, int tail_t, typename F::word* __restrict__ tail_out,
                     int* __restrict__ counter) {
  using W = typename F::word;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ W su[LINE_MAX_T], sd[LINE_MAX_T];  // u_j and delta_j of the launch's variables
  __shared__ int last;
  W* buf = reinterpret_cast<W*>(smem);
  const long long blk = blockIdx.x;
  if ((int)threadIdx.x < t + tail_t) {
    const W uj = u[d + threadIdx.x];
    su[threadIdx.x] = uj;
    sd[threadIdx.x] = v_is_c ? f.sub(v[d + threadIdx.x], uj) : v[d + threadIdx.x];
  }
  __syncthreads();
  fold_tile<F, R, false>(f, in + blk * ((1 << t) * (d + 1)), d, t, su, sd, buf, out + blk * (d + t + 1));
  if (tail_t == 0) return;
  // the barrier that ended fold_tile orders the block's writes of its
  // polynomial before thread 0's fence and ticket
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) *counter = 0;
  fold_tile<F, 0, true>(f, out, d + t, tail_t, su + t, sd + t, buf, tail_out);
}

template <class F, int R>
int line_tile_launch(F f, const void* in, int d, int t, const void* u, const void* v, int v_is_c, void* out,
                     unsigned blocks, int smem_bytes, int tail_t, void* tail_out, void* counter, cudaStream_t s) {
  using W = typename F::word;
  static bool attr[MAX_DEVICES] = {};  // opt in above 48 KB once per instantiation and device
  int dev = 0;
  const cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return (int)de;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!attr[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(line_tile_kernel<F, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               LINE_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr[dev] = true;
  }
  line_tile_kernel<F, R><<<blocks, LINE_THREADS, smem_bytes, s>>>(
      f, static_cast<const W*>(in), d, t, static_cast<const W*>(u), static_cast<const W*>(v), v_is_c,
      static_cast<W*>(out), tail_t, static_cast<W*>(tail_out), static_cast<int*>(counter));
  return (int)cudaGetLastError();
}

template <class F>
int line_tile_dispatch(F f, const void* in, int d, int t, const void* u, const void* v, int v_is_c, void* out,
                       unsigned blocks, int smem_bytes, int tail_t, void* tail_out, void* counter, cudaStream_t s) {
  if (d == 0 && t > LINE_REG)
    return line_tile_launch<F, LINE_REG>(f, in, d, t, u, v, v_is_c, out, blocks, smem_bytes, tail_t, tail_out,
                                         counter, s);
  return line_tile_launch<F, 0>(f, in, d, t, u, v, v_is_c, out, blocks, smem_bytes, tail_t, tail_out, counter, s);
}

template <class F, bool DOT>
int eq_launch(F f, typename F::word one, const void* r, int n, void* out, const void* w, void* partials,
              void* counter, void* w_u, cudaStream_t s) {
  using W = typename F::word;
  const int low = n < LOW ? n : LOW;
  eq_table_kernel<F, DOT><<<1u << (n - low), THREADS, 0, s>>>(
      f, one, static_cast<const W*>(r), n, static_cast<W*>(out), static_cast<const W*>(w),
      static_cast<W*>(partials), static_cast<int*>(counter), static_cast<W*>(w_u));
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point returns cudaGetLastError() after the launch (0 =
// launched). mont32 = 0 takes Goldilocks int64 words; mont32 = 1 takes
// Montgomery words of the field with modulus p < 2^31 and
// pinv = -p^-1 mod 2^32. The wrapper checks every argument first.

// r holds at least n words, out 2^n.
extern "C" int ts_eq_table_launch(int mont32, unsigned p, unsigned pinv, const void* r, int n, void* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mont32) {
    const M32Ops f{{p, pinv}};
    return eq_launch<M32Ops, false>(f, f.r1, r, n, out, nullptr, nullptr, nullptr, nullptr, s);
  }
  return eq_launch<GlOps, false>(GlOps{}, (uint64_t)1, r, n, out, nullptr, nullptr, nullptr, nullptr, s);
}

// The eq table and sum_x W[x] eq[x]: w holds 2^n words, partials
// 2^(n - min(n, LOW)), counter one int that is 0 (and is 0 again after the
// kernel), w_u one word.
extern "C" int ts_eq_dot_launch(int mont32, unsigned p, unsigned pinv, const void* r, int n, void* out,
                                const void* w, void* partials, void* counter, void* w_u, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mont32) {
    const M32Ops f{{p, pinv}};
    return eq_launch<M32Ops, true>(f, f.r1, r, n, out, w, partials, counter, w_u, s);
  }
  return eq_launch<GlOps, true>(GlOps{}, (uint64_t)1, r, n, out, w, partials, counter, w_u, s);
}

// One launch of the line restriction: `blocks` tiles of 2^t polynomials
// of d + 1 coefficients in `in`, one polynomial of d + t + 1 coefficients
// per tile to `out`; with tail_t > 0 the last block also folds the next
// tail_t variables over `out` (blocks = 2^tail_t) into tail_out, taking a
// ticket on counter (one int, 0). smem_bytes of dynamic shared memory (at
// most LINE_SMEM_BYTES) must hold both tiles' tables.
extern "C" int ts_line_tile_launch(int mont32, unsigned p, unsigned pinv, const void* in, int d, int t,
                                   const void* u, const void* v, int v_is_c, void* out, unsigned blocks,
                                   int smem_bytes, int tail_t, void* tail_out, void* counter, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes > LINE_SMEM_BYTES || t < 1 || tail_t < 0 || t + tail_t > LINE_MAX_T ||
      (tail_t > 0 && blocks != (1u << tail_t)))
    return (int)cudaErrorInvalidValue;
  if (mont32)
    return line_tile_dispatch(M32Ops{{p, pinv}}, in, d, t, u, v, v_is_c, out, blocks, smem_bytes, tail_t, tail_out,
                              counter, s);
  return line_tile_dispatch(GlOps{}, in, d, t, u, v, v_is_c, out, blocks, smem_bytes, tail_t, tail_out, counter, s);
}
