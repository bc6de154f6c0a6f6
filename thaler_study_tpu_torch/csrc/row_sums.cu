// Sums of round-sum rows on the card: the sharded prover's reduction,
// one block per launch, over Goldilocks or a mont32 field (p < 2^31).
//
// Replaces: the reduction that GSPMD inserts into the JAX package's sharded
// rounds (thaler_study_tpu/parallel/sharded.py _sums2d :101, _mb_sums :548,
// whose psum sum_mod(force_lanes=True) makes exact), where the port's
// parallel/sharded.collective("sum") has rows to reduce on a device other
// than the first, or across processes: R rows of D1 round sums become one
// row. Its plain version is ops/row_sums.row_sums_plain.
//
// Modes. IN_LANES = 0: the rows are field words (Goldilocks canonical u64,
// mont32 Montgomery words) and are summed mod p. IN_LANES = 1: the rows
// are int64 lane sums from a torch.distributed all_reduce: Goldilocks two
// rows, the low and the high 32 bits of the processes' words summed as
// integers (each below W 2^32 < 2^63 <= p for W < 2^31 processes), so the
// sum is lo + 2^32 hi mod p; mont32 one row, the words summed as
// integers, reduced mod p. OUT_LANES = 1 writes the sum as those lanes
// (int64 rows) for the all_reduce; OUT_LANES = 0 as one row of words.
//
// What bounds it: latency. R is a device's shard rows' partials (up to a
// few thousand rows of D1 <= 9 words) or two lanes; 256 threads stride the
// rows with one add each and reduce through shared memory. The floor
// beside its time is one launch of empty_kernel (one block of THREADS
// threads that does nothing), timed the same way.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_D1 = 9;  // round degree 8 (multiblock_round.cu MAX_D)

struct GlOps {
  using word = uint64_t;
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
  // lo + 2^32 hi mod p from lane sums below 2^63 (canonical words)
  __device__ __forceinline__ word from_lanes(const long long* in, int d1, int c) const {
    return gl::add((word)in[c], gl::mul((word)in[d1 + c], 1ull << 32));
  }
  __device__ __forceinline__ void to_lanes(word x, long long* out, int d1, int c) const {
    out[c] = (long long)(x & 0xFFFFFFFFull);
    out[d1 + c] = (long long)(x >> 32);
  }
};

struct M32Ops : m32::Field {
  using word = uint32_t;
  __device__ __forceinline__ word from_lanes(const long long* in, int, int c) const {
    return (word)((unsigned long long)in[c] % p);
  }
  __device__ __forceinline__ void to_lanes(word x, long long* out, int, int c) const { out[c] = (long long)x; }
};

__device__ __forceinline__ uint32_t shfl_xor(uint32_t x, int off) { return __shfl_xor_sync(0xffffffffu, x, off); }
__device__ __forceinline__ uint64_t shfl_xor(uint64_t x, int off) {
  return (uint64_t)__shfl_xor_sync(0xffffffffu, (unsigned long long)x, off);
}

template <class F, bool IN_LANES, bool OUT_LANES>
__global__ void __launch_bounds__(THREADS)
    row_sums_kernel(F f, const void* __restrict__ in, int rows, int d1, void* __restrict__ out) {
  using W = typename F::word;
  __shared__ W part[THREADS / 32][MAX_D1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  W s[MAX_D1];
#pragma unroll
  for (int c = 0; c < MAX_D1; ++c) s[c] = 0;
  if (IN_LANES) {
    if (threadIdx.x < d1) s[0] = f.from_lanes(static_cast<const long long*>(in), d1, threadIdx.x);
  } else {
    const W* w = static_cast<const W*>(in);
    for (int r = threadIdx.x; r < rows; r += THREADS) {
#pragma unroll
      for (int c = 0; c < MAX_D1; ++c)
        if (c < d1) s[c] = f.add(s[c], w[(long long)r * d1 + c]);
    }
  }
  if (IN_LANES) {  // thread c holds column c
    if (threadIdx.x < d1) part[0][threadIdx.x] = s[0];
    __syncthreads();
  } else {
#pragma unroll
    for (int c = 0; c < MAX_D1; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[c] = f.add(s[c], shfl_xor(s[c], off));
      if (lane == 0) part[warp][c] = s[c];
    }
    __syncthreads();
    if (threadIdx.x < d1) {
      W x = 0;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) x = f.add(x, part[w][threadIdx.x]);
      part[0][threadIdx.x] = x;
    }
    __syncthreads();
  }
  if (threadIdx.x < d1) {
    const W x = part[0][threadIdx.x];
    if (OUT_LANES) {
      f.to_lanes(x, static_cast<long long*>(out), d1, threadIdx.x);
    } else {
      static_cast<W*>(out)[threadIdx.x] = x;
    }
  }
}

template <class F>
int launch(const F& f, const void* in, int rows, int d1, int in_lanes, int out_lanes, void* out, cudaStream_t s) {
  if (d1 < 1 || d1 > MAX_D1 || rows < 0) return (int)cudaErrorInvalidValue;
  if (in_lanes && out_lanes) return (int)cudaErrorInvalidValue;
  if (in_lanes) row_sums_kernel<F, true, false><<<1, THREADS, 0, s>>>(f, in, rows, d1, out);
  else if (out_lanes) row_sums_kernel<F, false, true><<<1, THREADS, 0, s>>>(f, in, rows, d1, out);
  else row_sums_kernel<F, false, false><<<1, THREADS, 0, s>>>(f, in, rows, d1, out);
  return 0;
}

__global__ void empty_kernel() {}

}  // namespace

// One launch of a kernel that does nothing (one block of THREADS threads):
// the latency floor of a one-block launch. Returns cudaGetLastError().
extern "C" int ts_empty_launch(void* stream) {
  empty_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// in: rows >= 0 x d1 field words (in_lanes = 0; no row sums to 0) or the
// lanes of one row (int64; 2 rows Goldilocks, 1 mont32); out: d1 words
// (out_lanes = 0) or the sum's lanes (int64, laid out as in_lanes reads
// them). mont32 = 1 takes the
// field with modulus p and pinv = -p^-1 mod 2^32. Returns cudaGetLastError()
// after the launch (0 = launched); the wrapper checks every argument first.
extern "C" int ts_row_sums_launch(int mont32, unsigned p, unsigned pinv, const void* in, int rows, int d1,
                                  int in_lanes, int out_lanes, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = mont32 ? launch(M32Ops{{p, pinv}}, in, rows, d1, in_lanes, out_lanes, out, s)
                        : launch(GlOps{}, in, rows, d1, in_lanes, out_lanes, out, s);
  return rc ? rc : (int)cudaGetLastError();
}
