// The LibraW phase tables of one GKR layer (kernel K2): an exact modular
// scatter-add grid[key_g] += value_g mod p over the layer's gates, two
// output tables from one launch, over Goldilocks or a mont32 field.
//
// Replaces: thaler_study_tpu/gkr/device_tables.py, phase1_tables /
// phase2_tables (:361-451) around scan_add_mod_many (:192-290), the XLA
// program that sorts the per-gate values by cell, takes per-16-bit-lane
// u32 prefix sums and subtracts boundary prefixes. Its plain version is
// gkr/device_tables.phase_tables_plain.
//
// What it computes, for cells x of 2^k and gates g with eq_r[g], the
// gathered value v_g = table[gidx[g]] and the gate type mul_g:
//   PHASE 1 (key b_g, gidx c_g, table W):
//     out1[x] = sum_{g: b_g = x} (mul_g ? eq_r[g] v_g : eq_r[g])
//     out2[x] = sum_{g: b_g = x} (mul_g ? 0 : eq_r[g] v_g)
//   PHASE 2 (key c_g, gidx b_g, table eq_u):
//     out1[x] = sum_{g: c_g = x} (mul_g ? 0 : eq_r[g] v_g)
//     out2[x] = sum_{g: c_g = x} (mul_g ? eq_r[g] v_g : 0)
// Each cell is stored at bitrev_k(x), the internal MSB-first order of the
// sumcheck tables (the JAX package's lsb_to_msb, fused into the store).
//
// How: the host-side sort plan (order, starts) of gkr/circuit.scan_plan
// lists the gates of cell x at sorted positions [starts[x], starts[x+1]).
// Each cell sums its own contiguous run in a wide accumulator of
// unreduced products (192 bits for Goldilocks, 128 bits of raw Montgomery
// products for mont32) and reduces once. No atomics, no lane split and no
// bound on the fan-in: the result is exact and deterministic at any
// wiring.
//
// One thread per cell: random wiring (the flagship circuit) has a mean
// fan-in of 1, so a warp per cell would leave 31 of 32 lanes idle on
// almost every cell, while a thread per cell reads starts[] coalesced and
// keeps 32 cells in flight per warp. A skewed layer can put every gate on
// one cell; a run of more than LONG gates is therefore taken by its whole
// warp (lanes stride the run, coalesced reads of order[], a shuffle
// reduction of the reduced words), so one hot cell costs fan-in / 32
// steps, not fan-in. A single-factor contribution (eq_r alone) enters the
// accumulator as a product with the field's one.
//
// What bounds it on the H100: the gathers. Per gate it reads order[s]
// (coalesced), then eq_r[g], gidx[g], mul_g and table[gidx[g]] at random
// addresses (one 32-byte sector each).
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LONG = 32;  // runs longer than this are reduced by a warp

struct GlOps {
  using word = uint64_t;
  using Acc = gl::Acc;
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
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

template <class F>
struct Args {
  using W = typename F::word;
  const int* __restrict__ order;
  const int* __restrict__ starts;
  const int* __restrict__ gidx;
  const bool* __restrict__ is_mul;
  const W* __restrict__ eq_r;
  const W* __restrict__ table;
  W* __restrict__ out1;
  W* __restrict__ out2;
  W one;
  int size, k;
};

// gate g's contributions to the two cells' accumulators
template <class F, int PHASE>
__device__ __forceinline__ void contribute(const F& f, const Args<F>& a, int g, typename F::Acc& acc1,
                                           typename F::Acc& acc2) {
  const typename F::word e = a.eq_r[g];
  const typename F::word v = a.table[a.gidx[g]];
  const bool mul = a.is_mul[g];
  if (PHASE == 1) {
    if (mul) {
      f.acc_add(acc1, e, v);
    } else {
      f.acc_add(acc1, e, a.one);
      f.acc_add(acc2, e, v);
    }
  } else if (mul) {  // two calls, not one on a selected reference: keeps both sums in registers
    f.acc_add(acc2, e, v);
  } else {
    f.acc_add(acc1, e, v);
  }
}

template <class F>
__device__ __forceinline__ void store(const Args<F>& a, int x, typename F::word y1, typename F::word y2) {
  const int pos = a.k == 0 ? 0 : (int)(__brev((unsigned)x) >> (32 - a.k));
  a.out1[pos] = y1;
  a.out2[pos] = y2;
}

// grid = ceil(size / THREADS) blocks; thread x owns cell x
template <class F, int PHASE>
__global__ void __launch_bounds__(THREADS) phase_tables_kernel(F f, Args<F> a) {
  using W = typename F::word;
  const int x = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int s0 = 0, s1 = 0;
  if (x < a.size) {
    s0 = a.starts[x];
    s1 = a.starts[x + 1];
  }
  const bool is_long = s1 - s0 > LONG;
  if (x < a.size && !is_long) {
    typename F::Acc acc1{}, acc2{};
    for (int s = s0; s < s1; ++s) contribute<F, PHASE>(f, a, a.order[s], acc1, acc2);
    store(a, x, f.acc_reduce(acc1), f.acc_reduce(acc2));
  }
  // long runs: one at a time, by the whole warp
  unsigned pending = __ballot_sync(0xffffffffu, is_long);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const int c0 = __shfl_sync(0xffffffffu, s0, src);
    const int c1 = __shfl_sync(0xffffffffu, s1, src);
    const int cx = __shfl_sync(0xffffffffu, x, src);
    typename F::Acc acc1{}, acc2{};
    for (int s = c0 + lane; s < c1; s += 32) contribute<F, PHASE>(f, a, a.order[s], acc1, acc2);
    W y1 = f.acc_reduce(acc1), y2 = f.acc_reduce(acc2);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      y1 = f.add(y1, shfl_down(y1, off));
      y2 = f.add(y2, shfl_down(y2, off));
    }
    if (lane == 0) store(a, cx, y1, y2);
  }
}

template <class F>
int launch(const F& f, int phase, const void* order, const void* starts, const void* gidx,
           const void* is_mul, const void* eq_r, const void* table, void* out1, void* out2, int size,
           int k, typename F::word one, cudaStream_t stream) {
  using W = typename F::word;
  Args<F> a{static_cast<const int*>(order), static_cast<const int*>(starts),
            static_cast<const int*>(gidx),  static_cast<const bool*>(is_mul),
            static_cast<const W*>(eq_r),    static_cast<const W*>(table),
            static_cast<W*>(out1),          static_cast<W*>(out2),
            one,                            size,
            k};
  const int blocks = (size + THREADS - 1) / THREADS;
  if (phase == 1)
    phase_tables_kernel<F, 1><<<blocks, THREADS, 0, stream>>>(f, a);
  else if (phase == 2)
    phase_tables_kernel<F, 2><<<blocks, THREADS, 0, stream>>>(f, a);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). mont32 = 0
// takes Goldilocks int64 words; mont32 = 1 takes Montgomery words of the
// field with modulus p < 2^31 and pinv = -p^-1 mod 2^32. order, starts and
// gidx are int32, is_mul is bool (one byte); out1 and out2 hold size = 2^k
// words each (the wrapper checks every argument first).
extern "C" int ts_phase_tables_launch(int mont32, unsigned p, unsigned pinv, int phase,
                                      const void* order, const void* starts, const void* gidx,
                                      const void* is_mul, const void* eq_r, const void* table,
                                      void* out1, void* out2, int size, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      mont32 ? launch(M32Ops{{p, pinv}}, phase, order, starts, gidx, is_mul, eq_r, table, out1, out2,
                      size, k, (uint32_t)((1ull << 32) % p), s)
             : launch(GlOps{}, phase, order, starts, gidx, is_mul, eq_r, table, out1, out2, size, k,
                      (uint64_t)1, s);
  return rc ? rc : (int)cudaGetLastError();
}
