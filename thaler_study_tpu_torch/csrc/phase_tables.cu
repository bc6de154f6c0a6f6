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
// gathered value v_g = table[gidx_g] and the gate type mul_g:
//   PHASE 1 (key b_g, gidx c_g, table W):
//     out1[x] = sum_{g: b_g = x} (mul_g ? eq_r[g] v_g : eq_r[g])
//     out2[x] = sum_{g: b_g = x} (mul_g ? 0 : eq_r[g] v_g)
//   PHASE 2 (key c_g, gidx b_g, table eq_u):
//     out1[x] = sum_{g: c_g = x} (mul_g ? 0 : eq_r[g] v_g)
//     out2[x] = sum_{g: c_g = x} (mul_g ? eq_r[g] v_g : 0)
// Cell x is stored at pos = bitrev_k(x), the internal MSB-first order of
// the sumcheck tables (the JAX package's lsb_to_msb).
//
// How: everything that depends only on the circuit is a static plan made
// once per circuit (gkr/circuit.PhasePlan), keyed on pos rather than on x:
// order[] lists the gates of output position pos at [starts[pos],
// starts[pos + 1]), and packed[] holds, in that order, the gather index of
// each listed gate with its type in bit 31. Thread pos reads starts[]
// coalesced, walks its contiguous run (order[] and packed[] read in
// sequence, two gates per step so that four loads are in flight), and
// writes out1[pos] and out2[pos] coalesced: no bit reversal, no scatter and
// no dependent chain of index loads is left in the kernel. Each position
// sums its run in a wide accumulator of unreduced products (192 bits for
// Goldilocks, 128 bits of raw Montgomery products for mont32) and reduces
// once: no atomics, exact and deterministic at any wiring; an empty run
// writes 0.
//
// One thread per position: random wiring (the flagship circuit) has a mean
// fan-in of 1, so a warp per position would leave 31 of 32 lanes idle on
// almost every one. A skewed layer can put every gate on one cell; a run
// of more than LONG gates is therefore taken by its whole warp (lanes
// stride the run, a shuffle reduction of the reduced words), so one hot
// cell costs fan-in / 32 steps, not fan-in. A single-factor contribution
// (eq_r alone) enters the accumulator as a product with the field's one.
//
// What bounds it on the H100: per gate two random reads, eq_r[order[s]]
// and table[gidx], one 32-byte sector each; both tables (8 MB each at
// 2^20 Goldilocks words) stay in the 50 MB L2. Device memory moves the two
// outputs, the plan (order, packed, starts) and each table once.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LONG = 32;  // runs longer than this are reduced by a warp
constexpr int GIDX = 0x7fffffff;  // packed[]: the gather index below bit 31

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
  const int* __restrict__ packed;
  const W* __restrict__ eq_r;
  const W* __restrict__ table;
  W* __restrict__ out1;
  W* __restrict__ out2;
  W one;
  int size;
};

// one gate's contributions to the two accumulators: e = eq_r[g], v the
// gathered value, mul the gate type
template <class F, int PHASE>
__device__ __forceinline__ void contribute(const F& f, typename F::word one, typename F::word e,
                                           typename F::word v, bool mul, typename F::Acc& acc1,
                                           typename F::Acc& acc2) {
  if (PHASE == 1) {
    if (mul) {
      f.acc_add(acc1, e, v);
    } else {
      f.acc_add(acc1, e, one);
      f.acc_add(acc2, e, v);
    }
  } else if (mul) {  // two calls, not one on a selected reference: keeps both sums in registers
    f.acc_add(acc2, e, v);
  } else {
    f.acc_add(acc1, e, v);
  }
}

// grid = ceil(size / THREADS) blocks; thread pos owns output position pos
template <class F, int PHASE>
__global__ void __launch_bounds__(THREADS) phase_tables_kernel(F f, Args<F> a) {
  using W = typename F::word;
  const int pos = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int s0 = 0, s1 = 0;
  if (pos < a.size) {
    s0 = a.starts[pos];
    s1 = a.starts[pos + 1];
  }
  const bool is_long = s1 - s0 > LONG;
  if (pos < a.size && !is_long) {
    typename F::Acc acc1{}, acc2{};
    for (int s = s0; s < s1; s += 2) {
      // two gates per step (the second repeats the first past the run's
      // end and is not added): their four gathers are issued together
      const int t = s + 1 < s1 ? s + 1 : s;
      const int g0 = a.order[s], g1 = a.order[t];
      const int w0 = a.packed[s], w1 = a.packed[t];
      const W e0 = a.eq_r[g0], e1 = a.eq_r[g1];
      const W v0 = a.table[w0 & GIDX], v1 = a.table[w1 & GIDX];
      contribute<F, PHASE>(f, a.one, e0, v0, w0 < 0, acc1, acc2);
      if (t != s) contribute<F, PHASE>(f, a.one, e1, v1, w1 < 0, acc1, acc2);
    }
    a.out1[pos] = f.acc_reduce(acc1);
    a.out2[pos] = f.acc_reduce(acc2);
  }
  // long runs: one at a time, by the whole warp
  unsigned pending = __ballot_sync(0xffffffffu, is_long);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const int c0 = __shfl_sync(0xffffffffu, s0, src);
    const int c1 = __shfl_sync(0xffffffffu, s1, src);
    const int cpos = __shfl_sync(0xffffffffu, pos, src);
    typename F::Acc acc1{}, acc2{};
    for (int s = c0 + lane; s < c1; s += 32) {
      const int w = a.packed[s];
      contribute<F, PHASE>(f, a.one, a.eq_r[a.order[s]], a.table[w & GIDX], w < 0, acc1, acc2);
    }
    W y1 = f.acc_reduce(acc1), y2 = f.acc_reduce(acc2);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      y1 = f.add(y1, shfl_down(y1, off));
      y2 = f.add(y2, shfl_down(y2, off));
    }
    if (lane == 0) {
      a.out1[cpos] = y1;
      a.out2[cpos] = y2;
    }
  }
}

template <class F>
int launch(const F& f, int phase, const void* order, const void* starts, const void* packed, const void* eq_r,
           const void* table, void* out1, void* out2, int size, typename F::word one, cudaStream_t stream) {
  using W = typename F::word;
  Args<F> a{static_cast<const int*>(order), static_cast<const int*>(starts), static_cast<const int*>(packed),
            static_cast<const W*>(eq_r),    static_cast<const W*>(table),    static_cast<W*>(out1),
            static_cast<W*>(out2),          one,                             size};
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
// packed are the int32 arrays of a gkr/circuit.PhasePlan; out1 and out2
// hold size = 2^k words each, written in position order (the wrapper
// checks every argument first).
extern "C" int ts_phase_tables_launch(int mont32, unsigned p, unsigned pinv, int phase, const void* order,
                                      const void* starts, const void* packed, const void* eq_r, const void* table,
                                      void* out1, void* out2, int size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = mont32 ? launch(M32Ops{{p, pinv}}, phase, order, starts, packed, eq_r, table, out1, out2, size,
                                 (uint32_t)((1ull << 32) % p), s)
                        : launch(GlOps{}, phase, order, starts, packed, eq_r, table, out1, out2, size,
                                 (uint64_t)1, s);
  return rc ? rc : (int)cudaGetLastError();
}
