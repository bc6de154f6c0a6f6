// One layer of the GKR forward pass, over Goldilocks or a mont32 field
// (p < 2^31): out[g] = mul_g ? cur[b_g] * cur[c_g] : cur[b_g] + cur[c_g].
//
// Replaces: thaler_study_tpu/gkr/circuit.py evaluate_device (:155; its
// layer_step :166, two gathers, a product, an add and a select per layer
// in jnp, which XLA compiles for the TPU). Its plain version is
// ops/forward_kernel.forward_layer_plain (two index_selects, the product,
// the add and a where, in plain torch).
//
// What bounds it on the H100: the bytes, each gate's two int32 labels and
// its type byte read once, its value written once, and the previous layer
// read (2^20 gates over Goldilocks: 8 MB of labels, 1 MB of types, 8 MB
// written, the previous layer's 8 MB mostly from L2: ~25 MB, ~7.5 us at
// 3.35 TB/s). One thread per gate: the labels, types and outputs move
// coalesced; the two gathers are random reads of the previous layer, which
// stays in the 50 MB L2 between layers. One launch per layer.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned MAX_BLOCKS = 132 * 16;  // a grid-stride loop beyond 16 blocks per SM

struct GlOps {
  using word = uint64_t;
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
  __device__ __forceinline__ word mul(word a, word b) const { return gl::mul(a, b); }
};

struct M32Ops : m32::Field {
  using word = uint32_t;
};

template <class F>
__global__ void __launch_bounds__(THREADS)
    forward_kernel(F f, const typename F::word* __restrict__ cur, const int* __restrict__ b,
                   const int* __restrict__ c, const unsigned char* __restrict__ is_mul,
                   typename F::word* __restrict__ out, long long gates) {
  using W = typename F::word;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x; g < gates; g += (long long)gridDim.x * THREADS) {
    const W x = cur[b[g]], y = cur[c[g]];
    out[g] = is_mul[g] ? f.mul(x, y) : f.add(x, y);
  }
}

template <class F>
int forward_launch(F f, const void* cur, const void* b, const void* c, const void* is_mul, void* out, long long gates,
                   cudaStream_t s) {
  using W = typename F::word;
  const long long need = (gates + THREADS - 1) / THREADS;
  const unsigned blocks = need < MAX_BLOCKS ? (unsigned)need : MAX_BLOCKS;
  forward_kernel<F><<<blocks, THREADS, 0, s>>>(f, static_cast<const W*>(cur), static_cast<const int*>(b),
                                               static_cast<const int*>(c), static_cast<const unsigned char*>(is_mul),
                                               static_cast<W*>(out), gates);
  return (int)cudaGetLastError();
}

}  // namespace

// One layer: cur holds the next layer's values (every label of b and c
// indexes it: the wrapper checks), b and c `gates` int32 labels, is_mul
// `gates` bytes (0 = ADD, 1 = MUL), out `gates` words. mont32 = 0 takes
// Goldilocks words; mont32 = 1 Montgomery words of the field with modulus
// p < 2^31 and pinv = -p^-1 mod 2^32. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int ts_forward_launch(int mont32, unsigned p, unsigned pinv, const void* cur, const void* b, const void* c,
                                 const void* is_mul, void* out, long long gates, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gates < 1) return (int)cudaErrorInvalidValue;
  if (mont32) return forward_launch(M32Ops{{p, pinv}}, cur, b, c, is_mul, out, gates, s);
  return forward_launch(GlOps{}, cur, b, c, is_mul, out, gates, s);
}
