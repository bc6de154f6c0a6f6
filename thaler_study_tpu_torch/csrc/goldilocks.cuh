// Goldilocks field (p = 2^64 - 2^32 + 1) device arithmetic.
//
// One canonical element (< p) per 64-bit word. The JAX package emulates
// 64-bit words as 2 x uint32 limbs (thaler_study_tpu/fields/goldilocks.py)
// because the TPU's vector unit has no 64-bit lanes; Hopper has native
// 64-bit adds and __umul64hi, so a product is two multiplies plus the
// reduction below. Reduction uses 2^64 == 2^32 - 1 =: EPS and
// 2^96 == -1 (mod p). The plain torch versions of these functions are in
// thaler_study_tpu_torch/fields/goldilocks.py.
#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;           // 2^64 mod p
constexpr uint64_t C128 = 0xFFFFFFFE00000001ull;  // 2^128 mod p

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // a wrap lost 2^64 == EPS; a + b < 2p, so adding EPS cannot wrap again
  if (s < a) s += EPS;
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  // a borrow added 2^64 == EPS; a - b + p lies in (0, p)
  return a < b ? d - EPS : d;
}

// (hi * 2^64 + lo) mod p for any 128-bit value: with hi = (hh, hl) in
// 32-bit halves the value is == lo - hh + hl * EPS.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t hh = hi >> 32, hl = hi & EPS;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= EPS;
  const uint64_t t1 = (hl << 32) - hl;  // hl * EPS < 2^64
  uint64_t r = t0 + t1;
  if (r < t1) r += EPS;  // cannot wrap again
  return r >= P ? r - P : r;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

// lo + r * (hi - lo): the product and the add share one reduction, since
// d * r + lo <= (p - 1)^2 + (p - 1) < 2^128.
__device__ __forceinline__ uint64_t fold(uint64_t lo, uint64_t hi, uint64_t r) {
  const uint64_t d = sub(hi, lo);
  uint64_t pl = d * r;
  uint64_t ph = __umul64hi(d, r);
  pl += lo;
  ph += (pl < lo) ? 1u : 0u;
  return reduce128(pl, ph);
}

// A 192-bit sum of unreduced 128-bit products: one reduction per thread
// instead of one per product.
struct Acc {
  uint64_t lo, hi, top;
};

__device__ __forceinline__ void acc_add(Acc& a, uint64_t pl, uint64_t ph) {
  a.lo += pl;
  const uint64_t c = (a.lo < pl) ? 1u : 0u;
  uint64_t h = a.hi + ph;
  uint64_t c2 = (h < ph) ? 1u : 0u;
  h += c;
  c2 += (h < c) ? 1u : 0u;
  a.hi = h;
  a.top += c2;
}

__device__ __forceinline__ uint64_t acc_reduce(const Acc& a) {
  return add(reduce128(a.lo, a.hi), mul(a.top, C128));
}

}  // namespace gl
