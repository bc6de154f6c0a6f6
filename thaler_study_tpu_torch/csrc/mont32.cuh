// Montgomery field arithmetic for p < 2^31 (F5, F389, F1572869, BabyBear).
//
// An element is its Montgomery word x * 2^32 mod p (R = 2^32) in 32 bits,
// the JAX package's one u32 limb (thaler_study_tpu/fields/backend32.py).
// The TPU builds the 32 x 32 -> 64 product from four 16-bit multiplies;
// Hopper multiplies into 64 bits natively, and t + m * p of REDC fits a
// u64 because t < p^2 < 2^62 and m * p < 2^63. p and -p^-1 mod 2^32 are
// run-time values, so one build serves every field. The plain torch
// versions are in thaler_study_tpu_torch/fields/backend32.py.
#pragma once

#include <cstdint>

namespace m32 {

struct Field {
  uint32_t p;
  uint32_t pinv;  // -p^-1 mod 2^32

  // t * 2^-32 mod p for t < p * 2^32
  __device__ __forceinline__ uint32_t redc(uint64_t t) const {
    const uint32_t m = (uint32_t)t * pinv;
    const uint32_t u = (uint32_t)((t + (uint64_t)m * p) >> 32);
    return u >= p ? u - p : u;
  }
  __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) const {
    return redc((uint64_t)a * b);
  }
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const {
    const uint32_t s = a + b;  // < 2p < 2^32
    return s >= p ? s - p : s;
  }
  __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) const {
    return a >= b ? a - b : a + (p - b);
  }
  __device__ __forceinline__ uint32_t fold(uint32_t lo, uint32_t hi, uint32_t r) const {
    return add(lo, mul(sub(hi, lo), r));
  }
  __device__ __forceinline__ uint32_t from_mont(uint32_t a) const { return redc(a); }
  // canonical x < 2^32 -> its Montgomery word
  __device__ __forceinline__ uint32_t to_mont(uint64_t x) const {
    return (uint32_t)(((x % p) << 32) % p);
  }
  // (hi * 2^64 + lo) mod p
  __device__ __forceinline__ uint32_t reduce128(uint64_t lo, uint64_t hi) const {
    const uint64_t r64 = (uint64_t)(0x100000000ull % p);
    const uint64_t c64 = r64 * r64 % p;  // 2^64 mod p
    return (uint32_t)(((hi % p) * c64 + lo % p) % p);
  }
};

// A 128-bit sum of raw 64-bit products of Montgomery words (each
// < p^2 < 2^62, equal to R^2 x y mod p): one reduction and one REDC per
// thread instead of a REDC per product (backend32.dot_mod's lazy sum).
struct Acc {
  uint64_t lo, hi;
};

__device__ __forceinline__ void acc_add(Acc& a, uint64_t t) {
  a.lo += t;
  a.hi += a.lo < t ? 1u : 0u;
}

// R^2 * s -> the Montgomery word of s
__device__ __forceinline__ uint32_t acc_reduce(const Field& f, const Acc& a) {
  return f.redc(f.reduce128(a.lo, a.hi));
}

}  // namespace m32
