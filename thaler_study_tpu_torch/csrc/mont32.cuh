// Montgomery field arithmetic for p < 2^31 (F5, F389, F1572869, BabyBear).
//
// An element is its Montgomery word x * 2^32 mod p (R = 2^32) in 32 bits,
// the JAX package's one u32 limb (thaler_study_tpu/fields/backend32.py).
// The TPU builds the 32 x 32 -> 64 product from four 16-bit multiplies;
// Hopper multiplies into 64 bits natively, and t + m * p of REDC fits a
// u64 because t < p^2 < 2^62 and m * p < 2^63. p and -p^-1 mod 2^32 are
// run-time values, so one build serves every field; the host makes R, R^2
// and R^3 mod p beside them. The plain torch versions are in
// thaler_study_tpu_torch/fields/backend32.py.
#pragma once

#include <cstdint>

namespace m32 {

struct Field {
  uint32_t p;
  uint32_t pinv;  // -p^-1 mod 2^32
  uint32_t r1, r2, r3;  // R, R^2, R^3 mod p: r1 is the Montgomery word of 1

  Field() = default;
  // Made on the host, once per launch: the powers of R take 64-bit
  // divisions, which the device would emulate.
  __host__ Field(uint32_t p_, uint32_t pinv_) : p(p_), pinv(pinv_) {
    r1 = (uint32_t)((1ull << 32) % p);
    r2 = (uint32_t)((uint64_t)r1 * r1 % p);
    r3 = (uint32_t)((uint64_t)r2 * r1 % p);
  }

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
};

// A 128-bit sum of raw 64-bit products of Montgomery words (each
// < p^2 < 2^62, equal to R^2 x y mod p): one reduction per thread instead
// of a REDC per product (backend32.dot_mod's lazy sum).
struct Acc {
  uint64_t lo, hi;
};

__device__ __forceinline__ void acc_add(Acc& a, uint64_t t) {
  a.lo += t;
  a.hi += a.lo < t ? 1u : 0u;
}

// S R^-1 mod p for S = hi 2^64 + lo (R^2 s -> the Montgomery word of s),
// from S's four 32-bit pieces: S R^-1 = redc(s0) + s1 + s2 R + s3 R^2
// (mod p), each term one REDC of a product below p 2^32, and no 64-bit
// division.
__device__ __forceinline__ uint32_t acc_reduce(const Field& f, const Acc& a) {
  uint32_t x = f.redc((uint32_t)a.lo);
  x = f.add(x, f.redc((a.lo >> 32) * f.r1));
  x = f.add(x, f.redc((uint64_t)(uint32_t)a.hi * f.r2));
  return f.add(x, f.redc((a.hi >> 32) * f.r3));
}

}  // namespace m32
