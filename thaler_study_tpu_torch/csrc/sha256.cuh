// SHA-256 compression on the card, shared by the FS tail (fs_tail.cu) and
// the GKR tails (gkr_tail.cu).
//
// Replaces: thaler_study_tpu/ops/sha256.py _compress, which XLA compiles
// for the TPU. compress() is fully unrolled over a rolling 16-word
// schedule, so the state and the schedule stay in registers; load_block()
// reads a staged 64-byte block as 16 big-endian words. Its plain version is
// ops/sha256.py_compress.
#pragma once

#include <cstdint>

namespace sha256 {

static __constant__ uint32_t K256[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4,
    0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE,
    0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F,
    0x4A7484AA, 0x5CB0A9DC, 0x76F988DA, 0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC,
    0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070, 0x19A4C116,
    0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7,
    0xC67178F2};

// the initial hash value
static __constant__ uint32_t H0[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                               0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

// One SHA-256 compression of the message words w into st. w is consumed as
// the rolling schedule; every index is a compile-time constant once the
// loop is unrolled, so st and w stay in registers.
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4], f = st[5], g = st[6],
           h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[i & 15] += s0 + w[(i - 7) & 15] + s1;
    }
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + s1 + ch + K256[i] + w[i & 15];
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + s0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// the 16 big-endian words of the 64-byte block at blk (16-byte aligned)
__device__ __forceinline__ void load_block(uint32_t w[16], const uint8_t* blk) {
  const uint4* v = reinterpret_cast<const uint4*>(blk);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 x = v[i];
    w[4 * i] = __byte_perm(x.x, 0, 0x0123);
    w[4 * i + 1] = __byte_perm(x.y, 0, 0x0123);
    w[4 * i + 2] = __byte_perm(x.z, 0, 0x0123);
    w[4 * i + 3] = __byte_perm(x.w, 0, 0x0123);
  }
}

}  // namespace sha256
