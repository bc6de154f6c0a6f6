// The per-round tail of the batched Fiat-Shamir sumcheck prover, one thread
// per proof.
//
// Replaces: the per-round scalar code of thaler_study_tpu/ops/fs_kernel.py
// _fs_prove_impl (:220), which XLA compiles for the TPU: the round-sum
// reduction and s(1) = claim - s(0) (ops/round_kernel._round_sums claim
// shortcut), _interp_coeffs (:106), _any_zero_coeffs (:182),
// _absorb_round_msg (:188) with DevChain.absorb (ops/sha_chain.py:116),
// DevChain._finish_b0 / draw_uniform (:157, :214), _gl_from_be_words
// (:249) and _claim_at (:153). Its plain version is
// ops/fs_kernel.fs_tail_plain.
//
// Per round j and proof b it: sums the round kernel's per-block partials
// mod p; fills s(1) = claim[b] - s(0) for j > 0; interpolates the d + 1
// coefficients with the inverse-Vandermonde constants vinv; ORs the
// zero-coefficient flag; writes c_1 (j = 0) and the coefficient row;
// serializes the arkworks message into the carried SHA-256 chain; and,
// unless it is the last round, finishes expand_message_xmd into the next
// challenge r[b] and the next claim[b] = g_j(r[b]) by Horner.
//
// What bounds it: latency. It moves a few hundred bytes per proof; each
// SHA-256 compression is a serial 64-step chain. Written as eager torch
// ops that would be ~10^5 launches per proof batch, so the whole tail is
// one launch per round, and the host reads nothing inside the round loop.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

__constant__ uint32_t K256[64] = {
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

__device__ const uint32_t H0[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                                   0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__device__ void compress(uint32_t st[8], const uint8_t* blk) {
  uint32_t w[64];
  for (int i = 0; i < 16; ++i) {
    w[i] = (uint32_t)blk[4 * i] << 24 | (uint32_t)blk[4 * i + 1] << 16 |
           (uint32_t)blk[4 * i + 2] << 8 | (uint32_t)blk[4 * i + 3];
  }
  for (int i = 16; i < 64; ++i) {
    const uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    const uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4], f = st[5], g = st[6],
           h = st[7];
  for (int i = 0; i < 64; ++i) {
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + s1 + ch + K256[i] + w[i];
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = s0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
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

__device__ __forceinline__ void put_le64(uint8_t* out, int& m, uint64_t v) {
  for (int q = 0; q < 8; ++q) out[m++] = (uint8_t)(v >> (8 * q));
}

// hash_to_field::<1> for Goldilocks with the empty DST over a transcript of
// `total` bytes whose chain is (mid, tail[0:fill]).
__device__ uint64_t draw_gl(const uint32_t mid[8], const uint8_t tail[64], int fill,
                            long long total) {
  // b_0 = SHA-256(Z_pad || transcript || I2OSP(24, 2) || 0x00 || DST'),
  // DST' = [0]: finish a copy of the midstate over the tail and suffix
  uint32_t st[8];
  for (int i = 0; i < 8; ++i) st[i] = mid[i];
  uint8_t blk[128];
  for (int q = 0; q < 128; ++q) blk[q] = 0;
  for (int q = 0; q < fill; ++q) blk[q] = tail[q];
  blk[fill + 1] = 24;
  blk[fill + 4] = 0x80;
  const int nblk = fill + 5 <= 56 ? 1 : 2;
  const uint64_t bits = (uint64_t)(64 + total + 4) * 8;
  for (int q = 0; q < 8; ++q) blk[64 * nblk - 1 - q] = (uint8_t)(bits >> (8 * q));
  compress(st, blk);
  if (nblk == 2) compress(st, blk + 64);
  // b_1 = SHA-256(b_0 || 0x01 || DST'): one padded block of 34 bytes
  uint8_t b1[64];
  for (int q = 0; q < 64; ++q) b1[q] = 0;
  for (int i = 0; i < 8; ++i) {
    for (int q = 0; q < 4; ++q) b1[4 * i + q] = (uint8_t)(st[i] >> (24 - 8 * q));
  }
  b1[32] = 1;
  b1[34] = 0x80;
  b1[62] = (34 * 8) >> 8;
  b1[63] = (34 * 8) & 0xFF;
  uint32_t h[8];
  for (int i = 0; i < 8; ++i) h[i] = H0[i];
  compress(h, b1);
  // the first 24 uniform bytes, big-endian, reduced mod p:
  // (w0 w1) * 2^128 + (w2 w3) * 2^64 + (w4 w5)
  uint64_t x[3];
  for (int i = 0; i < 3; ++i) {
    const uint64_t v = (uint64_t)h[2 * i] << 32 | h[2 * i + 1];
    x[i] = v >= gl::P ? v - gl::P : v;
  }
  return gl::add(gl::add(x[2], gl::mul(x[1], gl::EPS)), gl::mul(x[0], gl::C128));
}

template <int D>
__global__ void fs_tail_kernel(const uint64_t* __restrict__ partials, int blocks,
                               uint32_t* __restrict__ state, uint8_t* __restrict__ buf,
                               uint64_t* __restrict__ claim, uint64_t* __restrict__ r,
                               uint64_t* __restrict__ c1, uint64_t* __restrict__ coeffs,
                               int ncoef, int coeff_off, int* __restrict__ any_zero,
                               const uint64_t* __restrict__ vinv, int batch, int round,
                               long long nbytes, int draw) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;

  uint64_t s[D + 1];
  for (int e = 0; e <= D; ++e) s[e] = 0;
  const uint64_t* pp = partials + (long long)b * blocks * (D + 1);
  for (int x = 0; x < blocks; ++x) {
    for (int e = 0; e <= D; ++e) s[e] = gl::add(s[e], pp[x * (D + 1) + e]);
  }
  if (round > 0) s[1] = gl::sub(claim[b], s[0]);

  uint64_t c[D + 1];
  int zero = 0;
  for (int i = 0; i <= D; ++i) {
    uint64_t acc = 0;
    for (int t = 0; t <= D; ++t) acc = gl::add(acc, gl::mul(vinv[i * (D + 1) + t], s[t]));
    c[i] = acc;
    zero |= acc == 0;
    coeffs[(long long)b * ncoef + coeff_off + i] = acc;
  }
  any_zero[b] |= zero;

  // the round message: [c_1 on round 0] || len || (degree, coeff) terms
  uint8_t msg[8 + 8 + 16 * (D + 1)];
  int m = 0;
  if (round == 0) {
    const uint64_t v = gl::add(s[0], s[1]);
    c1[b] = v;
    put_le64(msg, m, v);
  }
  put_le64(msg, m, D + 1);
  for (int t = 0; t <= D; ++t) {
    put_le64(msg, m, t);
    put_le64(msg, m, c[t]);
  }

  uint32_t st[8];
  uint8_t tail[64];
  for (int i = 0; i < 8; ++i) st[i] = state[b * 8 + i];
  for (int q = 0; q < 64; ++q) tail[q] = buf[b * 64 + q];
  int fill = (int)(nbytes % 64);
  for (int q = 0; q < m; ++q) {
    tail[fill++] = msg[q];
    if (fill == 64) {
      compress(st, tail);
      fill = 0;
    }
  }
  for (int q = fill; q < 64; ++q) tail[q] = 0;
  for (int i = 0; i < 8; ++i) state[b * 8 + i] = st[i];
  for (int q = 0; q < 64; ++q) buf[b * 64 + q] = tail[q];

  if (draw) {
    const uint64_t rv = draw_gl(st, tail, fill, nbytes + m);
    r[b] = rv;
    uint64_t h = c[D];
    for (int i = D - 1; i >= 0; --i) h = gl::add(gl::mul(h, rv), c[i]);
    claim[b] = h;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); degree must
// be 2 or 3 (the wrapper checks every argument first).
extern "C" int ts_fs_tail_launch(int degree, const void* partials, int blocks, void* state,
                                 void* buf, void* claim, void* r, void* c1, void* coeffs,
                                 int ncoef, int coeff_off, void* any_zero, const void* vinv,
                                 int batch, int round, long long nbytes, int draw,
                                 void* stream) {
  constexpr int TPB = 64;
  const dim3 grid((batch + TPB - 1) / TPB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TS_FS_TAIL_ARGS                                                                     \
  static_cast<const uint64_t*>(partials), blocks, static_cast<uint32_t*>(state),             \
      static_cast<uint8_t*>(buf), static_cast<uint64_t*>(claim), static_cast<uint64_t*>(r), \
      static_cast<uint64_t*>(c1), static_cast<uint64_t*>(coeffs), ncoef, coeff_off,          \
      static_cast<int*>(any_zero), static_cast<const uint64_t*>(vinv), batch, round, nbytes, \
      draw
  if (degree == 2) fs_tail_kernel<2><<<grid, TPB, 0, s>>>(TS_FS_TAIL_ARGS);
  else if (degree == 3) fs_tail_kernel<3><<<grid, TPB, 0, s>>>(TS_FS_TAIL_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef TS_FS_TAIL_ARGS
  return (int)cudaGetLastError();
}
