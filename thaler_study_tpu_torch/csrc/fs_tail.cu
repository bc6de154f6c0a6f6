// The per-round tail of the batched Fiat-Shamir sumcheck prover, one thread
// per proof, over Goldilocks or a mont32 field (p < 2^31).
//
// Replaces: the per-round scalar code of thaler_study_tpu/ops/fs_kernel.py
// _fs_prove_impl (:220), which XLA compiles for the TPU: the round-sum
// reduction and s(1) = claim - s(0) (ops/round_kernel._round_sums claim
// shortcut), _interp_coeffs (:106), _any_zero_coeffs (:182),
// _absorb_round_msg (:188) with DevChain.absorb (ops/sha_chain.py:116),
// DevChain._finish_b0 / draw_uniform (:157, :214), hash_to_field_chain
// (:264: _gl_from_be_words for Goldilocks, the big-endian Horner lifted
// to Montgomery form for mont32) and _claim_at (:153). Its plain version
// is ops/fs_kernel.fs_tail_plain.
//
// Per round j and proof b it: sums the round kernel's per-block partials
// mod p; fills s(1) = claim[b] - s(0) for j > 0; interpolates the d + 1
// coefficients with the inverse-Vandermonde constants vinv; ORs the
// zero-coefficient flag; writes c_1 (j = 0) and the coefficient row as
// canonical values; serializes the arkworks message (byte_size
// little-endian bytes per element) into the carried SHA-256 chain; and,
// unless it is the last round, finishes expand_message_xmd
// (len_in_bytes uniform bytes) into the next challenge r[b] and the next
// claim[b] = g_j(r[b]) by Horner. For a mont32 field the sums, vinv, r and
// the claim are Montgomery words, as in the JAX package; only what is
// serialized and stored for the host is canonical.
//
// What bounds it: latency. It moves a few hundred bytes per proof; each
// SHA-256 compression is a serial 64-step chain. Written as eager torch
// ops that would be ~10^5 launches per proof batch, so the whole tail is
// one launch per round, and the host reads nothing inside the round loop.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

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

__device__ __forceinline__ void put_le(uint8_t* out, int& m, uint64_t v, int bytes) {
  for (int q = 0; q < bytes; ++q) out[m++] = (uint8_t)(v >> (8 * q));
}

// The field as the tail sees it: arithmetic on its words, the canonical
// value of a word, and the element drawn from the uniform bytes of b_1.
struct GlOps {
  using word = uint64_t;
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
  __device__ __forceinline__ word sub(word a, word b) const { return gl::sub(a, b); }
  __device__ __forceinline__ word mul(word a, word b) const { return gl::mul(a, b); }
  __device__ __forceinline__ word canonical(word a) const { return a; }
  // the first 24 uniform bytes, big-endian, reduced mod p:
  // (w0 w1) * 2^128 + (w2 w3) * 2^64 + (w4 w5)
  __device__ word from_uniform(const uint32_t h[8], int) const {
    uint64_t x[3];
    for (int i = 0; i < 3; ++i) {
      const uint64_t v = (uint64_t)h[2 * i] << 32 | h[2 * i + 1];
      x[i] = v >= gl::P ? v - gl::P : v;
    }
    return gl::add(gl::add(x[2], gl::mul(x[1], gl::EPS)), gl::mul(x[0], gl::C128));
  }
};

struct M32Ops : m32::Field {
  using word = uint32_t;
  __device__ __forceinline__ word canonical(word a) const { return from_mont(a); }
  // the first len uniform bytes, big-endian, mod p, as a Montgomery word
  __device__ word from_uniform(const uint32_t h[8], int len) const {
    uint64_t acc = 0;
    for (int q = 0; q < len; ++q) acc = (acc * 256 + ((h[q / 4] >> (24 - 8 * (q % 4))) & 0xFF)) % p;
    return to_mont(acc);
  }
};

// hash_to_field::<1> with the empty DST over a transcript of `total` bytes
// whose chain is (mid, tail[0:fill]); len uniform bytes (<= 32: one b_1).
template <class F>
__device__ typename F::word draw(const F& f, const uint32_t mid[8], const uint8_t tail[64],
                                 int fill, long long total, int len) {
  // b_0 = SHA-256(Z_pad || transcript || I2OSP(len, 2) || 0x00 || DST'),
  // DST' = [0]: finish a copy of the midstate over the tail and suffix
  uint32_t st[8];
  for (int i = 0; i < 8; ++i) st[i] = mid[i];
  uint8_t blk[128];
  for (int q = 0; q < 128; ++q) blk[q] = 0;
  for (int q = 0; q < fill; ++q) blk[q] = tail[q];
  blk[fill] = (uint8_t)(len >> 8);
  blk[fill + 1] = (uint8_t)len;
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
  return f.from_uniform(h, len);
}

template <class F, int D>
__global__ void fs_tail_kernel(F f, int byte_size, int len,
                               const typename F::word* __restrict__ partials, int blocks,
                               uint32_t* __restrict__ state, uint8_t* __restrict__ buf,
                               typename F::word* __restrict__ claim, typename F::word* __restrict__ r,
                               typename F::word* __restrict__ c1,
                               typename F::word* __restrict__ coeffs, int ncoef, int coeff_off,
                               int* __restrict__ any_zero, const typename F::word* __restrict__ vinv,
                               int batch, int round, long long nbytes, int draw_next) {
  using W = typename F::word;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;

  W s[D + 1];
  for (int e = 0; e <= D; ++e) s[e] = 0;
  const W* pp = partials + (long long)b * blocks * (D + 1);
  for (int x = 0; x < blocks; ++x) {
    for (int e = 0; e <= D; ++e) s[e] = f.add(s[e], pp[x * (D + 1) + e]);
  }
  if (round > 0) s[1] = f.sub(claim[b], s[0]);

  W c[D + 1];
  int zero = 0;
  for (int i = 0; i <= D; ++i) {
    W acc = 0;
    for (int t = 0; t <= D; ++t) acc = f.add(acc, f.mul(vinv[i * (D + 1) + t], s[t]));
    c[i] = acc;
    zero |= acc == 0;
    coeffs[(long long)b * ncoef + coeff_off + i] = f.canonical(acc);
  }
  any_zero[b] |= zero;

  // the round message: [c_1 on round 0] || len || (degree, coeff) terms
  uint8_t msg[8 + 8 + 16 * (D + 1)];
  int m = 0;
  if (round == 0) {
    const W v = f.canonical(f.add(s[0], s[1]));
    c1[b] = v;
    put_le(msg, m, v, byte_size);
  }
  put_le(msg, m, D + 1, 8);
  for (int t = 0; t <= D; ++t) {
    put_le(msg, m, t, 8);
    put_le(msg, m, f.canonical(c[t]), byte_size);
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

  if (draw_next) {
    const W rv = draw(f, st, tail, fill, nbytes + m, len);
    r[b] = rv;
    W h = c[D];
    for (int i = D - 1; i >= 0; --i) h = f.add(f.mul(h, rv), c[i]);
    claim[b] = h;
  }
}

template <class F>
int launch(const F& f, int byte_size, int len, int degree, const void* partials, int blocks,
           void* state, void* buf, void* claim, void* r, void* c1, void* coeffs, int ncoef,
           int coeff_off, void* any_zero, const void* vinv, int batch, int round,
           long long nbytes, int draw_next, cudaStream_t s) {
  using W = typename F::word;
  constexpr int TPB = 64;
  const dim3 grid((batch + TPB - 1) / TPB);
#define TS_FS_TAIL_ARGS                                                                       \
  f, byte_size, len, static_cast<const W*>(partials), blocks, static_cast<uint32_t*>(state), \
      static_cast<uint8_t*>(buf), static_cast<W*>(claim), static_cast<W*>(r),                 \
      static_cast<W*>(c1), static_cast<W*>(coeffs), ncoef, coeff_off,                        \
      static_cast<int*>(any_zero), static_cast<const W*>(vinv), batch, round, nbytes, draw_next
  if (degree == 2) fs_tail_kernel<F, 2><<<grid, TPB, 0, s>>>(TS_FS_TAIL_ARGS);
  else if (degree == 3) fs_tail_kernel<F, 3><<<grid, TPB, 0, s>>>(TS_FS_TAIL_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef TS_FS_TAIL_ARGS
  return 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). mont32 = 0
// takes Goldilocks int64 words; mont32 = 1 takes Montgomery words of the
// field with modulus p < 2^31 and pinv = -p^-1 mod 2^32. byte_size is the
// serialized width of one element, len the uniform bytes of one draw
// (<= 32). degree must be 2 or 3 (the wrapper checks every argument first).
extern "C" int ts_fs_tail_launch(int mont32, unsigned p, unsigned pinv, int byte_size, int len,
                                 int degree, const void* partials, int blocks, void* state,
                                 void* buf, void* claim, void* r, void* c1, void* coeffs,
                                 int ncoef, int coeff_off, void* any_zero, const void* vinv,
                                 int batch, int round, long long nbytes, int draw_next,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      mont32 ? launch(M32Ops{{p, pinv}}, byte_size, len, degree, partials, blocks, state, buf,
                      claim, r, c1, coeffs, ncoef, coeff_off, any_zero, vinv, batch, round, nbytes,
                      draw_next, s)
             : launch(GlOps{}, byte_size, len, degree, partials, blocks, state, buf, claim, r, c1,
                      coeffs, ncoef, coeff_off, any_zero, vinv, batch, round, nbytes, draw_next, s);
  return rc ? rc : (int)cudaGetLastError();
}
