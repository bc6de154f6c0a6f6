// The per-round tail of the batched Fiat-Shamir sumcheck prover, one warp
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
// little-endian bytes per element) into the proof's transcript bytes
// msgs[b, nbytes : nbytes + m] and into the carried SHA-256 chain; and,
// unless it is the last round, finishes expand_message_xmd (len_in_bytes
// uniform bytes) into the next challenge r[b] and the next claim[b] =
// g_j(r[b]) by Horner. For a mont32 field the sums, vinv, r and the claim
// are Montgomery words, as in the JAX package; only what is serialized and
// stored for the host is canonical.
//
// Round degrees 1 to 8 (MAX_D; the JAX package's fused prover takes any
// spec whose rounds all have degree >= 1, and the port's round kernels
// take up to 8 factors or a degree of 8). A degree-D message is
// [byte_size] + 8 + (8 + byte_size)(D + 1) bytes: at most 160 (D = 8,
// Goldilocks, round 0), so with the carried fill the absorb compresses up
// to 3 blocks and b_0 closes in 1 or 2 more.
//
// What bounds it: latency. It moves a few hundred bytes per proof, and its
// critical path is serial: one L2 round trip for the partials, then the
// round's SHA-256 compressions (up to 3 for the absorb; 1 or 2 for b_0; 1
// for b_1), 64 dependent steps each.
// The design keeps that path short and out of local memory:
// - one warp per proof, one block each, so B proofs run on B SMs;
// - every load from device memory is issued first, so that their
//   latencies overlap;
// - the lanes load the [blocks, d+1] partials together and a shuffle tree
//   sums them mod p; lanes 0..d interpolate one coefficient each;
// - the message (each lane writes its own bytes), b_0's suffix and the
//   padding are staged in shared memory at their run-time offsets; each
//   compression reads its 16 big-endian words from there at compile-time
//   register indices;
// - SHA-256 (csrc/sha256.cuh) is fully unrolled over a rolling 16-word
//   schedule, so state and schedule live in registers; every lane runs it
//   on the same words, so no lane waits for a broadcast of the digest;
// - the mont32 draw is a Horner over 32-bit words by Montgomery products,
//   with no 64-bit division.
// ts_sha_chain_launch times one thread's chain of dependent compressions,
// the floor under the hash path; it is not on the prover's path.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "mont32.cuh"
#include "sha256.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_D = 8;

// The longest degree-D message: c_1, the length, D + 1 terms of 8 + 8 bytes
__host__ __device__ constexpr int max_msg(int d) { return 8 + 8 + 16 * (d + 1); }

// Shared bytes per proof: the carried partial block and the message
// (< 64 + max_msg), then b_0's suffix and padding in at most two blocks.
__host__ __device__ constexpr int stage_bytes(int d) { return 64 * ((63 + max_msg(d)) / 64 + 2); }

using sha256::compress;
using sha256::H0;
using sha256::load_block;

// The field as the tail sees it: arithmetic on its words, the canonical
// value of a word, and the element drawn from the uniform bytes of b_1.
struct GlOps {
  using word = uint64_t;
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
  __device__ __forceinline__ word sub(word a, word b) const { return gl::sub(a, b); }
  __device__ __forceinline__ word mul(word a, word b) const { return gl::mul(a, b); }
  __device__ __forceinline__ word canonical(word a) const { return a; }
  // the first 24 uniform bytes, big-endian, reduced mod p:
  // (h0 h1) * 2^128 + (h2 h3) * 2^64 + (h4 h5)
  __device__ __forceinline__ word from_uniform(const uint32_t h[8], int) const {
    uint64_t x0 = (uint64_t)h[0] << 32 | h[1], x1 = (uint64_t)h[2] << 32 | h[3],
             x2 = (uint64_t)h[4] << 32 | h[5];
    x0 = x0 >= gl::P ? x0 - gl::P : x0;
    x1 = x1 >= gl::P ? x1 - gl::P : x1;
    x2 = x2 >= gl::P ? x2 - gl::P : x2;
    return gl::add(gl::add(x2, gl::mul(x1, gl::EPS)), gl::mul(x0, gl::C128));
  }
};

// r2 = 2^64 mod p (m32::Field) is the Montgomery word of 2^32.
struct M32Ops : m32::Field {
  using word = uint32_t;
  __device__ __forceinline__ word canonical(word a) const { return from_mont(a); }
  // the Montgomery word of any x < 2^32 (x need not be reduced): x * r2 < p * 2^32
  __device__ __forceinline__ word mont(uint32_t x) const { return redc((uint64_t)x * r2); }
  // The first len (17..20) uniform bytes, big-endian, mod p, as a
  // Montgomery word: Horner over the len % 4 head bytes and then the
  // 32-bit words after them, acc <- acc * 2^32 + word, where acc * 2^32 is
  // the Montgomery product of acc with r2.
  __device__ __forceinline__ word from_uniform(const uint32_t h[8], int len) const {
    const int shift = 8 * (len & 3);
    const int words = len >> 2;
    word acc = mont(__funnelshift_l(h[0], 0, shift));
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (k < words) acc = add(mul(acc, r2), mont(__funnelshift_l(h[k + 1], h[k], shift)));
    }
    return acc;
  }
};

template <class F, int D>
__global__ void __launch_bounds__(32)
    fs_tail_kernel(F f, int byte_size, int len, const typename F::word* __restrict__ partials,
                   int blocks, uint32_t* __restrict__ state, uint8_t* __restrict__ buf,
                   typename F::word* __restrict__ claim, typename F::word* __restrict__ r,
                   typename F::word* __restrict__ c1, typename F::word* __restrict__ coeffs,
                   int ncoef, int coeff_off, uint8_t* __restrict__ msgs, long long msg_stride,
                   int* __restrict__ any_zero, const typename F::word* __restrict__ vinv,
                   int round, long long nbytes, int draw_next) {
  using W = typename F::word;
  constexpr int STAGE = stage_bytes(D);
  __shared__ __align__(16) uint8_t stage[STAGE];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;

  // the loads: this lane's partials, the claim, row i = min(lane, D) of
  // vinv, the chain's state and this lane's carried bytes
  const int fill = (int)(nbytes % 64);
  W s[D + 1];
#pragma unroll
  for (int e = 0; e <= D; ++e) s[e] = 0;
  const W* pp = partials + (long long)b * blocks * (D + 1);
  for (int x = lane; x < blocks; x += 32) {
#pragma unroll
    for (int e = 0; e <= D; ++e) s[e] = f.add(s[e], pp[x * (D + 1) + e]);
  }
  const W claim_in = round > 0 ? claim[b] : 0;
  const int i = min(lane, D);
  W vrow[D + 1];
#pragma unroll
  for (int t = 0; t <= D; ++t) vrow[t] = vinv[i * (D + 1) + t];
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = state[b * 8 + k];
  const uint8_t carried0 = lane < fill ? buf[b * 64 + lane] : 0;
  const uint8_t carried1 = lane + 32 < fill ? buf[b * 64 + lane + 32] : 0;

  // round sums: each lane summed its blocks, a shuffle tree sums the lanes
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int e = 0; e <= D; ++e) s[e] = f.add(s[e], __shfl_xor_sync(FULL, s[e], o));
  }
  if (round > 0) s[1] = f.sub(claim_in, s[0]);

  // lane i <= D: coefficient i = sum_t vinv[i][t] s_t (the other lanes
  // repeat coefficient D)
  W ci = 0;
#pragma unroll
  for (int t = 0; t <= D; ++t) ci = f.add(ci, f.mul(vrow[t], s[t]));
  const W cc = f.canonical(ci);
  const W c1v = f.canonical(f.add(s[0], s[1]));
  const int zero = __any_sync(FULL, ci == 0) ? 1 : 0;
  if (lane <= D) coeffs[(long long)b * ncoef + coeff_off + lane] = cc;
  if (lane == 0) {
    any_zero[b] |= zero;
    if (round == 0) c1[b] = c1v;
  }

  // the message [c_1 on round 0] || (d + 1) || (t, c_t) terms, m bytes,
  // after the chain's carried fill bytes, then b_0's suffix
  // I2OSP(len, 2) || 0x00 || DST' (DST' = [0]), 0x80 and the bit length
  const int pre = round == 0 ? byte_size : 0;
  const int term = 8 + byte_size;
  const int m = pre + 8 + term * (D + 1);
  const int end = fill + m;
  const int nfull = end >> 6;  // blocks the absorb compresses
  const int rest = end & 63;   // the chain's new fill
  const int nb0 = rest + 5 <= 56 ? 1 : 2;
  uint32_t* stage32 = reinterpret_cast<uint32_t*>(stage);
  for (int q = lane; q < STAGE / 4; q += 32) stage32[q] = 0;
  __syncwarp();
  if (lane < fill) stage[lane] = carried0;
  if (lane + 32 < fill) stage[lane + 32] = carried1;
  uint8_t* out = msgs + b * msg_stride + nbytes;
#pragma unroll
  for (int k = 0; k < (max_msg(D) + 31) / 32; ++k) {  // m <= max_msg(D)
    const int q = lane + 32 * k;
    const int u = q - pre - 8;  // offset into the terms
    const int t = u < 0 ? 0 : min(u / term, D);
    const int at = u - t * term;  // offset into term t
    const W ct = __shfl_sync(FULL, cc, t);
    uint64_t v;
    int shift;
    if (q < pre) {
      v = c1v;
      shift = q;
    } else if (u < 0) {
      v = D + 1;
      shift = q - pre;
    } else if (at < 8) {
      v = t;
      shift = at;
    } else {
      v = ct;
      shift = at - 8;
    }
    if (q < m) {
      const uint8_t byte = (uint8_t)(v >> (8 * shift));
      stage[fill + q] = byte;
      out[q] = byte;
    }
  }
  const int base = 64 * nfull;
  const uint64_t bits = (uint64_t)(64 + nbytes + m + 4) * 8;
  if (lane == 0) stage[end] = (uint8_t)(len >> 8);
  if (lane == 1) stage[end + 1] = (uint8_t)len;
  if (lane == 2) stage[end + 4] = 0x80;
  if (lane < 8) stage[base + 64 * nb0 - 1 - lane] = (uint8_t)(bits >> (8 * lane));
  __syncwarp();

  // absorb the full blocks; then, to draw, finish b_0 on a copy
  uint32_t kept[8];
  const int nblocks = nfull + (draw_next ? nb0 : 0);
  for (int k = 0; k < nblocks; ++k) {
    if (k == nfull) {
#pragma unroll
      for (int q = 0; q < 8; ++q) kept[q] = st[q];
    }
    uint32_t w[16];
    load_block(w, stage + 64 * k);
    compress(st, w);
  }
  if (!draw_next) {
#pragma unroll
    for (int q = 0; q < 8; ++q) kept[q] = st[q];
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) state[b * 8 + k] = kept[k];
  }
  for (int q = lane; q < 64; q += 32) buf[b * 64 + q] = q < rest ? stage[base + q] : 0;

  if (draw_next) {
    // b_1 = SHA-256(b_0 || 0x01 || DST'): one padded block of 34 bytes
    uint32_t w[16] = {st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                      0x01008000u, 0, 0, 0, 0, 0, 0, 34 * 8};
    uint32_t h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) h[k] = H0[k];
    compress(h, w);
    const W rv = f.from_uniform(h, len);
    W c[D + 1];
#pragma unroll
    for (int t = 0; t <= D; ++t) c[t] = __shfl_sync(FULL, ci, t);
    W acc = c[D];
#pragma unroll
    for (int t = D - 1; t >= 0; --t) acc = f.add(f.mul(acc, rv), c[t]);
    if (lane == 0) {
      r[b] = rv;
      claim[b] = acc;
    }
  }
}

template <class F, int D = 1>
int launch(const F& f, int byte_size, int len, int degree, const void* partials, int blocks,
           void* state, void* buf, void* claim, void* r, void* c1, void* coeffs, int ncoef,
           int coeff_off, void* msgs, long long msg_stride, void* any_zero, const void* vinv,
           int batch, int round, long long nbytes, int draw_next, cudaStream_t s) {
  using W = typename F::word;
  if (degree == D) {
    fs_tail_kernel<F, D><<<batch, 32, 0, s>>>(
        f, byte_size, len, static_cast<const W*>(partials), blocks, static_cast<uint32_t*>(state),
        static_cast<uint8_t*>(buf), static_cast<W*>(claim), static_cast<W*>(r), static_cast<W*>(c1),
        static_cast<W*>(coeffs), ncoef, coeff_off, static_cast<uint8_t*>(msgs), msg_stride,
        static_cast<int*>(any_zero), static_cast<const W*>(vinv), round, nbytes, draw_next);
    return 0;
  }
  if constexpr (D < MAX_D) {
    return launch<F, D + 1>(f, byte_size, len, degree, partials, blocks, state, buf, claim, r, c1, coeffs,
                            ncoef, coeff_off, msgs, msg_stride, any_zero, vinv, batch, round, nbytes,
                            draw_next, s);
  }
  return (int)cudaErrorInvalidValue;
}

// n dependent compressions on one thread, each reading its message from
// shared memory as the tail does: compression i takes block i % 2 of two
// blocks that hold the big-endian words 0, 1, ..., 31. out: the final
// state (8 words).
__global__ void sha_chain_kernel(int n, uint32_t* out) {
  __shared__ __align__(16) uint8_t blk[128];
  for (int q = 0; q < 128; ++q) blk[q] = (q & 3) == 3 ? (uint8_t)(q >> 2) : 0;
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = H0[k];
  for (int i = 0; i < n; ++i) {
    uint32_t w[16];
    load_block(w, blk + 64 * (i & 1));
    compress(st, w);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = st[k];
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). mont32 = 0
// takes Goldilocks int64 words; mont32 = 1 takes Montgomery words of the
// field with modulus p < 2^31 and pinv = -p^-1 mod 2^32.
// byte_size is the serialized width of one element, len the uniform bytes
// of one draw (17..20 for mont32, 24 for Goldilocks). degree must be 1 to
// 8 (MAX_D). msgs is a [batch, msg_stride] byte buffer whose row b receives the
// round's message at offset nbytes (the wrapper checks every argument
// first).
extern "C" int ts_fs_tail_launch(int mont32, unsigned p, unsigned pinv,
                                 int byte_size, int len, int degree, const void* partials,
                                 int blocks, void* state, void* buf, void* claim, void* r,
                                 void* c1, void* coeffs, int ncoef, int coeff_off, void* msgs,
                                 long long msg_stride, void* any_zero, const void* vinv,
                                 int batch, int round, long long nbytes, int draw_next,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      mont32 ? launch(M32Ops{{p, pinv}}, byte_size, len, degree, partials, blocks, state,
                      buf, claim, r, c1, coeffs, ncoef, coeff_off, msgs, msg_stride, any_zero,
                      vinv, batch, round, nbytes, draw_next, s)
             : launch(GlOps{}, byte_size, len, degree, partials, blocks, state, buf, claim, r, c1,
                      coeffs, ncoef, coeff_off, msgs, msg_stride, any_zero, vinv, batch, round,
                      nbytes, draw_next, s);
  return rc ? rc : (int)cudaGetLastError();
}

// The latency floor of the tail's hash path: one thread, n dependent
// compressions (sha_chain_kernel), final state into out (8 u32 words).
// Returns cudaGetLastError() after the launch.
extern "C" int ts_sha_chain_launch(int n, void* out, void* stream) {
  sha_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(n, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
