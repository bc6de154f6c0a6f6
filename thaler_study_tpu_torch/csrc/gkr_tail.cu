// The per-round scalar code of a GKR layer's sumcheck, on the card: one
// warp, batch 1, Goldilocks.
//
// Replaces: the scalar part of thaler_study_tpu/gkr/fused.py
// _phase1_body / _phase2_body (:161-196, :283-347), which XLA compiles for
// the TPU: the round-sum reduction and the claim shortcut, _interp_coeffs
// and _claim_at (ops/fs_kernel.py:106, :153), _msg_sumcheck / _poly_bytes /
// _le8_from_u32 / _track_zero (fused.py:81-111), and DevChain's absorb and
// draw in its traced-offset mode (ops/sha_chain.py:116-247). Its plain
// versions are ops/gkr_tail.round_tail_plain and final_tail_plain.
//
// ROUND TAIL, one launch per inner round: sum K1's per-block partials
// [blocks, 3] mod p; fill s(1) = claim - s(0), except in phase 1's round 0,
// where it sets c_1 = s(0) + s(1) and writes StartSumCheck
// (0x01 || c_1 || layer || 2k, 25 bytes) first; interpolate the three
// coefficients; OR the zero flag; write the SumCheckProverMessage
// (0x02 || u64 3 || (u64 t || c_t) x 3, 57 bytes) into the proof's
// transcript bytes and the carried SHA-256 chain; draw one challenge (two,
// r_{2k-2} and r_last, at the layer's second-to-last message) into the
// layer's challenge vector; set the next claim g(r) by Horner.
// FINAL TAIL, one launch per layer: p from the last round's partials as
// above, q from the line restriction; write FinalRoundMessage
// (0x03 || poly(p) || poly(q), 16 k + 81 bytes: 401 at k = 20), absorb it,
// OR the zero flag, draw r* and write r_{i+1} = u + (c - u) r*.
//
// Every message is a tag byte and then 8-byte little-endian units, staged
// in shared memory as units; each lane writes the bytes at its positions.
// Offsets are launch arguments: every message length of the fused prover
// is fixed, so the host knows them all.
//
// What bounds it: latency, the chain of dependent SHA-256 compressions
// (1.5 us each on the H100). Round tail: 1-2 to absorb, 1-2 for b_0, 1 for
// b_1 (2 for b_1 and b_2 when it draws two): 4.5-7.5 us. Final tail: up to
// 7 blocks to absorb 401 bytes, then the draw. The design is fs_tail.cu's:
// every load first, partials summed by a shuffle tree, bytes staged in
// shared memory, SHA-256 unrolled in registers (csrc/sha256.cuh), every
// lane running it on the same words.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "sha256.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_K = 31;  // the final tail holds q's k + 1 coefficients one per lane
// Shared bytes: the carried fill (< 64), the message (<= 82 bytes in a
// round; <= 16 * 31 + 81 = 577 in the final tail), b_0's suffix and
// padding.
constexpr int ROUND_STAGE = 192;
constexpr int FINAL_STAGE = 768;
constexpr int LEN = 24;                             // uniform bytes of one Goldilocks element
constexpr uint64_t INV2 = 0x7FFFFFFF80000001ull;  // 1/2 mod p

using sha256::compress;
using sha256::H0;
using sha256::load_block;

// 24 uniform bytes (6 big-endian words) mod p:
// (h0 h1) 2^128 + (h2 h3) 2^64 + (h4 h5)
__device__ __forceinline__ uint64_t from_uniform(uint32_t h0, uint32_t h1, uint32_t h2, uint32_t h3,
                                                 uint32_t h4, uint32_t h5) {
  uint64_t x0 = (uint64_t)h0 << 32 | h1, x1 = (uint64_t)h2 << 32 | h3, x2 = (uint64_t)h4 << 32 | h5;
  x0 = x0 >= gl::P ? x0 - gl::P : x0;
  x1 = x1 >= gl::P ? x1 - gl::P : x1;
  x2 = x2 >= gl::P ? x2 - gl::P : x2;
  return gl::add(gl::add(x2, gl::mul(x1, gl::EPS)), gl::mul(x0, gl::C128));
}

// the round sums s(0..2) of K1's [blocks, 3] partials, on every lane
__device__ __forceinline__ void round_sums(const uint64_t* __restrict__ partials, int blocks, uint64_t s[3]) {
  s[0] = s[1] = s[2] = 0;
  for (int x = threadIdx.x; x < blocks; x += 32) {
#pragma unroll
    for (int e = 0; e < 3; ++e) s[e] = gl::add(s[e], partials[3 * x + e]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int e = 0; e < 3; ++e) s[e] = gl::add(s[e], __shfl_xor_sync(FULL, s[e], o));
  }
}

// the coefficients of the degree-2 g with g(0..2) = s
__device__ __forceinline__ void interp(const uint64_t s[3], uint64_t c[3]) {
  c[0] = s[0];
  c[2] = gl::mul(gl::add(gl::sub(s[2], gl::add(s[1], s[1])), s[0]), INV2);
  c[1] = gl::sub(gl::sub(s[1], s[0]), c[2]);
}

// byte q of the message tag || units (8-byte little-endian units)
__device__ __forceinline__ uint8_t msg_byte(int q, uint8_t tag, const uint64_t* units) {
  return q == 0 ? tag : (uint8_t)(units[(q - 1) >> 3] >> (8 * ((q - 1) & 7)));
}

// Append stage[fill, fill + m) to the chain and draw count (1 or 2)
// elements. stage holds the chain's fill carried bytes and the m message
// bytes, zeros after them, and room for b_0's closing blocks. st is the
// chain's state; the state after the full blocks and the new carried
// bytes are stored to state and buf.
__device__ __forceinline__ void absorb_draw(uint8_t* stage, int fill, int m, long long nbytes, int count,
                                            uint32_t st[8], uint32_t* __restrict__ state,
                                            uint8_t* __restrict__ buf, uint64_t r[2]) {
  const int lane = threadIdx.x;
  const int end = fill + m;
  const int nfull = end >> 6;  // blocks the absorb compresses
  const int rest = end & 63;   // the chain's new fill
  const int nb0 = rest + 5 <= 56 ? 1 : 2;
  const int base = 64 * nfull;
  const int len = LEN * count;
  // b_0 = H(Z_pad || transcript || I2OSP(len, 2) || 0x00 || DST'), DST' = [0]
  const uint64_t bits = (uint64_t)(64 + nbytes + m + 4) * 8;
  if (lane == 0) stage[end] = (uint8_t)(len >> 8);
  if (lane == 1) stage[end + 1] = (uint8_t)len;
  if (lane == 2) stage[end + 4] = 0x80;
  if (lane < 8) stage[base + 64 * nb0 - 1 - lane] = (uint8_t)(bits >> (8 * lane));
  __syncwarp();
  for (int k = 0; k < nfull; ++k) {
    uint32_t w[16];
    load_block(w, stage + 64 * k);
    compress(st, w);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) state[k] = st[k];
  }
  for (int q = lane; q < 64; q += 32) buf[q] = q < rest ? stage[base + q] : 0;
  uint32_t b0[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) b0[k] = st[k];
  for (int k = 0; k < nb0; ++k) {
    uint32_t w[16];
    load_block(w, stage + base + 64 * k);
    compress(b0, w);
  }
  // b_1 = H(b_0 || 0x01 || DST'), b_2 = H((b_0 ^ b_1) || 0x02 || DST'):
  // one padded block of 34 bytes each
  uint32_t h1[8], w[16] = {b0[0], b0[1], b0[2], b0[3], b0[4], b0[5], b0[6], b0[7],
                           0x01008000u, 0, 0, 0, 0, 0, 0, 34 * 8};
#pragma unroll
  for (int k = 0; k < 8; ++k) h1[k] = H0[k];
  compress(h1, w);
  r[0] = from_uniform(h1[0], h1[1], h1[2], h1[3], h1[4], h1[5]);
  if (count == 2) {
    uint32_t h2[8], w2[16] = {b0[0] ^ h1[0], b0[1] ^ h1[1], b0[2] ^ h1[2], b0[3] ^ h1[3],
                              b0[4] ^ h1[4], b0[5] ^ h1[5], b0[6] ^ h1[6], b0[7] ^ h1[7],
                              0x02008000u,   0,             0,             0,
                              0,             0,             0,             34 * 8};
#pragma unroll
    for (int k = 0; k < 8; ++k) h2[k] = H0[k];
    compress(h2, w2);
    r[1] = from_uniform(h1[6], h1[7], h2[0], h2[1], h2[2], h2[3]);
  }
}

__global__ void __launch_bounds__(32)
    gkr_round_tail_kernel(const uint64_t* __restrict__ partials, int blocks, uint32_t* __restrict__ state,
                          uint8_t* __restrict__ buf, long long nbytes, uint8_t* __restrict__ out,
                          int* __restrict__ zero, uint64_t* __restrict__ claim, uint64_t* __restrict__ chal,
                          int chal_idx, int draws, int start, long long layer, int k) {
  __shared__ __align__(16) uint8_t stage[ROUND_STAGE];
  __shared__ uint64_t units[10];  // StartSumCheck's 3, then the round message's 7
  const int lane = threadIdx.x;
  const int fill = (int)(nbytes % 64);

  // the loads: partials, the claim, the chain's state and carried bytes
  uint64_t s[3];
  round_sums(partials, blocks, s);
  const uint64_t claim_in = start ? 0 : *claim;
  uint32_t st[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) st[q] = state[q];
  const uint8_t carried0 = lane < fill ? buf[lane] : 0;
  const uint8_t carried1 = lane + 32 < fill ? buf[lane + 32] : 0;

  if (!start) s[1] = gl::sub(claim_in, s[0]);
  uint64_t c[3];
  interp(s, c);
  const int pre = start ? 25 : 0;
  const int m = pre + 57;
  if (lane == 0) {
    if (c[0] == 0 || c[1] == 0 || c[2] == 0) *zero |= 1;
    units[0] = gl::add(s[0], s[1]);  // c_1
    units[1] = (uint64_t)layer;
    units[2] = 2 * (uint64_t)k;
    units[3] = 3;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      units[4 + 2 * t] = t;
      units[5 + 2 * t] = c[t];
    }
  }
  uint32_t* stage32 = reinterpret_cast<uint32_t*>(stage);
  for (int q = lane; q < ROUND_STAGE / 4; q += 32) stage32[q] = 0;
  __syncwarp();
  if (lane < fill) stage[lane] = carried0;
  if (lane + 32 < fill) stage[lane + 32] = carried1;
  for (int q = lane; q < m; q += 32) {
    const uint8_t byte = q < pre ? msg_byte(q, 0x01, units) : msg_byte(q - pre, 0x02, units + 3);
    stage[fill + q] = byte;
    out[q] = byte;
  }

  uint64_t r[2];
  absorb_draw(stage, fill, m, nbytes, draws, st, state, buf, r);
  if (lane == 0) {
    chal[chal_idx] = r[0];
    if (draws == 2) chal[chal_idx + 1] = r[1];
    *claim = gl::add(gl::mul(gl::add(gl::mul(c[2], r[0]), c[1]), r[0]), c[0]);
  }
}

__global__ void __launch_bounds__(32)
    gkr_final_tail_kernel(const uint64_t* __restrict__ partials, int blocks, const uint64_t* __restrict__ claim,
                          const uint64_t* __restrict__ q, int k, const uint64_t* __restrict__ chal,
                          uint32_t* __restrict__ state, uint8_t* __restrict__ buf, long long nbytes,
                          uint8_t* __restrict__ out, int* __restrict__ zero, uint64_t* __restrict__ r_next) {
  __shared__ __align__(16) uint8_t stage[FINAL_STAGE];
  __shared__ uint64_t units[8 + 2 * (MAX_K + 1)];
  const int lane = threadIdx.x;
  const int fill = (int)(nbytes % 64);

  // the loads: partials, the claim, q_lane, u_lane and c_lane, the chain
  uint64_t s[3];
  round_sums(partials, blocks, s);
  const uint64_t claim_in = *claim;
  const uint64_t qt = lane <= k ? q[lane] : 1;
  const uint64_t ui = lane < k ? chal[lane] : 0;
  const uint64_t ci = lane < k ? chal[k + lane] : 0;
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = state[i];
  const uint8_t carried0 = lane < fill ? buf[lane] : 0;
  const uint8_t carried1 = lane + 32 < fill ? buf[lane + 32] : 0;

  s[1] = gl::sub(claim_in, s[0]);
  uint64_t c[3];
  interp(s, c);
  const int any_zero = __any_sync(FULL, qt == 0) || c[0] == 0 || c[1] == 0 || c[2] == 0;
  // units: poly(p) = 3, (t, p_t) x 3; poly(q) = k + 1, (t, q_t) x (k + 1)
  if (lane == 0) {
    if (any_zero) *zero |= 1;
    units[0] = 3;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      units[1 + 2 * t] = t;
      units[2 + 2 * t] = c[t];
    }
    units[7] = k + 1;
  }
  if (lane <= k) {
    units[8 + 2 * lane] = lane;
    units[9 + 2 * lane] = qt;
  }
  uint32_t* stage32 = reinterpret_cast<uint32_t*>(stage);
  for (int i = lane; i < FINAL_STAGE / 4; i += 32) stage32[i] = 0;
  __syncwarp();
  if (lane < fill) stage[lane] = carried0;
  if (lane + 32 < fill) stage[lane + 32] = carried1;
  const int m = 16 * k + 81;
  for (int i = lane; i < m; i += 32) {
    const uint8_t byte = msg_byte(i, 0x03, units);
    stage[fill + i] = byte;
    out[i] = byte;
  }

  uint64_t r[2];
  absorb_draw(stage, fill, m, nbytes, 1, st, state, buf, r);
  if (lane < k) r_next[lane] = gl::add(ui, gl::mul(gl::sub(ci, ui), r[0]));
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). Goldilocks
// int64 words. partials: K1's [blocks, 3]; state: 8 u32 words, buf: 64
// bytes, nbytes: the chain's absorbed bytes; out: where the message goes
// (82 bytes with start, else 57); zero: the proof's int32 flag; claim:
// one word, read unless start and written; chal: the layer's challenge
// vector, written at chal_idx (and chal_idx + 1 when draws = 2). The
// wrapper checks every argument first.
extern "C" int ts_gkr_round_tail_launch(const void* partials, int blocks, void* state, void* buf,
                                        long long nbytes, void* out, void* zero, void* claim, void* chal,
                                        int chal_idx, int draws, int start, long long layer, int k,
                                        void* stream) {
  if (draws != 1 && draws != 2) return (int)cudaErrorInvalidValue;
  gkr_round_tail_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(partials), blocks, static_cast<uint32_t*>(state),
      static_cast<uint8_t*>(buf), nbytes, static_cast<uint8_t*>(out), static_cast<int*>(zero),
      static_cast<uint64_t*>(claim), static_cast<uint64_t*>(chal), chal_idx, draws, start, layer, k);
  return (int)cudaGetLastError();
}

// The final tail of a layer with k <= 31 variables per phase: q holds k + 1
// words, chal the layer's 2k challenges (u, then c), r_next receives k
// words; out: where the 16 k + 81 message bytes go. Returns
// cudaGetLastError() after the launch.
extern "C" int ts_gkr_final_tail_launch(const void* partials, int blocks, const void* claim, const void* q,
                                        int k, const void* chal, void* state, void* buf, long long nbytes,
                                        void* out, void* zero, void* r_next, void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  gkr_final_tail_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(partials), blocks, static_cast<const uint64_t*>(claim),
      static_cast<const uint64_t*>(q), k, static_cast<const uint64_t*>(chal), static_cast<uint32_t*>(state),
      static_cast<uint8_t*>(buf), nbytes, static_cast<uint8_t*>(out), static_cast<int*>(zero),
      static_cast<uint64_t*>(r_next));
  return (int)cudaGetLastError();
}
