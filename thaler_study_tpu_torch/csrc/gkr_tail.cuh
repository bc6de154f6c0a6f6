// The per-round scalar code of a GKR layer's sumcheck, on the card: one
// warp, batch 1, Goldilocks. Shared by the round kernel's GKR epilogue
// (round_kernel.cu, libra_round_kernel with TAIL) and the final tail
// (gkr_tail.cu).
//
// Replaces: the scalar part of thaler_study_tpu/gkr/fused.py
// _phase1_body / _phase2_body (:161-196, :283-347), which XLA compiles for
// the TPU: the round-sum reduction and the claim shortcut, _interp_coeffs
// and _claim_at (ops/fs_kernel.py:106, :153), _msg_sumcheck / _poly_bytes /
// _le8_from_u32 / _track_zero (fused.py:81-111), and DevChain's absorb and
// draw in its traced-offset mode (ops/sha_chain.py:116-247). Its plain
// versions are ops/gkr_tail.round_tail_plain and final_tail_plain.
//
// ROUND TAIL (round_tail below), run by the last block of every inner
// round's K1 launch: from the round sums, fill s(1) = claim - s(0), except
// in phase 1's round 0, where it sets c_1 = s(0) + s(1) and writes
// StartSumCheck (0x01 || c_1 || layer || 2k, 25 bytes) first; interpolate
// the three coefficients; OR the zero flag; write the SumCheckProverMessage
// (0x02 || u64 3 || (u64 t || c_t) x 3, 57 bytes) into the proof's
// transcript bytes and the carried SHA-256 chain; draw one challenge (two,
// r_{2k-2} and r_last, at the layer's second-to-last message) into the
// layer's challenge vector; set the next claim g(r) by Horner.
//
// Every message is a tag byte and then 8-byte little-endian units, staged
// in shared memory as units; each lane writes the bytes at its positions.
// Offsets are launch arguments: every message length of the fused prover
// is fixed, so the host knows them all.
//
// What bounds it: latency, the chain of dependent SHA-256 compressions
// (1.5 us each on the H100): 1-2 to absorb, 1-2 for b_0, 1 for b_1 (2 for
// b_1 and b_2 when it draws two), every lane running them on the same
// words (SHA-256 unrolled in registers, csrc/sha256.cuh).
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "sha256.cuh"

namespace gkr_tail {

constexpr unsigned FULL = 0xFFFFFFFFu;
// Shared bytes of a round: the carried fill (< 64), the message (<= 82
// bytes), b_0's suffix and padding.
constexpr int ROUND_STAGE = 192;
constexpr int LEN = 24;                             // uniform bytes of one Goldilocks element
constexpr uint64_t INV2 = 0x7FFFFFFF80000001ull;  // 1/2 mod p

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
// bytes are stored to state and buf. Run by one full warp.
//
// Every compression of the draw runs at one call site: the absorbed
// blocks, then b_0's closing blocks (both continue the chain's state),
// then b_1 (and b_2) from the initial hash value. One copy of the
// unrolled compression keeps the code that the one warp of one block
// runs per round small: it runs once per launch, on whichever SM holds the
// last block, from a cold instruction cache.
__device__ __forceinline__ void absorb_draw(uint8_t* stage, int fill, int m, long long nbytes, int count,
                                            uint32_t st[8], uint32_t* __restrict__ state,
                                            uint8_t* __restrict__ buf, uint64_t r[2]) {
  const int lane = threadIdx.x & 31;
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
  for (int q = lane; q < 64; q += 32) buf[q] = q < rest ? stage[base + q] : 0;
  // b_1 = H(b_0 || 0x01 || DST'), b_2 = H((b_0 ^ b_1) || 0x02 || DST'):
  // one padded block of 34 bytes each
  const int nb = nfull + nb0;
  uint32_t cur[8], b0[8], h1[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) cur[k] = st[k];
  for (int q = 0; q < nb + count; ++q) {
    if (q == nfull && lane == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) state[k] = cur[k];
    }
    if (q >= nb) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (q == nb) b0[k] = cur[k];
        else h1[k] = cur[k];
        cur[k] = H0[k];
      }
    }
    uint32_t w[16];
    if (q < nb) {
      load_block(w, stage + 64 * q);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = q == nb ? b0[k] : b0[k] ^ h1[k];
      w[8] = q == nb ? 0x01008000u : 0x02008000u;
#pragma unroll
      for (int k = 9; k < 15; ++k) w[k] = 0;
      w[15] = 34 * 8;
    }
    sha256::compress(cur, w);
  }
  if (count == 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) h1[k] = cur[k];
  }
  r[0] = from_uniform(h1[0], h1[1], h1[2], h1[3], h1[4], h1[5]);
  if (count == 2) r[1] = from_uniform(h1[6], h1[7], cur[0], cur[1], cur[2], cur[3]);
}

// One inner round's tail: where it reads and writes (the arguments of
// ops/gkr_tail.round_tail_plain). state: the chain's 8 u32 words (16-byte
// aligned), buf: its 64-byte partial block (16-byte aligned), nbytes: the
// absorbed bytes; out: where the message goes (82 bytes with start, else
// 57); zero: the proof's int32 flag; claim: one word (8-byte aligned), read
// unless start and written; chal: the layer's challenge vector, written at
// chal_idx (and chal_idx + 1 when draws = 2); counter: the layer's int32
// ticket counter, 0 between launches.
struct RoundArgs {
  int* counter;
  uint32_t* state;
  uint8_t* buf;
  long long nbytes;
  uint8_t* out;
  int* zero;
  uint64_t* claim;
  uint64_t* chal;
  int chal_idx, draws, start, k;
  long long layer;
};

// The chain's inputs of a round tail in shared memory: state, the partial
// block and the claim.
struct __align__(16) ChainIn {
  uint32_t st[8];
  uint8_t buf[64];
  uint64_t claim;
};

// Start copying the chain's inputs into `in` (cp.async: no registers held,
// nothing waits); threads 0-6 of the block issue one copy each. Wait with
// __pipeline_wait_prior(0) before reading `in`.
__device__ __forceinline__ void load_chain_async(ChainIn& in, const RoundArgs& t) {
  const int q = threadIdx.x;
  if (q < 2) __pipeline_memcpy_async(in.st + 4 * q, t.state + 4 * q, 16);
  else if (q < 6) __pipeline_memcpy_async(in.buf + 16 * (q - 2), t.buf + 16 * (q - 2), 16);
  else if (q == 6) __pipeline_memcpy_async(&in.claim, t.claim, 8);
  __pipeline_commit();
}

// The round tail on the round sums s (on every lane), run by one full warp.
__device__ __forceinline__ void round_tail(uint64_t s[3], const ChainIn& in, const RoundArgs& t) {
  __shared__ __align__(16) uint8_t stage[ROUND_STAGE];
  __shared__ uint64_t units[10];  // StartSumCheck's 3, then the round message's 7
  const int lane = threadIdx.x & 31;
  const int fill = (int)(t.nbytes % 64);
  uint32_t st[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) st[q] = in.st[q];

  if (!t.start) s[1] = gl::sub(in.claim, s[0]);
  uint64_t c[3];
  interp(s, c);
  const int pre = t.start ? 25 : 0;
  const int m = pre + 57;
  if (lane == 0) {
    if (c[0] == 0 || c[1] == 0 || c[2] == 0) *t.zero |= 1;
    units[0] = gl::add(s[0], s[1]);  // c_1
    units[1] = (uint64_t)t.layer;
    units[2] = 2 * (uint64_t)t.k;
    units[3] = 3;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      units[4 + 2 * q] = q;
      units[5 + 2 * q] = c[q];
    }
  }
  uint32_t* stage32 = reinterpret_cast<uint32_t*>(stage);
  for (int q = lane; q < ROUND_STAGE / 4; q += 32) stage32[q] = 0;
  __syncwarp();
  for (int q = lane; q < fill; q += 32) stage[q] = in.buf[q];
  for (int q = lane; q < m; q += 32) {
    const uint8_t byte = q < pre ? msg_byte(q, 0x01, units) : msg_byte(q - pre, 0x02, units + 3);
    stage[fill + q] = byte;
    t.out[q] = byte;
  }

  uint64_t r[2];
  absorb_draw(stage, fill, m, t.nbytes, t.draws, st, t.state, t.buf, r);
  if (lane == 0) {
    t.chal[t.chal_idx] = r[0];
    if (t.draws == 2) t.chal[t.chal_idx + 1] = r[1];
    *t.claim = gl::add(gl::mul(gl::add(gl::mul(c[2], r[0]), c[1]), r[0]), c[0]);
  }
}

}  // namespace gkr_tail
