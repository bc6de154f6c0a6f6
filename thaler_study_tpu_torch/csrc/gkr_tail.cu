// The final tail of a GKR layer's sumcheck, on the card: one warp, batch
// 1, Goldilocks. (The round tail of every inner round runs as the round
// kernel's epilogue, round_kernel.cu; both share csrc/gkr_tail.cuh.)
//
// Replaces: thaler_study_tpu/gkr/fused.py:318-347, the FinalRoundMessage
// of _phase2_body (p from :303), r* and r_{i+1}, which XLA compiles for the
// TPU. Its plain version is ops/gkr_tail.final_tail_plain.
//
// FINAL TAIL, one launch per layer: p from the last round's partials (s(1)
// = claim - s(0)), q from the line restriction; write FinalRoundMessage
// (0x03 || poly(p) || poly(q), 16 k + 81 bytes: 401 at k = 20), absorb it,
// OR the zero flag, draw r* and write r_{i+1} = u + (c - u) r*.
//
// What bounds it: latency, up to 7 blocks to absorb 401 bytes, then the
// draw (gkr_tail.cuh). The design is fs_tail.cu's: every load first,
// partials summed by a shuffle tree, bytes staged in shared memory,
// SHA-256 unrolled in registers, every lane running it on the same words.
#include <cuda_runtime.h>

#include "gkr_tail.cuh"

namespace {

using namespace gkr_tail;

constexpr int MAX_K = 31;  // the final tail holds q's k + 1 coefficients one per lane
// Shared bytes: the carried fill (< 64), the message (<= 16 * 31 + 81 =
// 577 bytes), b_0's suffix and padding.
constexpr int FINAL_STAGE = 768;

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
