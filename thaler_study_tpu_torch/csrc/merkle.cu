// The SHA-256 Merkle tree of the PCS, every level on the card.
//
// Replaces: thaler_study_tpu/ops/merkle_kernel.py, _build_tree_jit (:107),
// which XLA compiles for the TPU: _leaf_hashes (:68), sha256(b"leaf:" ||
// value_le) per leaf, and _node_hashes (:85), sha256(b"node:" || left ||
// right) per node, each level one vmapped compression (_compress_batch
// :63). Its plain version is ops/merkle_kernel.build_tree_plain (hashlib per
// node, the JAX package's host build, pcs/merkle.py:22-27, :108-116).
//
// The tree lives in one buffer of 2n - 1 digests of 8 big-endian u32 words,
// level by level, leaves first (digest i of level l at offset(l) + i).
// - leaf_kernel: one thread per leaf. The message "leaf:" || value (byte_size
//   little-endian bytes, 5 + byte_size <= 13) and its padding fill one
//   block: the thread builds its 16 words in registers from the value's
//   bytes and compresses once.
// - node_kernel: one thread per node of the next level. Its 69-byte message
//   "node:" || left || right and padding are two blocks; the children's
//   words, shifted by the 5-byte prefix, make the blocks in registers: word
//   j >= 2 is (S[j - 2] << 24) | (S[j - 1] >> 8) over the 16 child words S
//   and the padding word 0x80000000. Two compressions.
// One launch per level of more than 256 nodes, then one block for every
// level from 256 nodes (or fewer) up to the root (top_kernel): a launch per
// level there would cost more than its few hundred threads' work.
//
// What bounds it: the compressions' integer instructions (~1,400-1,500 SASS
// instructions each, fully unrolled: 64 steps of funnel shifts, LOP3s and
// adds, all on the SM's integer pipes); its bytes
// are the leaves read once and every digest written once and read once by
// its parent. Neighbouring threads read neighbouring children (coalesced
// 32-byte digests).
#include <cuda_runtime.h>

#include <cstdint>

#include "sha256.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    leaf_kernel(const uint8_t* __restrict__ vals, int byte_size, long long n, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint8_t* v = vals + i * byte_size;
  const int len = 5 + byte_size;  // message bytes
  uint32_t w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = 0;
  // bytes 0..4 "leaf:", then the value, then 0x80 at len
  w[0] = 0x6C656166u;  // "leaf"
  w[1] = 0x3A000000u;  // ":"
#pragma unroll
  for (int q = 5; q < 14; ++q) {
    uint32_t byte = 0;
    if (q < len) byte = v[q - 5];
    else if (q == len) byte = 0x80;
    w[q >> 2] |= byte << (8 * (3 - (q & 3)));
  }
  w[15] = 8u * len;
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = sha256::H0[k];
  sha256::compress(st, w);
  uint4* dst = reinterpret_cast<uint4*>(out + 8 * i);
  dst[0] = make_uint4(st[0], st[1], st[2], st[3]);
  dst[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

// Node i of a level from its children (2i, 2i + 1) into out[i]. Plain
// coherent loads: in top_kernel the children were written by other threads
// of the same block before its barrier.
__device__ __forceinline__ void node_hash(const uint32_t* children, long long i, uint32_t* out) {
  uint32_t s[17];  // left || right, then the padding's first word
  const uint4* src = reinterpret_cast<const uint4*>(children + 16 * i);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 x = src[k];
    s[4 * k] = x.x;
    s[4 * k + 1] = x.y;
    s[4 * k + 2] = x.z;
    s[4 * k + 3] = x.w;
  }
  s[16] = 0x80000000u;
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = sha256::H0[k];
  uint32_t w[16];
  w[0] = 0x6E6F6465u;  // "node"
  w[1] = 0x3A000000u | (s[0] >> 8);  // ":" and the left digest's first 3 bytes
#pragma unroll
  for (int j = 2; j < 16; ++j) w[j] = (s[j - 2] << 24) | (s[j - 1] >> 8);
  sha256::compress(st, w);
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = 0;
  w[0] = (s[14] << 24) | (s[15] >> 8);
  w[1] = (s[15] << 24) | (s[16] >> 8);
  w[15] = 69 * 8;
  sha256::compress(st, w);
  uint4* dst = reinterpret_cast<uint4*>(out + 8 * i);
  dst[0] = make_uint4(st[0], st[1], st[2], st[3]);
  dst[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

__global__ void __launch_bounds__(THREADS) node_kernel(const uint32_t* children, long long n, uint32_t* out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) node_hash(children, i, out);
}

// Every level from one of n <= THREADS nodes to the root, in one block:
// thread i hashes node i of each level, a barrier between levels. The
// levels lie one after the other in the tree buffer, so the next level's
// children are this level's output.
__global__ void __launch_bounds__(THREADS) top_kernel(uint32_t* children, long long n) {
  for (long long m = n; m >= 1; m >>= 1) {
    uint32_t* out = children + 16 * m;
    if (threadIdx.x < m) node_hash(children, threadIdx.x, out);
    __syncthreads();
    children = out;
  }
}

int blocks_of(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). vals: n rows
// of byte_size bytes (1 <= byte_size <= 8); out: n digests of 8 u32 words,
// 16-byte aligned.
extern "C" int ts_merkle_leaf_launch(const void* vals, int byte_size, long long n, void* out, void* stream) {
  if (byte_size < 1 || byte_size > 8 || n < 1) return (int)cudaErrorInvalidValue;
  leaf_kernel<<<blocks_of(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(vals), byte_size, n, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// One level of n nodes from the 2n children before it (8 u32 words each,
// 16-byte aligned). Returns as above.
extern "C" int ts_merkle_node_launch(const void* children, long long n, void* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  node_kernel<<<blocks_of(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(children), n, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// The levels from one of n <= 256 nodes up to the root, in one block, from
// the 2n children at `children`, each level written right after the one
// before it. Returns as above.
extern "C" int ts_merkle_top_launch(void* children, long long n, void* stream) {
  if (n < 1 || n > THREADS) return (int)cudaErrorInvalidValue;
  top_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<uint32_t*>(children), n);
  return (int)cudaGetLastError();
}
