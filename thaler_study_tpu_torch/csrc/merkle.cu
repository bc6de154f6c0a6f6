// The SHA-256 Merkle tree of the PCS, the whole tree in one launch.
//
// Replaces: thaler_study_tpu/ops/merkle_kernel.py, _build_tree_jit (:107),
// which XLA compiles for the TPU: _leaf_hashes (:68), sha256(b"leaf:" ||
// value_le) per leaf, and _node_hashes (:85), sha256(b"node:" || left ||
// right) per node, each level one vmapped compression (_compress_batch
// :63). Its plain version is ops/merkle_kernel.build_tree_plain (hashlib per
// node, the JAX package's host build, pcs/merkle.py:22-27, :108-116).
//
// The tree lives in one buffer of 2n - 1 digests of 8 big-endian u32 words,
// level by level, leaves first: digest i of level l at 2n - 2 (n >> l) + i.
// A leaf's message "leaf:" || value (byte_size little-endian bytes, 5 +
// byte_size <= 13) and its padding fill one block, built in registers from
// the value's bytes: one compression. A node's 69-byte message "node:" ||
// left || right and padding are two blocks, made in registers from the
// children's words shifted by the 5-byte prefix: two compressions.
//
// What bounds it: the compressions' integer instructions (~1,400-1,500 SASS
// instructions each, fully unrolled: funnel shifts, LOP3s and adds), and
// the tree's depth. The integer pipe takes 16 lanes a clock per SM
// sub-partition, so a lone warp issues a compression's instructions one per
// two clocks (~1.5 us on the H100) whether 1 or 32 of its lanes work, and
// a node cannot start before both of its children are done: 1 + 2 log2(n)
// compressions in series. The levels with more nodes than the card has
// sub-partitions x 32 lanes are bound by the integer pipe, the ~log2(n) - 14
// levels above them by a node's latency.
//
// The design (ops/merkle_kernel.plan picks the shape; one launch, no level
// read back by a later launch):
// - A grid of B <= ROOTS blocks (one per SM) of T <= THREADS threads, each
//   block over S = T 2^p consecutive leaves. The block hashes its leaves,
//   then its levels 1 .. p, each level's nodes over all T threads (full
//   warps, neighbouring threads on neighbouring digests), a barrier between
//   levels: the children come back from the tree buffer just written by
//   the same SM. These wide levels write the compression's adds as IMADs
//   (compress_wide), which the FMA pipe runs beside the integer pipe.
// - From level p the block has one node a thread: they go to shared memory
//   and the block builds levels p + 1 .. p + log2(T) there, a barrier
//   between levels, with the plain compression (sha256.cuh), whose adds
//   keep a lone warp's dependent chains short. A level of m <= 128 nodes is
//   at most 4 warps of a block, one per sub-partition, and every block has
//   its own SM.
// - The block's root ends its part; the last block to take a ticket (the
//   device's ticket counter, _build.ticket_counter, 0 between launches)
//   reads the B roots and builds the levels above them in the same loop.
// Every digest is written once to the tree buffer, which the openings
// slice.
#include <cuda_runtime.h>

#include <cstdint>

#include "sha256.cuh"

namespace {

constexpr int THREADS = 512;  // a block's threads; ops/merkle_kernel.THREADS
constexpr int ROOTS = 128;    // the most blocks: the roots the last block hashes up; ops/merkle_kernel.ROOTS

// the offset, in digests, of level l of a tree over n leaves
__device__ __forceinline__ long long level_offset(long long n, int l) { return 2 * n - 2 * (n >> l); }

__device__ __forceinline__ void store_digest(uint32_t* p, const uint32_t d[8]) {
  uint4* v = reinterpret_cast<uint4*>(p);
  v[0] = make_uint4(d[0], d[1], d[2], d[3]);
  v[1] = make_uint4(d[4], d[5], d[6], d[7]);
}

__device__ __forceinline__ void load_digest(const uint32_t* p, uint32_t d[8]) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
  const uint4 a = v[0], b = v[1];
  d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w, d[4] = b.x, d[5] = b.y, d[6] = b.z, d[7] = b.w;
}

// sha256::compress with the rounds' adds written as a * one + b (one = 1, a
// kernel argument, so the compiler cannot fold the product): IMADs, which
// the FMA pipe runs beside the integer pipe's funnel shifts and LOP3s. For
// the wide levels, where warps queue at the integer pipe; a lone warp on a
// narrow level runs the plain compression, whose adds chain less.
__device__ __forceinline__ uint32_t madd(uint32_t a, uint32_t one, uint32_t b) { return a * one + b; }

__device__ __forceinline__ void compress_wide(uint32_t st[8], uint32_t w[16], uint32_t one) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = sha256::rotr(w15, 7) ^ sha256::rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = sha256::rotr(w2, 17) ^ sha256::rotr(w2, 19) ^ (w2 >> 10);
      w[i & 15] += s0 + w[(i - 7) & 15] + s1;
    }
    const uint32_t s1 = sha256::rotr(e, 6) ^ sha256::rotr(e, 11) ^ sha256::rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = madd(ch, one, madd(s1, one, madd(w[i & 15], one, madd(h, one, sha256::K256[i]))));
    const uint32_t s0 = sha256::rotr(a, 2) ^ sha256::rotr(a, 13) ^ sha256::rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = madd(d, one, t1);
    d = c;
    c = b;
    b = a;
    a = madd(t1, one, madd(s0, one, maj));
  }
  st[0] = madd(st[0], one, a);
  st[1] = madd(st[1], one, b);
  st[2] = madd(st[2], one, c);
  st[3] = madd(st[3], one, d);
  st[4] = madd(st[4], one, e);
  st[5] = madd(st[5], one, f);
  st[6] = madd(st[6], one, g);
  st[7] = madd(st[7], one, h);
}

template <bool WIDE>
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16], uint32_t one) {
  if constexpr (WIDE) compress_wide(st, w, one);
  else sha256::compress(st, w);
}

// sha256(b"leaf:" || the byte_size bytes at v) into st
__device__ __forceinline__ void leaf_hash(const uint8_t* v, int byte_size, uint32_t st[8], uint32_t one) {
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
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = sha256::H0[k];
  compress<true>(st, w, one);
}

// sha256(b"node:" || left || right) into st
template <bool WIDE>
__device__ __forceinline__ void node_hash(const uint32_t left[8], const uint32_t right[8], uint32_t st[8],
                                          uint32_t one) {
  uint32_t s[17];  // left || right, then the padding's first word
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] = left[k];
    s[8 + k] = right[k];
  }
  s[16] = 0x80000000u;
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = sha256::H0[k];
  uint32_t w[16];
  w[0] = 0x6E6F6465u;  // "node"
  w[1] = 0x3A000000u | (s[0] >> 8);  // ":" and the left digest's first 3 bytes
#pragma unroll
  for (int j = 2; j < 16; ++j) w[j] = (s[j - 2] << 24) | (s[j - 1] >> 8);
  compress<WIDE>(st, w, one);
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = 0;
  w[0] = (s[14] << 24) | (s[15] >> 8);
  w[1] = (s[15] << 24) | (s[16] >> 8);
  w[15] = 69 * 8;
  compress<WIDE>(st, w, one);
}

// The tree over n leaves (vals: n rows of byte_size bytes) into tree; a
// grid of n / (blockDim.x << p) blocks, each over blockDim.x << p
// consecutive leaves. one: 1 (compress_wide).
__global__ void __launch_bounds__(THREADS, 1) build_kernel(const uint8_t* __restrict__ vals, int byte_size, long long n,
                                                           int p, uint32_t* tree, int* counter, uint32_t one) {
  __shared__ uint4 level[2][THREADS][2];  // a level's digests, then the next one's
  __shared__ bool last;
  const int t = threadIdx.x, T = blockDim.x;
  const long long per = 1LL << p;
  const long long first = (long long)blockIdx.x * T * per;  // the block's first leaf
  uint32_t cur[8];
  // the block's leaves, then its levels 1 .. p, each level's nodes spread
  // over the threads (neighbouring threads, neighbouring digests) and its
  // children read back from the tree buffer after the barrier
  for (long long j = 0; j < per; ++j) {
    const long long i = first + j * T + t;
    leaf_hash(vals + i * byte_size, byte_size, cur, one);
    store_digest(tree + 8 * i, cur);
  }
  for (int l = 1; l <= p; ++l) {
    __syncthreads();
    const uint32_t* below = tree + 8 * (level_offset(n, l - 1) + (first >> (l - 1)));
    uint32_t* here = tree + 8 * (level_offset(n, l) + (first >> l));
    for (long long j = 0; j < (per >> l); ++j) {
      const long long i = j * T + t;
      uint32_t left[8], right[8];
      load_digest(below + 16 * i, left);
      load_digest(below + 16 * i + 8, right);
      node_hash<true>(left, right, cur, one);
      store_digest(here + 8 * i, cur);
    }
  }
  // one node a thread (level p): the block's levels above them in shared
  // memory, then, in the last block, the levels above the blocks' roots;
  // one loop, so the top runs code the block has just run
  int l = p, buf = 0, m = T / 2;
  long long base = blockIdx.x;  // this block's first node of a level is base * m
  store_digest(reinterpret_cast<uint32_t*>(level[0][t]), cur);
  for (bool top = false;; top = true) {
    for (; m >= 1; m >>= 1) {
      __syncthreads();
      ++l;
      if (t < m) {
        uint32_t left[8], right[8];
        load_digest(reinterpret_cast<const uint32_t*>(level[buf][2 * t]), left);
        load_digest(reinterpret_cast<const uint32_t*>(level[buf][2 * t + 1]), right);
        node_hash<false>(left, right, cur, one);
        store_digest(tree + 8 * (level_offset(n, l) + base * m + t), cur);
        store_digest(reinterpret_cast<uint32_t*>(level[buf ^ 1][t]), cur);
      }
      buf ^= 1;
    }
    if (top || gridDim.x == 1) break;
    // thread 0 stored this block's root: publish it, then take a ticket
    if (t == 0) {
      __threadfence();
      last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
      if (last) __threadfence();
    }
    __syncthreads();
    if (!last) return;
    for (int r = t; r < (int)gridDim.x; r += T) {
      const uint4* root = reinterpret_cast<const uint4*>(tree + 8 * (level_offset(n, l) + r));
      level[buf][r][0] = __ldcg(root);
      level[buf][r][1] = __ldcg(root + 1);
    }
    m = gridDim.x / 2;
    base = 0;
  }
  if (gridDim.x > 1 && t == 0) *counter = 0;
}

}  // namespace

// The whole tree over n leaves in one launch. vals: n rows of byte_size
// bytes (1 <= byte_size <= 8); tree: 2n - 1 digests of 8 u32 words, 16-byte
// aligned; counter: one int, 0 (and 0 again after the launch). The grid:
// blocks x threads threads, each over 2^p leaves, blocks <= ROOTS and <= 2
// threads, both powers of two, threads <= THREADS (ops/merkle_kernel.plan).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ts_merkle_build_launch(const void* vals, int byte_size, long long n, int blocks, int threads, int p,
                                      void* tree, void* counter, void* stream) {
  if (byte_size < 1 || byte_size > 8 || n < 1 || blocks < 1 || blocks > ROOTS || threads < 1 || threads > THREADS ||
      (threads & (threads - 1)) || (blocks & (blocks - 1)) || blocks > 2 * threads || p < 0 || p > 40 ||
      ((long long)blocks * threads << p) != n)
    return (int)cudaErrorInvalidValue;
  build_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(vals), byte_size, n, p, static_cast<uint32_t*>(tree), static_cast<int*>(counter), 1u);
  return (int)cudaGetLastError();
}
