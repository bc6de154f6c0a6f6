// The sharded layout of a factor table: a group's shard rows cut out of a
// 1-D table and transposed, over 64-bit (Goldilocks) or 32-bit (mont32)
// words.
//
// Replaces: the transpose before the device_put in the JAX package's
// shard_factor (thaler_study_tpu/parallel/sharded.py:79), the layout of
// every sharded factor table. The table's 2^n words are read as [L, S]
// (S = 2^n_shard shard rows, the table's last n_shard variables; L =
// 2^(n - n_shard) local entries) and the group's rows [row0, row0 + rows)
// are written as [rows, L]: out[s][l] = in[l S + row0 + s]. Its plain
// version is ops/shard_layout.shard_rows_plain (torch's .T.contiguous() of
// that view).
//
// What bounds it on the H100: device memory, each word read once and
// written once (2 x 2^28 Goldilocks words: 4.3 GB each way at n = 28). The
// problem is the narrow source row: at S = 8 a source row is 64 bytes, so
// a copy that walks either side word by word down a column moves a sector
// per word (.T.contiguous() reaches ~0.7 TB/s there).
//
// How. A block takes a tile of TL source rows x TC columns (TC: the
// group's rows rounded up to a power of two, at most 32; TL = TILE_BYTES /
// (TC words), at most L). It reads the tile in source order -- TL runs of
// TC contiguous words, one contiguous run of TL S words when the group
// holds every shard row -- with 16-byte loads where aligned, every load of
// a thread issued before its first store, into shared memory [TL][TC + 1]
// (an odd row pitch, so that a column's words fall in distinct banks).
// It then writes TC output rows of TL contiguous words, 16-byte stores
// where aligned. Columns past the group's last row are masked (the
// wrapper takes the 16-byte path only where none is). Offsets are 64-bit:
// the card holds tables above 2^31 words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_BYTES = 16384;

// 16 bytes as one load or store, seen as words
template <class W>
union Pack {
  uint4 v;
  W w[16 / sizeof(W)];
};

// VEC = 16 / sizeof(W) moves 16 bytes per access (the wrapper checks the
// alignment of both tables, row0, and that every tile is whole); VEC = 1
// one word per access, masked.
template <class W, int VEC>
__global__ void __launch_bounds__(THREADS)
    shard_rows_kernel(const W* __restrict__ in, W* __restrict__ out, long long L, long long S, long long row0,
                      int rows, int tc_log, int tl_log) {
  constexpr int PER = TILE_BYTES / (int)sizeof(W) / THREADS / VEC;  // accesses per thread and side
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* sm = reinterpret_cast<W*>(smem_raw);
  const int tc = 1 << tc_log, pitch = tc + 1;
  const int words = 1 << (tc_log + tl_log);  // the tile's words (a short table: fewer than the tile's room)
  const long long l0 = (long long)blockIdx.x << tl_log;
  const int c0 = blockIdx.y << tc_log;
  const int cols = min(tc, rows - c0);
  const W* src = in + l0 * S + row0 + c0;
  // 1. the tile in source order: word i is source row i >> tc_log, column
  // i & (tc - 1); every load first, then the stores
  if (VEC > 1) {
    Pack<W> v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = (threadIdx.x + k * THREADS) * VEC;
      if (i < words) v[k].v = __ldg(reinterpret_cast<const uint4*>(src + (long long)(i >> tc_log) * S + (i & (tc - 1))));
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = (threadIdx.x + k * THREADS) * VEC;
      if (i >= words) continue;
      W* s = sm + (i >> tc_log) * pitch + (i & (tc - 1));
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[e] = v[k].w[e];
    }
  } else {
    W v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * THREADS, c = i & (tc - 1);
      if (i < words && c < cols) v[k] = src[(long long)(i >> tc_log) * S + c];
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * THREADS, c = i & (tc - 1);
      if (i < words && c < cols) sm[(i >> tc_log) * pitch + c] = v[k];
    }
  }
  __syncthreads();
  // 2. the output rows: word j is row c0 + (j >> tl_log), entry l0 + (j & (TL - 1))
  W* dst = out + (long long)c0 * L + l0;
  const int tl_mask = (1 << tl_log) - 1;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = (threadIdx.x + k * THREADS) * VEC, c = j >> tl_log, l = j & tl_mask;
    if (j >= words || c >= cols) continue;
    W* o = dst + (long long)c * L + l;
    if (VEC > 1) {
      Pack<W> v;
#pragma unroll
      for (int e = 0; e < VEC; ++e) v.w[e] = sm[(l + e) * pitch + c];
      *reinterpret_cast<uint4*>(o) = v.v;
    } else {
      *o = sm[l * pitch + c];
    }
  }
}

template <class W>
int launch(const void* in, void* out, long long L, long long S, long long row0, int rows, int tc_log, int tl_log,
           int vec, cudaStream_t s) {
  constexpr int VEC = 16 / (int)sizeof(W);
  if (rows < 1 || tc_log < 0 || tl_log < 0 || (1 << (tc_log + tl_log)) * (int)sizeof(W) > TILE_BYTES ||
      (vec != 1 && vec != VEC) || L < (1ll << tl_log) || row0 < 0 || row0 + rows > S)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(L >> tl_log), (unsigned)((rows + (1 << tc_log) - 1) >> tc_log));
  const size_t smem = (size_t)(1 << tl_log) * ((1 << tc_log) + 1) * sizeof(W);
  const W* i = static_cast<const W*>(in);
  W* o = static_cast<W*>(out);
  if (vec == VEC) shard_rows_kernel<W, VEC><<<grid, THREADS, smem, s>>>(i, o, L, S, row0, rows, tc_log, tl_log);
  else shard_rows_kernel<W, 1><<<grid, THREADS, smem, s>>>(i, o, L, S, row0, rows, tc_log, tl_log);
  return 0;
}

}  // namespace

// in: L x S words of word_bytes (8 or 4) bytes; out: rows x L words.
// Tiles of 2^tc_log columns x 2^tl_log source rows (the wrapper's
// ops/shard_layout.tile); vec: words per access (16 / word_bytes, or 1).
// Returns cudaGetLastError() after the launch (0 = launched); the wrapper
// checks every argument first.
extern "C" int ts_shard_rows_launch(int word_bytes, const void* in, void* out, long long L, long long S,
                                    long long row0, int rows, int tc_log, int tl_log, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (word_bytes == 8) rc = launch<uint64_t>(in, out, L, S, row0, rows, tc_log, tl_log, vec, s);
  else if (word_bytes == 4) rc = launch<uint32_t>(in, out, L, S, row0, rows, tc_log, tl_log, vec, s);
  else rc = (int)cudaErrorInvalidValue;
  return rc ? rc : (int)cudaGetLastError();
}
