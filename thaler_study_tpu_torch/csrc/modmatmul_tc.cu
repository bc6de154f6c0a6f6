// Exact modular matrix product C = A B^T mod p on Hopper's int8 tensor
// cores (wgmma), over Goldilocks or a mont32 field (p < 2^31), with the
// triangle IP's round-sum epilogue.
//
// Replaces: thaler_study_tpu/ops/modmatmul.py _mxu_modmatmul_impl :160 and
// its digit split _to_digits :106, the int8 digit form that the JAX package
// runs on the TPU's matrix unit for a contraction grid of 2^24 and up
// (ops/round_kernel.py :204-205) and for modmatmul at m n k >= 2^18 (:75-76).
// csrc/modmatmul.cu, the CUDA-core kernel, is the counterpart of
// modmatmul_impl; ops/modmatmul.py routes between the two by those rules.
// Modes as in csrc/modmatmul.cu: 0 writes C; 1 (DOT) writes one partial sum
// of D * C per tile and not C; 2 (VIEW + DOT) takes the views A_t = A_lo +
// t (A_hi - A_lo) and D_t likewise.
//
// Digits. digits_kernel splits every word into unsigned bytes, 8 for a
// Goldilocks word and 4 for a mont32 word, and writes them as planes
// [D][R][Kp] of u8 (Kp = K rounded up to 16 bytes, the pad zero): K-major,
// the only layout wgmma takes for 8-bit operands. The JAX package uses
// balanced signed digits and a carry digit (9 and 5) because its matrix
// unit multiplies s8; wgmma multiplies u8 x u8 into s32, so plain bytes need
// no carry digit: 64 and 16 digit pairs per product instead of 81 and 25.
// In mode 2 the pass folds the view first, so A_t is split as it is formed;
// B (f2) is the same for every t of a round, and the caller splits it once.
//
// Products. A block owns 64 rows of B and TILE_A rows of A; each of its two
// warpgroups takes ROWS_A of them (16 Goldilocks, 32 mont32), so B's tile
// serves twice the rows of A and one warpgroup's wgmmas run while the other
// reads fragments or drains. TMA stages 128-byte K slabs of both tiles,
// every digit plane, 128B-swizzled, in a ring of STAGES with one mbarrier
// per stage. Per 32-byte K step each warp reads B's D planes into
// registers as wgmma A fragments (64 rows x 32 bytes per plane, 4 registers
// a thread), then one wgmma m64n16k32 (m64n32k32 mont32) per digit pair
// (i, j) multiplies B's plane j by A's plane i, read from shared memory,
// into the accumulator of diagonal s = i + j, whose weight is 256^s. A
// thread holds 2D - 1 diagonal sums of ROWS_A / 2 outputs (120 registers
// Goldilocks, 112 mont32); no digit-pair grid is ever stored. Each
// diagonal's registers are one accumulator that every pair feeding it
// chains on: wgmma orders accumulation only through the same registers, and
// an instruction over several diagonals at once (N = D ROWS_A, each
// diagonal a column block) would name shifted, overlapping register ranges
// from one plane of B to the next, which gave wrong sums on the card.
//
// Exactness. A diagonal takes at most D pairs per k (8 Goldilocks, 4
// mont32), each <= 255^2, so D 255^2 K_c < 2^31 holds for K_c = 4096
// (Goldilocks) and 8192 (mont32): every s32 accumulator holds its true,
// non-negative value. After every K_c of K a thread flushes: it recombines
// its diagonals into one field word per output, adds it mod p to a running
// word, and zeroes them.
//
// Recombination. Goldilocks: X = sum_s diag_s 256^s as one 192-bit integer
// and one reduction. mont32: the words are Montgomery words, so the digit
// sums give X = sum (aR)(bR) = (sum ab) R^2, and REDC(diag_s (256^s mod p))
// = diag_s 256^s R^-1 (diag_s < 2^31, so the product is < p 2^32): their sum
// mod p is X R^-1, the Montgomery word of sum ab that _mxu_modmatmul_impl
// gives (:202-217), with no wide integer. Modes 1 and 2 multiply by D (D_t)
// in registers and write one partial per block: C never reaches device
// memory. The partials are row-major over tiles of TILE_A x 64 outputs.
//
// What bounds it on the H100: tensor-core operations, D^2 digit products
// of 8 bits per field product at 989.5 T multiply-adds per second (int8,
// dense). The blocks run in groups of GROUP B tiles down every A tile, so
// that a wave's tiles share the 50 MB L2.
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include "goldilocks.cuh"
#include "mont32.cuh"

namespace {

constexpr int BK = 128;       // K bytes per stage: one 128-byte swizzled row
constexpr int ROWS_B = 64;    // rows of B per block: wgmma's M
constexpr int WGS = 2;        // consumer warpgroups per block, one B tile between them
constexpr int THREADS = 128 * WGS;
constexpr int GROUP = 8;      // B tiles per group of the launch order

template <int D>
struct Geometry {
  static constexpr int ROWS_A = 128 / D;      // wgmma's N: 16, 32 rows of A per warpgroup
  static constexpr int TILE_A = WGS * ROWS_A;  // rows of A per block
  static constexpr int DIAG = 2 * D - 1;      // 15, 7
  static constexpr int Q = ROWS_A / 2;        // outputs per thread: 8, 16
  static constexpr int B_BYTES = D * ROWS_B * BK;
  static constexpr int A_BYTES = D * TILE_A * BK;
  static constexpr int STAGES = D == 8 ? 2 : 3;
  static constexpr int KC = D == 8 ? 4096 : 8192;  // flush length
  static constexpr int SMEM = STAGES * (A_BYTES + B_BYTES) + 8 * STAGES + 1024;
  static_assert(KC % BK == 0, "a flush falls on a stage boundary");
  static_assert(SMEM <= 232448, "the ring fits in shared memory");
};

struct GlTc {
  static constexpr int D = 8;
  using word = uint64_t;
  using Acc = gl::Acc;
  __device__ __forceinline__ word add(word a, word b) const { return gl::add(a, b); }
  __device__ __forceinline__ word fold(word lo, word hi, word r) const { return gl::fold(lo, hi, r); }
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const {
    gl::acc_add(acc, a * b, __umul64hi(a, b));
  }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return gl::acc_reduce(acc); }
  // sum_s diag[s] 256^s mod p, as a 192-bit integer and one reduction
  template <int S, int Q>
  __device__ __forceinline__ word recombine(const uint32_t (&acc)[S][Q], int q) const {
    Acc x{0, 0, 0};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = (8 * s) & 63;
      const uint64_t lo = (uint64_t)acc[s][q] << r;
      const uint64_t hi = r ? (uint64_t)acc[s][q] >> (64 - r) : 0;
      if (8 * s < 64) {
        gl::acc_add(x, lo, hi);
      } else {
        x.hi += lo;
        x.top += hi + (x.hi < lo ? 1u : 0u);
      }
    }
    return gl::acc_reduce(x);
  }
};

struct M32Tc : m32::Field {
  static constexpr int D = 4;
  using word = uint32_t;
  using Acc = m32::Acc;
  uint32_t pow256[2 * D - 1];  // 256^s mod p (plain integers)
  __device__ __forceinline__ void acc_add(Acc& acc, word a, word b) const { m32::acc_add(acc, (uint64_t)a * b); }
  __device__ __forceinline__ word acc_reduce(const Acc& acc) const { return m32::acc_reduce(*this, acc); }
  // sum_s REDC(diag[s] 256^s) mod p: the Montgomery word of the digit sums' value
  template <int S, int Q>
  __device__ __forceinline__ word recombine(const uint32_t (&acc)[S][Q], int q) const {
    word v = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) v = add(v, redc((uint64_t)acc[s][q] * pow256[s]));
    return v;
  }
};

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one 3-D box of digit planes {K bytes, rows, planes} into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"((uint64_t)map), "r"(bar), "r"(k), "r"(row), "r"(0)
      : "memory");
}

// K-major operand, 128-byte rows, 128B swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

template <int S, int Q>
__device__ __forceinline__ void fence_operands(uint32_t (&acc)[S][Q]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int q = 0; q < Q; ++q) asm volatile("" : "+r"(acc[s][q])::"memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// d += (B plane fragment a: 64 rows x 32 bytes, in registers) x (A plane:
// Q * 2 rows x 32 bytes at desc_a)^T: wgmma m64n16k32 (Q = 8) or m64n32k32
// (Q = 16), u8 x u8 -> s32
template <int Q>
__device__ __forceinline__ void mma_pair(uint32_t (&d)[Q], const uint32_t (&a)[4], uint64_t desc_a) {
  if constexpr (Q == 8) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_a), "r"(1));
  } else {
    static_assert(Q == 16, "m64n16k32 or m64n32k32");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_a), "r"(1));
  }
}

__device__ __forceinline__ uint32_t shfl_down(uint32_t x, int off) {
  return __shfl_down_sync(0xffffffffu, x, off);
}
__device__ __forceinline__ uint64_t shfl_down(uint64_t x, int off) {
  return (uint64_t)__shfl_down_sync(0xffffffffu, (unsigned long long)x, off);
}

// ---- the digit planes --------------------------------------------------------

// out [D][R][kp]: thread e writes bytes 4 (e % (kp / 4)) .. + 3 of row
// e / (kp / 4) in every plane (words at k >= K give 0)
template <class F, bool VIEW>
__global__ void digits_kernel(F f, const typename F::word* __restrict__ x, typename F::word t,
                              uint8_t* __restrict__ out, int R, int K, int kp) {
  using W = typename F::word;
  constexpr int D = F::D;
  const int quads = kp / 4;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)R * quads) return;
  const int row = (int)(e / quads), k0 = (int)(e % quads) * 4;
  const long long hi = (long long)R * K;  // VIEW: the upper half starts R rows on
  uint32_t packed[D];
#pragma unroll
  for (int s = 0; s < D; ++s) packed[s] = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + i;
    if (k < K) {
      const long long at = (long long)row * K + k;
      const W w = VIEW ? f.fold(x[at], x[at + hi], t) : x[at];
#pragma unroll
      for (int s = 0; s < D; ++s) packed[s] |= (uint32_t)((w >> (8 * s)) & 0xFF) << (8 * i);
    }
  }
#pragma unroll
  for (int s = 0; s < D; ++s)
    *reinterpret_cast<uint32_t*>(out + ((long long)s * R + row) * kp + k0) = packed[s];
}

// ---- the product ---------------------------------------------------------------

// grid = na * nb blocks (na A tiles of TILE_A rows, nb B tiles of 64 rows),
// THREADS threads, Geometry<D>::SMEM bytes of dynamic shared memory.
template <class F, bool VIEW, bool DOT>
__global__ void __launch_bounds__(THREADS, 1)
    tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b, F f,
              typename F::word* __restrict__ c, const typename F::word* __restrict__ dt, typename F::word t,
              typename F::word* __restrict__ partials, int M, int N, int K, int na, int nb) {
  using G = Geometry<F::D>;
  using W = typename F::word;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_ring = base;                             // STAGES x B_BYTES
  const uint32_t a_ring = base + G::STAGES * G::B_BYTES;    // STAGES x A_BYTES
  const uint32_t bars = a_ring + G::STAGES * G::A_BYTES;    // STAGES mbarriers

  // launch order: groups of GROUP B tiles, each walking down every A tile
  const int per_group = GROUP * na;
  const int first = (blockIdx.x / per_group) * GROUP;
  const int in_group = blockIdx.x % per_group;
  const int gsize = min(nb - first, GROUP);
  const int b_tile = first + in_group % gsize, a_tile = in_group / gsize;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int row_b0 = b_tile * ROWS_B, row_a0 = a_tile * G::TILE_A + wg * G::ROWS_A;
  const int stages_k = (K + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < G::STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_stage = [&](int s, int kt) {
    const uint32_t bar = bars + 8 * s;
    mbar_expect_tx(bar, G::A_BYTES + G::B_BYTES);
    tma_load(b_ring + s * G::B_BYTES, &map_b, bar, kt * BK, row_b0);
    tma_load(a_ring + s * G::A_BYTES, &map_a, bar, kt * BK, a_tile * G::TILE_A);
  };
  if (tid == 0)
    for (int s = 0; s < G::STAGES && s < stages_k; ++s) load_stage(s, s);

  uint32_t acc[G::DIAG][G::Q];
  W run[G::Q];
#pragma unroll
  for (int q = 0; q < G::Q; ++q) {
    run[q] = 0;
#pragma unroll
    for (int s = 0; s < G::DIAG; ++s) acc[s][q] = 0;
  }
  for (int kt = 0; kt < stages_k; ++kt) {
    const int s = kt % G::STAGES;
    mbar_wait(bars + 8 * s, (kt / G::STAGES) & 1);
    // this warpgroup's rows of A in every plane: wg * ROWS_A .. of TILE_A
    const uint32_t b_tile = b_ring + s * G::B_BYTES, a_tile_s = a_ring + s * G::A_BYTES + wg * G::ROWS_A * BK;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      // B's planes at this 32-byte K step as wgmma A fragments (rows lane /
      // 4 and + 8 of the warp's 16, bytes 4 (lane % 4) and + 16), read
      // through the 128B swizzle: 16-byte chunk c of row r sits at c ^ (r % 8)
      uint32_t frag[F::D][4];
      const uint32_t row = b_tile + (16 * warp + (lane >> 2)) * BK + 4 * (lane & 3);
      const uint32_t c0 = ((2 * kk) ^ ((lane >> 2) & 7)) << 4, c1 = ((2 * kk + 1) ^ ((lane >> 2) & 7)) << 4;
#pragma unroll
      for (int j = 0; j < F::D; ++j) {
        const uint32_t plane = row + j * ROWS_B * BK;
        frag[j][0] = lds32(plane + c0);
        frag[j][1] = lds32(plane + 8 * BK + c0);
        frag[j][2] = lds32(plane + c1);
        frag[j][3] = lds32(plane + 8 * BK + c1);
      }
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // digit pair (i, j) into diagonal i + j: each diagonal's registers are
      // one accumulator, chained across the pairs and K steps that feed it
#pragma unroll
      for (int j = 0; j < F::D; ++j)
#pragma unroll
        for (int i = 0; i < F::D; ++i)
          mma_pair<G::Q>(acc[i + j], frag[j], smem_desc(a_tile_s + i * G::TILE_A * BK + 32 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
    }
    __syncthreads();  // every warp's reads of stage s are done: refill it
    if (tid == 0 && kt + G::STAGES < stages_k) load_stage(s, kt + G::STAGES);
    if ((kt + 1) % (G::KC / BK) == 0 || kt + 1 == stages_k) {
#pragma unroll
      for (int q = 0; q < G::Q; ++q) {
        run[q] = f.add(run[q], f.template recombine<G::DIAG, G::Q>(acc, q));
#pragma unroll
        for (int d = 0; d < G::DIAG; ++d) acc[d][q] = 0;
      }
    }
  }

  // output q of this thread: the wgmma accumulator layout (row of B: 16 per
  // warp, lanes / 4, + 8; column = row of A: 8 per register quad, lane % 4)
  typename F::Acc dot{};
#pragma unroll
  for (int q = 0; q < G::Q; ++q) {
    const int a_row = row_a0 + 8 * (q >> 2) + 2 * (lane & 3) + (q & 1);
    const int b_row = row_b0 + 16 * warp + (lane >> 2) + 8 * ((q >> 1) & 1);
    if (a_row < M && b_row < N) {
      const long long idx = (long long)a_row * N + b_row;
      if (!DOT) {
        c[idx] = run[q];
      } else {
        const W dv = VIEW ? f.fold(dt[idx], dt[idx + (long long)M * N], t) : dt[idx];
        f.acc_add(dot, dv, run[q]);
      }
    }
  }
  if (!DOT) return;
  __shared__ W warp_sums[THREADS / 32];
  W x = f.acc_reduce(dot);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = f.add(x, shfl_down(x, off));
  if (lane == 0) warp_sums[tid >> 5] = x;
  __syncthreads();
  if (tid == 0) {
    W total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total = f.add(total, warp_sums[w]);
    partials[(long long)a_tile * nb + b_tile] = total;
  }
}

// ---- host side -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, from the libcuda.so.1 the process
// already runs on (no link against libcuda, no runtime-API version rules)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

constexpr int ERR_NO_ENCODE = 10001, ERR_ENCODE = 10002;

int plane_map(CUtensorMap* map, const void* planes, int D, int rows, int kp, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return ERR_NO_ENCODE;
  const cuuint64_t dims[3] = {(cuuint64_t)kp, (cuuint64_t)rows, (cuuint64_t)D};
  const cuuint64_t strides[2] = {(cuuint64_t)kp, (cuuint64_t)rows * kp};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, (cuuint32_t)D};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(planes), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <class F, bool VIEW, bool DOT>
int launch_tc(const F& f, const void* a_planes, const void* b_planes, int kp, void* c, const void* d, uint64_t t,
              void* partials, int M, int N, int K, cudaStream_t s) {
  using G = Geometry<F::D>;
  using W = typename F::word;
  CUtensorMap map_a, map_b;
  int rc = plane_map(&map_a, a_planes, F::D, M, kp, G::TILE_A);
  if (!rc) rc = plane_map(&map_b, b_planes, F::D, N, kp, ROWS_B);
  if (rc) return rc;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(tc_kernel<F, VIEW, DOT>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int na = (M + G::TILE_A - 1) / G::TILE_A, nb = (N + ROWS_B - 1) / ROWS_B;
  tc_kernel<F, VIEW, DOT><<<na * nb, THREADS, G::SMEM, s>>>(
      map_a, map_b, f, static_cast<W*>(c), static_cast<const W*>(d), (W)t, static_cast<W*>(partials), M, N, K,
      na, nb);
  return 0;
}

template <class F>
int launch_mode(const F& f, int mode, const void* a_planes, const void* b_planes, int kp, void* c, const void* d,
                uint64_t t, void* partials, int M, int N, int K, cudaStream_t s) {
  if (M < 1 || N < 1 || K < 1 || kp < K || kp % 16) return (int)cudaErrorInvalidValue;
  if (mode == 0) return launch_tc<F, false, false>(f, a_planes, b_planes, kp, c, d, t, partials, M, N, K, s);
  if (mode == 1) return launch_tc<F, false, true>(f, a_planes, b_planes, kp, c, d, t, partials, M, N, K, s);
  if (mode == 2) return launch_tc<F, true, true>(f, a_planes, b_planes, kp, c, d, t, partials, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

template <class F>
int launch_digits(const F& f, const void* x, uint64_t t, int view, void* out, int R, int K, int kp, cudaStream_t s) {
  using W = typename F::word;
  if (R < 1 || K < 1 || kp < K || kp % 16) return (int)cudaErrorInvalidValue;
  const long long total = (long long)R * (kp / 4);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const W* xp = static_cast<const W*>(x);
  uint8_t* op = static_cast<uint8_t*>(out);
  if (view) digits_kernel<F, true><<<(unsigned)blocks, threads, 0, s>>>(f, xp, (W)t, op, R, K, kp);
  else digits_kernel<F, false><<<(unsigned)blocks, threads, 0, s>>>(f, xp, (W)t, op, R, K, kp);
  return 0;
}

M32Tc m32_ops(unsigned p, unsigned pinv) {
  M32Tc f;
  f.p = p;
  f.pinv = pinv;
  uint64_t w = 1 % p;
  for (int s = 0; s < 2 * M32Tc::D - 1; ++s) {
    f.pow256[s] = (uint32_t)w;
    w = w * 256 % p;
  }
  return f;
}

}  // namespace

// The digit planes [D][R][kp] (u8; D = 8 Goldilocks, 4 mont32; kp >= K, a
// multiple of 16) of the words x [R, K], or with view = 1 of the view x_lo
// + t (x_hi - x_lo) of x [2R, K] (t a word of the field: Montgomery for
// mont32). Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ts_mm_tc_digits(int mont32, unsigned p, unsigned pinv, const void* x, unsigned long long t, int view,
                               void* out, int R, int K, int kp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = mont32 ? launch_digits(m32_ops(p, pinv), x, t, view, out, R, K, kp, s)
                        : launch_digits(GlTc{}, x, t, view, out, R, K, kp, s);
  return rc ? rc : (int)cudaGetLastError();
}

// C = A B^T from the digit planes of A [M, K] and B [N, K] (each [D][rows][kp]).
// mode 0: c [M, N] written; mode 1: DOT (d [M, N]; partials: one word per
// tile of TILE_A x 64 outputs, row-major over the (ceil(M / TILE_A),
// ceil(N / 64)) tiles, TILE_A = 32 Goldilocks, 64 mont32); mode 2: DOT with
// the view D_t of d [2M, N] (A's planes already of A_t). Unused pointers are
// null. Returns 10001 where libcuda's cuTensorMapEncodeTiled cannot be
// found, 10002 where it refuses a map, else cudaGetLastError() after the
// launch (0 = launched); the wrapper checks every argument first.
extern "C" int ts_mm_tc_launch(int mont32, unsigned p, unsigned pinv, int mode, const void* a_planes,
                               const void* b_planes, int kp, void* c, const void* d, unsigned long long t,
                               void* partials, int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = mont32 ? launch_mode(m32_ops(p, pinv), mode, a_planes, b_planes, kp, c, d, t, partials, M, N, K, s)
                        : launch_mode(GlTc{}, mode, a_planes, b_planes, kp, c, d, t, partials, M, N, K, s);
  return rc ? rc : (int)cudaGetLastError();
}
