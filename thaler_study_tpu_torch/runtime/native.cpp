// Host runtime of the port: exact u64 field arithmetic for the GKR
// verifier's O(gates) and O(2^n) work (eq tables, the sparse wiring
// predicates, MLE evaluations), the dense-W prover's wiring tables and the fused GKR prover's SHA-256 midstate
// over its Begin message.
//
// The port's own copy of the functions it uses from
// thaler_study_tpu/runtime/native.cpp (ts_eq_table, ts_wiring_scatter,
// ts_wiring_eval_sparse, ts_mle_fold, ts_mle_eval, ts_sha256_blocks), with
// one addition: products
// mod Goldilocks reduce with 2^64 == 2^32 - 1 instead of a 128-bit
// division.
//
// Plain C ABI (loaded with ctypes); arrays are caller-allocated numpy
// buffers. All values are canonical residues < p < 2^64.

#include <cstdint>

using u64 = uint64_t;
using u128 = unsigned __int128;

namespace {

constexpr u64 GL_P = 0xFFFFFFFF00000001ull;
constexpr u64 GL_EPS = 0xFFFFFFFFull;  // 2^64 mod p

inline u64 addmod(u64 a, u64 b, u64 p) {
    u64 s = a + b;
    if (s < a || s >= p) s -= p;
    return s;
}

inline u64 submod(u64 a, u64 b, u64 p) { return a >= b ? a - b : a + (p - b); }

// (hi * 2^64 + lo) mod the Goldilocks prime (2^96 == -1)
inline u64 gl_reduce128(u64 lo, u64 hi) {
    const u64 hh = hi >> 32, hl = hi & GL_EPS;
    u64 t0 = lo - hh;
    if (lo < hh) t0 -= GL_EPS;
    const u64 t1 = (hl << 32) - hl;
    u64 r = t0 + t1;
    if (r < t1) r += GL_EPS;
    return r >= GL_P ? r - GL_P : r;
}

inline u64 mulmod(u64 a, u64 b, u64 p) {
    const u128 t = (u128)a * (u128)b;
    if (p == GL_P) return gl_reduce128((u64)t, (u64)(t >> 64));
    return (u64)(t % p);
}

// SHA-256 round constants (FIPS 180-4)
const uint32_t SHA256_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

}  // namespace

extern "C" {

// Advance a SHA-256 midstate over n_blocks full 64-byte blocks of data:
// the Fiat-Shamir chain's midstate over a large transcript prefix (the
// GKR Begin message, megabytes at 2^20 outputs), hashed once.
void ts_sha256_blocks(const uint8_t* data, int64_t n_blocks, uint32_t* state) {
    for (int64_t blk = 0; blk < n_blocks; ++blk) {
        const uint8_t* b = data + 64 * blk;
        uint32_t w[64];
        for (int i = 0; i < 16; ++i)
            w[i] = ((uint32_t)b[4 * i] << 24) | ((uint32_t)b[4 * i + 1] << 16) |
                   ((uint32_t)b[4 * i + 2] << 8) | (uint32_t)b[4 * i + 3];
        for (int i = 16; i < 64; ++i) {
            const uint32_t s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3);
            const uint32_t s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = state[0], bb = state[1], c = state[2], d = state[3];
        uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
        for (int i = 0; i < 64; ++i) {
            const uint32_t s1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
            const uint32_t ch = (e & f) ^ (~e & g);
            const uint32_t t1 = h + s1 + ch + SHA256_K[i] + w[i];
            const uint32_t s0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
            const uint32_t maj = (a & bb) ^ (a & c) ^ (bb & c);
            const uint32_t t2 = s0 + maj;
            h = g; g = f; f = e; e = d + t1;
            d = c; c = bb; bb = a; a = t1 + t2;
        }
        state[0] += a; state[1] += bb; state[2] += c; state[3] += d;
        state[4] += e; state[5] += f; state[6] += g; state[7] += h;
    }
}

// eq-weight table over n variables at point r, little-endian index order:
// out[idx] = prod_j (r[j] if bit_j(idx) else 1 - r[j]), by doubling from
// the last variable to the first.
void ts_eq_table(const u64* r, int32_t n, u64* out, u64 p) {
    out[0] = 1 % p;
    int64_t size = 1;
    for (int32_t j = n - 1; j >= 0; --j) {
        const u64 rj = r[j] % p;
        for (int64_t i = size - 1; i >= 0; --i) {
            const u64 w = out[i];
            const u64 hi = mulmod(w, rj, p);
            out[2 * i + 1] = hi;
            out[2 * i] = submod(w, hi, p);
        }
        size <<= 1;
    }
}

// Sparse wiring-predicate evaluation at a full point:
//   sum over selected gates g of eq_r[g] * eq_b[b_idx[g]] * eq_c[c_idx[g]]
u64 ts_wiring_eval_sparse(const u64* eq_r, const u64* eq_b, const u64* eq_c,
                          const int32_t* b_idx, const int32_t* c_idx,
                          const uint8_t* sel, int64_t n_gates, u64 p) {
    u64 acc = 0;
    for (int64_t g = 0; g < n_gates; ++g) {
        if (!sel[g]) continue;
        const u64 t = mulmod(eq_r[g] % p, eq_b[b_idx[g]] % p, p);
        acc = addmod(acc, mulmod(t, eq_c[c_idx[g]] % p, p), p);
    }
    return acc;
}

// GKR wiring scatter: grid[(c_idx[g] << k_next) | b_idx[g]] += eq_w[g]
// for every gate g with sel[g] != 0. grid has 2^(2*k_next) entries and
// must be zero-initialized by the caller.
void ts_wiring_scatter(const int32_t* b_idx, const int32_t* c_idx,
                       const uint8_t* sel, const u64* eq_w, int64_t n_gates,
                       int32_t k_next, u64* grid, u64 p) {
    for (int64_t g = 0; g < n_gates; ++g) {
        if (!sel[g]) continue;
        const int64_t pos = ((int64_t)c_idx[g] << k_next) | (int64_t)b_idx[g];
        grid[pos] = addmod(grid[pos], eq_w[g] % p, p);
    }
}

// MLE fold in half (little-endian pairs): out[i] = e[2i] + r (e[2i+1] - e[2i]).
void ts_mle_fold(const u64* evals, int64_t n, u64 r, u64* out, u64 p) {
    for (int64_t i = 0; i < n / 2; ++i) {
        const u64 lo = evals[2 * i] % p, hi = evals[2 * i + 1] % p;
        out[i] = addmod(lo, mulmod(submod(hi, lo, p), r % p, p), p);
    }
}

// MLE evaluation at a point (little-endian variable order), folding into
// the caller's scratch of n / 2 words.
u64 ts_mle_eval(const u64* evals, int64_t n, const u64* point, int32_t nvars,
                u64* scratch, u64 p) {
    const u64* src = evals;
    int64_t size = n;
    for (int32_t j = 0; j < nvars; ++j) {
        ts_mle_fold(src, size, point[j], scratch, p);
        src = scratch;
        size /= 2;
    }
    return size == 1 ? src[0] % p : 0;
}

}  // extern "C"
