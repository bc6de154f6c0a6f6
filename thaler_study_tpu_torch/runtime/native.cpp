// Host runtime of the port: exact u64 field arithmetic for the GKR
// verifier's O(gates) and O(2^n) work (eq tables, the sparse wiring
// predicates, MLE evaluations).
//
// The port's own copy of the functions it uses from
// thaler_study_tpu/runtime/native.cpp (ts_eq_table, ts_wiring_eval_sparse,
// ts_mle_fold, ts_mle_eval), with one addition: products mod Goldilocks
// reduce with 2^64 == 2^32 - 1 instead of a 128-bit division.
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

}  // namespace

extern "C" {

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
