// Native host-side GF(2) polynomial engine.
//
// The port's own copy of homomorph_tpu/native/gf2_native.cpp (the JAX
// package's host engine): a 64-bit-word bit-packed GF(2) engine used by
// homomorph_tpu_torch for
//   * the decrypt mask of every degree class (gf2_decrypt_mask), which the
//     card then applies as a popcount parity,
//   * the X^i mod S table behind the linear-map remainder
//     (gf2_reduction_rows),
//   * an independently written oracle for the port's kernels and torch ops.
//
// Word layout matches the reference (and the device limb layout):
// coefficient of X^i is bit (i % 64) of word (i / 64), LSB-first
// (reference: src/polynomial.rs:16-21); serialization is the LE byte
// concatenation of words (src/polynomial.rs:98-122).
//
// Exposed as a flat C ABI for ctypes.  Built at first use by
// homomorph_tpu_torch/native/__init__.py with portable flags (no
// -march=native), so a library built on one machine runs on another.

#include <cstdint>
#include <cstring>

extern "C" {

// Degree of a polynomial: index of highest set bit, 0 for null
// (null-polynomial degree-0 convention, src/polynomial.rs:124-137).
int64_t gf2_degree(const uint64_t* a, int64_t n) {
    for (int64_t i = n - 1; i >= 0; --i) {
        if (a[i]) return 64 * i + 63 - __builtin_clzll(a[i]);
    }
    return 0;
}

// r = a ^ b; r has max(na, nb) words (caller allocates).
void gf2_xor(const uint64_t* a, int64_t na, const uint64_t* b, int64_t nb,
             uint64_t* r) {
    int64_t n = na > nb ? na : nb;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t av = i < na ? a[i] : 0, bv = i < nb ? b[i] : 0;
        r[i] = av ^ bv;
    }
}

// Carry-less multiply: r (na+nb words, caller-zeroed) ^= a * b.
void gf2_clmul(const uint64_t* a, int64_t na, const uint64_t* b, int64_t nb,
               uint64_t* r) {
    for (int64_t i = 0; i < na; ++i) {
        uint64_t ai = a[i];
        while (ai) {
            int k = __builtin_ctzll(ai);
            ai &= ai - 1;
            uint64_t carry = 0;
            for (int64_t j = 0; j < nb; ++j) {
                uint64_t lo = (b[j] << k) | carry;
                carry = k ? (b[j] >> (64 - k)) : 0;
                r[i + j] ^= lo;
            }
            if (carry) r[i + nb] ^= carry;
        }
    }
}

// In-place remainder: r (nr words) <- r mod s, deg(s) = sd exactly.
// Branch-free-in-data shift-XOR division (same recurrence as the
// reference's rem, src/polynomial.rs:316-365).
void gf2_rem(uint64_t* r, int64_t nr, const uint64_t* s, int64_t ns,
             int64_t sd) {
    int64_t rd = gf2_degree(r, nr);
    while (rd >= sd && (r[rd / 64] >> (rd % 64) & 1)) {
        int64_t shift = rd - sd;
        int64_t ws = shift / 64, bs = shift % 64;
        for (int64_t j = 0; j < ns; ++j) {
            if (ws + j < nr) r[ws + j] ^= s[j] << bs;
            if (bs && ws + j + 1 < nr) r[ws + j + 1] ^= s[j] >> (64 - bs);
        }
        // incremental degree rescan
        while (rd > 0) {
            if (r[rd / 64] >> (rd % 64) & 1) break;
            --rd;
        }
        if (rd == 0 && !(r[0] & 1)) break;
        if (rd < sd) break;
    }
}

// Batched decrypt: for each of B ciphertexts (nl words each), output bit =
// parity(popcount(c & w)) - the linear-map decryption.
void gf2_decrypt_batch(const uint64_t* c, int64_t B, int64_t nl,
                       const uint64_t* w, uint8_t* out) {
    for (int64_t b = 0; b < B; ++b) {
        uint64_t acc = 0;
        const uint64_t* row = c + b * nl;
        for (int64_t j = 0; j < nl; ++j) acc ^= row[j] & w[j];
        out[b] = (uint8_t)(__builtin_popcountll(acc) & 1);
    }
}

// Batched encrypt: subset-XOR of public key rows.
//   pk:  [tau, nl] words;  sel: [B, tau] bytes (0/1);  x: [B] bytes
//   out: [B, nl] words = XOR_{i: sel} pk[i] ^ x   (src/cipher.rs:99-115)
void gf2_encrypt_batch(const uint64_t* pk, int64_t tau, int64_t nl,
                       const uint8_t* sel, const uint8_t* x, int64_t B,
                       uint64_t* out) {
    for (int64_t b = 0; b < B; ++b) {
        uint64_t* row = out + b * nl;
        std::memset(row, 0, (size_t)nl * 8);
        const uint8_t* sb = sel + b * tau;
        for (int64_t i = 0; i < tau; ++i) {
            if (sb[i]) {
                const uint64_t* p = pk + i * nl;
                for (int64_t j = 0; j < nl; ++j) row[j] ^= p[j];
            }
        }
        row[0] ^= (uint64_t)(x[b] & 1);
    }
}

// Decrypt mask: bit i of out = (X^i mod S)(0) for i < n_rows, bit-packed
// LSB-first into out ((n_rows+63)/64 words, caller-zeroed).  Same monic
// recurrence as gf2_reduction_rows but with a single-row workspace: at
// u32-product sizes (~25M rows) the full rows table is ~19 GB while the
// mask is n_rows bits.  The mask uploads once; decryption stays a device
// popcount parity.
void gf2_decrypt_mask(const uint64_t* s, int64_t ns, int64_t sd,
                      int64_t n_rows, uint64_t* out) {
    int64_t nw = sd / 64 + 1;
    uint64_t* r = new uint64_t[nw]();
    r[0] = 1;
    for (int64_t i = 0; i < n_rows; ++i) {
        out[i / 64] |= (r[0] & 1ULL) << (i % 64);
        uint64_t carry = 0;
        for (int64_t j = 0; j < nw; ++j) {
            uint64_t nv = (r[j] << 1) | carry;
            carry = r[j] >> 63;
            r[j] = nv;
        }
        if (r[sd / 64] >> (sd % 64) & 1) {
            for (int64_t j = 0; j < ns && j < nw; ++j) r[j] ^= s[j];
        }
    }
    delete[] r;
}

// Reduction rows: rows[i] = X^i mod S packed into ns words, for i < n_rows.
// S monic of exact degree sd.  (The table behind the linear-map decrypt.)
void gf2_reduction_rows(const uint64_t* s, int64_t ns, int64_t sd,
                        int64_t n_rows, uint64_t* rows) {
    int64_t nw = sd / 64 + 1;
    uint64_t* cur = rows;  // workspace: rows written sequentially
    // r_0 = 1
    std::memset(rows, 0, (size_t)n_rows * nw * 8);
    rows[0] = 1;
    for (int64_t i = 1; i < n_rows; ++i) {
        const uint64_t* prev = rows + (i - 1) * nw;
        uint64_t* r = rows + i * nw;
        uint64_t carry = 0;
        for (int64_t j = 0; j < nw; ++j) {
            r[j] = (prev[j] << 1) | carry;
            carry = prev[j] >> 63;
        }
        if (r[sd / 64] >> (sd % 64) & 1) {
            for (int64_t j = 0; j < ns && j < nw; ++j) r[j] ^= s[j];
        }
    }
    (void)cur;
}

}  // extern "C"
