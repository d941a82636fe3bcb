// Native golden-model oracle for ntt_aie.
//
// This framework's counterpart of the reference's C++ host oracle + vector
// generator (reference src/test.cpp:15-60: modPow/make_roots/ntt). This is
// a fresh implementation with exact 64-bit semantics, used by the test
// harness (via ctypes) to cross-check the NumPy oracle and the device
// kernels, and to generate reference vectors fast at large n.
//
// It also pins the *scalar models* of the three modular-multiplication
// strategies the device code implements (Barrett "2k", Montgomery REDC with
// R=2^32, Goldilocks two-limb), so kernel bit-exactness is defined against
// compiled native code, not just Python.
//
// Build: make -C native   (produces libnttoracle.so)

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Scalar primitives
// ---------------------------------------------------------------------------

// Iterative modpow over uint64 (the reference's recursive int32 modPow,
// src/test.cpp:15-25, overflows for p >= 2^16; this one is exact for
// p < 2^32 and exponents < 2^64).
uint64_t ntt_modpow(uint64_t base, uint64_t exp, uint64_t mod) {
    unsigned __int128 acc = 1;
    unsigned __int128 b = base % mod;
    while (exp) {
        if (exp & 1) acc = acc * b % mod;
        b = b * b % mod;
        exp >>= 1;
    }
    return (uint64_t)acc;
}

// Barrett "2k" variant, the reference's scalar model
// (src/aie_core.cc:27-39): w = bitlen(p), u = floor(2^(2w)/p).
uint32_t ntt_barrett_mulmod(uint32_t a, uint32_t b, uint32_t p, uint32_t w,
                            uint32_t u) {
    uint64_t t = (uint64_t)a * b;
    uint64_t x1 = t >> (w - 2);
    uint64_t s = (x1 * u) >> (w + 2);
    uint64_t c = t - s * p;
    if (c >= p) c -= p;
    return (uint32_t)c;
}

// Montgomery REDC with R = 2^32: given T = a*b < p*2^32, returns T*R^-1 mod p.
// neg_pinv = (-p)^-1 mod 2^32. Valid for odd p < 2^31.
uint32_t ntt_mont_redc(uint64_t t, uint32_t p, uint32_t neg_pinv) {
    uint32_t m = (uint32_t)t * neg_pinv;               // mod 2^32
    uint64_t s = (t + (uint64_t)m * p) >> 32;          // exact division
    if (s >= p) s -= p;
    return (uint32_t)s;
}

uint32_t ntt_mont_mulmod(uint32_t a, uint32_t b, uint32_t p,
                         uint32_t neg_pinv) {
    return ntt_mont_redc((uint64_t)a * b, p, neg_pinv);
}

// Goldilocks p = 2^64 - 2^32 + 1: reduce a 128-bit product using
// 2^64 ≡ 2^32 - 1 and 2^96 ≡ -1 (mod p).
static const uint64_t kGoldilocksP = 0xffffffff00000001ULL;

uint64_t ntt_goldilocks_reduce128(uint64_t hi, uint64_t lo) {
    uint64_t n3 = hi >> 32;          // bits 96..127
    uint64_t n2 = hi & 0xffffffffu;  // bits 64..95
    // x ≡ lo + n2*(2^32 - 1) - n3 (mod p)
    uint64_t r = lo;
    if (r >= kGoldilocksP) r -= kGoldilocksP;
    if (r < n3) r += kGoldilocksP;  // borrow
    r -= n3;
    uint64_t t1 = (n2 << 32) - n2;  // n2 * (2^32 - 1), fits uint64
    uint64_t s = r + t1;
    // On 2^64 wrap the true value gained 2^64 ≡ 2^32 - 1 (mod p); since the
    // wrapped s < r < p, adding 2^32-1 cannot wrap again.
    if (s < r) s += 0xffffffffULL;
    if (s >= kGoldilocksP) s -= kGoldilocksP;
    return s;
}

uint64_t ntt_goldilocks_mulmod(uint64_t a, uint64_t b) {
    unsigned __int128 t = (unsigned __int128)a * b;
    return ntt_goldilocks_reduce128((uint64_t)(t >> 64), (uint64_t)t);
}

// ---------------------------------------------------------------------------
// Reference-parity butterfly network (semantics of reference src/test.cpp:34-60)
// ---------------------------------------------------------------------------

// In-place, table-parameterized, Gentleman-Sande butterflies with
// increasing stride t = 1..n/2; stage s uses table[h+i], h = n >> (s+1).
// `stages`: run stages 0..stages inclusive (the test_stage hook); pass a
// huge value (or n) for full depth.
void ntt_reference_network(int64_t* a, int64_t n, const int64_t* table,
                           int64_t p, int64_t stages) {
    int64_t t = 1, idx = 0;
    for (int64_t m = n; m > 1; m >>= 1) {
        int64_t h = m >> 1;
        int64_t j1 = 0;
        for (int64_t i = 0; i < h; i++) {
            int64_t root = table[h + i];
            for (int64_t j = j1; j < j1 + t; j++) {
                int64_t v0 = a[j];
                int64_t v1 = a[j + t];
                a[j] = (v0 + v1) % p;
                a[j + t] = (int64_t)((unsigned __int128)((v0 + p - v1) % p) *
                                     (uint64_t)root % (uint64_t)p);
            }
            j1 += 2 * t;
        }
        if (idx == stages) return;
        t <<= 1;
        idx += 1;
    }
}

// Natural-order power table t[i] = w^i with w = g^((p-1)/n) — floor
// division, matching reference make_roots (src/test.cpp:27-32) exactly.
void ntt_make_power_table(int64_t* out, int64_t n, int64_t p, int64_t g) {
    uint64_t w = ntt_modpow((uint64_t)g, (uint64_t)((p - 1) / n), (uint64_t)p);
    out[0] = 1;
    for (int64_t i = 1; i < n; i++) {
        out[i] = (int64_t)((unsigned __int128)(uint64_t)out[i - 1] * w %
                           (uint64_t)p);
    }
}

// The reference device's 16-block output placement (src/test.cpp:69-71,
// 212-219): out block order[i] = in block i.
void ntt_block_permute16(const int64_t* in, int64_t* out, int64_t n) {
    static const int kOrder[16] = {0, 2, 1, 3, 8,  10, 9,  11,
                                   4, 6, 5, 7, 12, 14, 13, 15};
    int64_t bs = n / 16;
    for (int i = 0; i < 16; i++) {
        memcpy(out + kOrder[i] * bs, in + (int64_t)i * bs,
               (size_t)bs * sizeof(int64_t));
    }
}

// ---------------------------------------------------------------------------
// True NTTs (DIF natural->bitrev, DIT bitrev->natural), uint64 path
// ---------------------------------------------------------------------------

// omega must be a primitive n-th root of unity mod p, p < 2^32 or Goldilocks.
static inline uint64_t mulmod_u64(uint64_t a, uint64_t b, uint64_t p) {
    return (uint64_t)((unsigned __int128)a * b % p);
}

// u + v mod p without uint64 overflow (p may be ~2^64, e.g. Goldilocks).
static inline uint64_t addmod_u64(uint64_t u, uint64_t v, uint64_t p) {
    uint64_t t = p - v;
    return u >= t ? u - t : u + v;
}

void ntt_dif_u64(uint64_t* a, int64_t n, uint64_t omega, uint64_t p) {
    int logn = 0;
    while ((1LL << logn) < n) logn++;
    for (int s = 0; s < logn; s++) {
        int64_t t = n >> (s + 1);
        uint64_t wstep = ntt_modpow(omega, (uint64_t)(1LL << s), p);
        for (int64_t blk = 0; blk < n; blk += 2 * t) {
            uint64_t w = 1;
            for (int64_t j = 0; j < t; j++) {
                uint64_t u = a[blk + j];
                uint64_t v = a[blk + j + t];
                uint64_t sum = addmod_u64(u, v, p);
                uint64_t diff = u >= v ? u - v : (u + (p - v));
                a[blk + j] = sum;
                a[blk + j + t] = mulmod_u64(diff, w, p);
                w = mulmod_u64(w, wstep, p);
            }
        }
    }
}

void ntt_dit_u64(uint64_t* a, int64_t n, uint64_t omega, uint64_t p,
                 int scale_by_ninv) {
    int logn = 0;
    while ((1LL << logn) < n) logn++;
    for (int s = 0; s < logn; s++) {
        int64_t t = 1LL << s;
        uint64_t wstep = ntt_modpow(omega, (uint64_t)(n >> (s + 1)), p);
        for (int64_t blk = 0; blk < n; blk += 2 * t) {
            uint64_t w = 1;
            for (int64_t j = 0; j < t; j++) {
                uint64_t u = a[blk + j];
                uint64_t wv = mulmod_u64(a[blk + j + t], w, p);
                uint64_t sum = addmod_u64(u, wv, p);
                uint64_t diff = u >= wv ? u - wv : (u + (p - wv));
                a[blk + j] = sum;
                a[blk + j + t] = diff;
                w = mulmod_u64(w, wstep, p);
            }
        }
    }
    if (scale_by_ninv) {
        uint64_t ninv = ntt_modpow((uint64_t)n, p - 2, p);
        for (int64_t i = 0; i < n; i++) a[i] = mulmod_u64(a[i], ninv, p);
    }
}

// Batch helpers for fast test-vector generation.
void ntt_dif_u64_batch(uint64_t* a, int64_t batch, int64_t n, uint64_t omega,
                       uint64_t p) {
    for (int64_t i = 0; i < batch; i++) ntt_dif_u64(a + i * n, n, omega, p);
}

// ---------------------------------------------------------------------------
// Polynomial multiplication oracles (cyclic X^n - 1, negacyclic X^n + 1)
// ---------------------------------------------------------------------------

// c = a * b mod (X^n - 1, p) via DIF -> pointwise (bitrev order is
// pointwise-safe) -> inverse DIT with 1/n. omega: primitive n-th root.
void ntt_cyclic_polymul_u64(const uint64_t* a, const uint64_t* b, uint64_t* c,
                            int64_t n, uint64_t omega, uint64_t p) {
    uint64_t* fb = new uint64_t[n];
    for (int64_t i = 0; i < n; i++) {
        c[i] = a[i];
        fb[i] = b[i];
    }
    ntt_dif_u64(c, n, omega, p);
    ntt_dif_u64(fb, n, omega, p);
    for (int64_t i = 0; i < n; i++) c[i] = mulmod_u64(c[i], fb[i], p);
    uint64_t oinv = ntt_modpow(omega, p - 2, p);
    ntt_dit_u64(c, n, oinv, p, /*scale_by_ninv=*/1);
    delete[] fb;
}

// c = a * b mod (X^n + 1, p): psi-scale, cyclic polymul, inverse psi-scale.
// psi: primitive 2n-th root with psi^2 = omega.
void ntt_negacyclic_polymul_u64(const uint64_t* a, const uint64_t* b,
                                uint64_t* c, int64_t n, uint64_t psi,
                                uint64_t p) {
    uint64_t omega = mulmod_u64(psi, psi, p);
    uint64_t* ta = new uint64_t[n];
    uint64_t* tb = new uint64_t[n];
    uint64_t w = 1;
    for (int64_t i = 0; i < n; i++) {
        ta[i] = mulmod_u64(a[i], w, p);
        tb[i] = mulmod_u64(b[i], w, p);
        w = mulmod_u64(w, psi, p);
    }
    ntt_cyclic_polymul_u64(ta, tb, c, n, omega, p);
    uint64_t psi_inv = ntt_modpow(psi, p - 2, p);
    w = 1;
    for (int64_t i = 0; i < n; i++) {
        c[i] = mulmod_u64(c[i], w, p);
        w = mulmod_u64(w, psi_inv, p);
    }
    delete[] ta;
    delete[] tb;
}

// Direct O(n^2) schoolbook negacyclic product mod (X^n + 1, p): the gate
// for incomplete-NTT rings (e.g. ML-KEM's Z_3329[X]/(X^256+1), where no
// 2n-th root of unity exists so the NTT-based oracle above cannot run).
void ntt_schoolbook_negacyclic_u64(const uint64_t* a, const uint64_t* b,
                                   uint64_t* c, int64_t n, uint64_t p) {
    for (int64_t k = 0; k < n; k++) c[k] = 0;
    for (int64_t i = 0; i < n; i++) {
        for (int64_t j = 0; j < n; j++) {
            uint64_t prod = mulmod_u64(a[i], b[j], p);
            int64_t k = i + j;
            if (k < n) {
                c[k] = addmod_u64(c[k], prod, p);
            } else {
                uint64_t neg = prod == 0 ? 0 : p - prod;
                c[k - n] = addmod_u64(c[k - n], neg, p);
            }
        }
    }
}

}  // extern "C"
