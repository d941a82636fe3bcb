// nttverify — standalone native verification gate.
//
// The reference ships a C++ host driver whose job ends in an elementwise
// compare against a CPU oracle with PASS/FAIL exit codes
// (reference src/test.cpp:203-247). This binary is that role for this
// framework, decoupled from Python: the JAX side dumps (input, claimed
// output) vectors to a file, and this independently-compiled C++ oracle
// recomputes and compares — a cross-language bit-exactness gate.
//
// File format (little-endian):
//   char[4]  "NTTV"            magic
//   u32      version (1)
//   u32      kind: 0=forward DIF (bitrev order), 1=cyclic polymul,
//                  2=negacyclic polymul (via NTT; needs a 2n-th root),
//                  3=negacyclic schoolbook (root field ignored; gates
//                    incomplete-NTT rings like ML-KEM)
//   u64      p, u64 n, u64 root (omega for kinds 0-1, psi for kind 2)
//   u64[n]   input a
//   u64[n]   input b            (kinds 1-2 only)
//   u64[n]   claimed output
//
// Usage: nttverify <file>   — prints PASS!/FAIL., exits 0/1.
//
// Build: make -C native  (target nttverify)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
uint64_t ntt_modpow(uint64_t, uint64_t, uint64_t);
void ntt_dif_u64(uint64_t*, int64_t, uint64_t, uint64_t);
void ntt_cyclic_polymul_u64(const uint64_t*, const uint64_t*, uint64_t*,
                            int64_t, uint64_t, uint64_t);
void ntt_negacyclic_polymul_u64(const uint64_t*, const uint64_t*, uint64_t*,
                                int64_t, uint64_t, uint64_t);
void ntt_schoolbook_negacyclic_u64(const uint64_t*, const uint64_t*,
                                   uint64_t*, int64_t, uint64_t);
}

static bool read_exact(FILE* f, void* dst, size_t bytes) {
    return fread(dst, 1, bytes, f) == bytes;
}

int main(int argc, char** argv) {
    if (argc != 2) {
        fprintf(stderr, "usage: %s <vectors.nttv>\n", argv[0]);
        return 2;
    }
    FILE* f = fopen(argv[1], "rb");
    if (!f) {
        fprintf(stderr, "cannot open %s\n", argv[1]);
        return 2;
    }
    char magic[4];
    uint32_t version = 0, kind = 0;
    uint64_t p = 0, n = 0, root = 0;
    // n capped at 2^30: rejects corrupt headers in the 'bad header' path
    // instead of letting the vector constructors throw std::bad_alloc.
    if (!read_exact(f, magic, 4) || memcmp(magic, "NTTV", 4) != 0 ||
        !read_exact(f, &version, 4) || version != 1 ||
        !read_exact(f, &kind, 4) || kind > 3 || !read_exact(f, &p, 8) ||
        !read_exact(f, &n, 8) || !read_exact(f, &root, 8) || n == 0 ||
        (n & (n - 1)) != 0 || n > (1ull << 30)) {
        fprintf(stderr, "bad header\n");
        fclose(f);
        return 2;
    }
    std::vector<uint64_t> a(n), b, claimed(n), want(n);
    bool payload_ok = read_exact(f, a.data(), n * 8);
    if (payload_ok && kind >= 1) {
        b.resize(n);
        payload_ok = read_exact(f, b.data(), n * 8);
    }
    payload_ok = payload_ok && read_exact(f, claimed.data(), n * 8);
    fclose(f);
    if (!payload_ok) {
        fprintf(stderr, "truncated payload\n");
        return 2;
    }

    if (kind == 0) {
        want = a;
        ntt_dif_u64(want.data(), (int64_t)n, root, p);
    } else if (kind == 1) {
        ntt_cyclic_polymul_u64(a.data(), b.data(), want.data(), (int64_t)n,
                               root, p);
    } else if (kind == 2) {
        ntt_negacyclic_polymul_u64(a.data(), b.data(), want.data(),
                                   (int64_t)n, root, p);
    } else {
        ntt_schoolbook_negacyclic_u64(a.data(), b.data(), want.data(),
                                      (int64_t)n, p);
    }

    // Elementwise compare with mismatch reporting, the reference's gate
    // shape (src/test.cpp:221-247).
    uint64_t errors = 0;
    for (uint64_t i = 0; i < n; i++) {
        if (want[i] != claimed[i]) {
            if (errors < 8) {
                fprintf(stderr,
                        "mismatch at %llu: claimed %llu, oracle %llu\n",
                        (unsigned long long)i,
                        (unsigned long long)claimed[i],
                        (unsigned long long)want[i]);
            }
            errors++;
        }
    }
    if (errors) {
        printf("FAIL. (%llu / %llu mismatches)\n", (unsigned long long)errors,
               (unsigned long long)n);
        return 1;
    }
    printf("PASS!\n");
    return 0;
}
