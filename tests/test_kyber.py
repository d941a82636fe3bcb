"""ML-KEM (FIPS 203) Kyber NTT: device vs a from-scratch scalar
implementation of the standard, plus the ring product vs schoolbook."""

import numpy as np

from ntt_aie import fields as F
from ntt_aie import kyber as K
from ntt_aie import reference as ref

Q = 3329


def _bitrev7(x):
    r = 0
    for _ in range(7):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _scalar_ntt(f):
    """FIPS 203 Algorithm 9, straight transcription."""
    f = [int(v) for v in f]
    k = 1
    length = 128
    while length >= 2:
        for start in range(0, 256, 2 * length):
            zeta = pow(17, _bitrev7(k), Q)
            k += 1
            for j in range(start, start + length):
                t = zeta * f[j + length] % Q
                f[j + length] = (f[j] - t) % Q
                f[j] = (f[j] + t) % Q
        length //= 2
    return np.array(f)


def _scalar_intt(fh):
    """FIPS 203 Algorithm 10, straight transcription."""
    f = [int(v) for v in fh]
    k = 127
    length = 2
    while length <= 128:
        for start in range(0, 256, 2 * length):
            zeta = pow(17, _bitrev7(k), Q)
            k -= 1
            for j in range(start, start + length):
                t = f[j]
                f[j] = (t + f[j + length]) % Q
                f[j + length] = zeta * (f[j + length] - t) % Q
        length *= 2
    return np.array([v * 3303 % Q for v in f])


def test_ntt_matches_fips_scalar(rng):
    f = rng.integers(0, Q, 256)
    got = np.asarray(K.kyber_ntt(f.astype(np.uint32)))
    assert np.array_equal(got.astype(np.int64), _scalar_ntt(f))


def test_intt_matches_fips_scalar_and_roundtrip(rng):
    f = rng.integers(0, Q, 256)
    fh = _scalar_ntt(f)
    got = np.asarray(K.kyber_intt(fh.astype(np.uint32)))
    assert np.array_equal(got.astype(np.int64), _scalar_intt(fh))
    assert np.array_equal(got.astype(np.int64), f)
    back = np.asarray(K.kyber_intt(K.kyber_ntt(f.astype(np.uint32))))
    assert np.array_equal(back.astype(np.int64), f)


def test_polymul_matches_schoolbook_negacyclic(rng):
    a = rng.integers(0, Q, 256)
    b = rng.integers(0, Q, 256)
    got = np.asarray(K.kyber_polymul(a.astype(np.uint32), b.astype(np.uint32)))
    want = ref.schoolbook_negacyclic(a, b, Q)
    assert np.array_equal(got.astype(np.int64), want)


def test_batched(rng):
    B = 4
    a = rng.integers(0, Q, (B, 256)).astype(np.uint32)
    got = np.asarray(K.kyber_ntt(a))
    for i in range(B):
        assert np.array_equal(got[i], np.asarray(K.kyber_ntt(a[i])))
    back = np.asarray(K.kyber_intt(got))
    assert np.array_equal(back, a)


def test_mlkem_native_schoolbook_gate(tmp_path, rng):
    """The ML-KEM ring product against the independently compiled C++
    schoolbook oracle (CLAUDE.md: every device path gets a native gate)."""
    from ntt_aie import native_oracle as native

    a = rng.integers(0, Q, 256)
    b = rng.integers(0, Q, 256)
    got = np.asarray(K.kyber_polymul(a.astype(np.uint32), b.astype(np.uint32)))
    path = tmp_path / "mlkem.nttv"
    native.write_vectors(path, "negacyclic_schoolbook", Q, 256, 0,
                         a.astype(np.uint64), got.astype(np.uint64),
                         b=b.astype(np.uint64))
    assert native.run_verify_gate(path)
    bad = got.copy()
    bad[0] ^= 1
    native.write_vectors(path, "negacyclic_schoolbook", Q, 256, 0,
                         a.astype(np.uint64), bad.astype(np.uint64),
                         b=b.astype(np.uint64))
    assert not native.run_verify_gate(path)

def test_matvec_matches_schoolbook(rng):
    """t = A*s over the module lattice (k=l=2, the ML-KEM-512 shape):
    NTT-domain matvec vs per-entry schoolbook products summed in Z_q."""
    k = 2
    A = rng.integers(0, Q, (k, k, 256))
    s = rng.integers(0, Q, (k, 256))
    Ah = np.asarray(K.kyber_ntt(A.astype(np.uint32)))
    sh = np.asarray(K.kyber_ntt(s.astype(np.uint32)))
    th = np.asarray(K.kyber_matvec(Ah, sh))
    got = np.asarray(K.kyber_intt(th)).astype(np.int64)
    for i in range(k):
        want = np.zeros(256, dtype=np.int64)
        for j in range(k):
            want = (want + ref.schoolbook_negacyclic(A[i, j], s[j], Q)) % Q
        assert np.array_equal(got[i], want)


def test_matvec_batched_broadcast(rng):
    """Batched A (B,k,l,256) against batched s (B,l,256): regression for
    basemul's batch-flattening vs the shared-vector broadcast."""
    B, k = 3, 2
    A = rng.integers(0, Q, (B, k, k, 256)).astype(np.uint32)
    s = rng.integers(0, Q, (B, k, 256)).astype(np.uint32)
    got = np.asarray(K.kyber_matvec(A, s))
    assert got.shape == (B, k, 256)
    for b in range(B):
        assert np.array_equal(got[b], np.asarray(K.kyber_matvec(A[b], s[b])))


def test_matvec_shared_matrix_batched_vectors(rng):
    """A fixed per key, a batch of s vectors — the K-PKE serving shape
    (regression: this shape used to raise on the kyber side only)."""
    B, k = 3, 2
    A = rng.integers(0, Q, (k, k, 256)).astype(np.uint32)
    s = rng.integers(0, Q, (B, k, 256)).astype(np.uint32)
    got = np.asarray(K.kyber_matvec(A, s))
    assert got.shape == (B, k, 256)
    for b in range(B):
        assert np.array_equal(got[b], np.asarray(K.kyber_matvec(A, s[b])))


def test_matvec_native_gate(rng):
    """Matvec summation vs the native C++ schoolbook oracle: each term
    product comes from C++, the sum is exact host arithmetic."""
    from ntt_aie import native_oracle as native

    k = 2
    A = rng.integers(0, Q, (k, k, 256))
    s = rng.integers(0, Q, (k, 256))
    got = np.asarray(K.kyber_intt(K.kyber_matvec(
        K.kyber_ntt(A.astype(np.uint32)), K.kyber_ntt(s.astype(np.uint32)))))
    for i in range(k):
        want = np.zeros(256, dtype=np.uint64)
        for j in range(k):
            want = (want + native.schoolbook_negacyclic(
                A[i, j].astype(np.uint64), s[j].astype(np.uint64), Q)) % Q
        assert np.array_equal(got[i].astype(np.uint64), want)


def test_make_pipeline_matches_module_fns(rng):
    """The jitted pipeline bundle (the documented hot path) is bit-exact
    with the bare module functions, including the fixed-A serving form."""
    pipe = K.make_pipeline()
    k = 2
    A = rng.integers(0, Q, (4, k, k, 256)).astype(np.uint32)
    s = rng.integers(0, Q, (4, k, 256)).astype(np.uint32)
    a = rng.integers(0, Q, 256).astype(np.uint32)
    b = rng.integers(0, Q, 256).astype(np.uint32)

    assert np.array_equal(np.asarray(pipe["ntt"](a)), np.asarray(K.kyber_ntt(a)))
    assert np.array_equal(np.asarray(pipe["intt"](a)), np.asarray(K.kyber_intt(a)))
    assert np.array_equal(np.asarray(pipe["polymul"](a, b)),
                          np.asarray(K.kyber_polymul(a, b)))
    want = np.asarray(K.kyber_intt(K.kyber_matvec(K.kyber_ntt(A),
                                                  K.kyber_ntt(s))))
    assert np.array_equal(np.asarray(pipe["serving_step"](A, s)), want)
    # fixed-A serving: one key's matrix against a batch of vectors
    A_hat = pipe["ntt"](A[0])
    step = pipe["make_serving_step"](A_hat)
    got = np.asarray(step(s))
    ref_fixed = np.asarray(K.kyber_intt(K.kyber_matvec(K.kyber_ntt(A[0]),
                                                       K.kyber_ntt(s))))
    assert np.array_equal(got, ref_fixed)
