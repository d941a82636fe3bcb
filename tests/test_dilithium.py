"""ML-DSA (FIPS 204) Dilithium NTT: device vs a straight scalar
transcription of the standard, plus the ring product vs schoolbook and the
C++ schoolbook gate."""

import numpy as np

from ntt_aie import dilithium as D
from ntt_aie import reference as ref

Q = 8380417


def _bitrev8(x):
    r = 0
    for _ in range(8):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _scalar_ntt(f):
    """FIPS 204 Algorithm 41, straight transcription."""
    f = [int(v) for v in f]
    k = 0
    length = 128
    while length >= 1:
        for start in range(0, 256, 2 * length):
            k += 1
            zeta = pow(1753, _bitrev8(k), Q)
            for j in range(start, start + length):
                t = zeta * f[j + length] % Q
                f[j + length] = (f[j] - t) % Q
                f[j] = (f[j] + t) % Q
        length //= 2
    return np.array(f)


def _scalar_intt(fh):
    """FIPS 204 Algorithm 42, straight transcription."""
    f = [int(v) for v in fh]
    k = 256
    length = 1
    while length < 256:
        for start in range(0, 256, 2 * length):
            k -= 1
            zeta = -pow(1753, _bitrev8(k), Q) % Q
            for j in range(start, start + length):
                t = f[j]
                f[j] = (t + f[j + length]) % Q
                f[j + length] = zeta * (t - f[j + length]) % Q
        length *= 2
    f256 = 8347681  # 256^-1 mod q
    return np.array([v * f256 % Q for v in f])


def test_ntt_matches_fips_scalar(rng):
    f = rng.integers(0, Q, 256)
    got = np.asarray(D.dilithium_ntt(f.astype(np.uint32)))
    assert np.array_equal(got.astype(np.int64), _scalar_ntt(f))


def test_intt_matches_fips_scalar_and_roundtrip(rng):
    f = rng.integers(0, Q, 256)
    fh = _scalar_ntt(f)
    got = np.asarray(D.dilithium_intt(fh.astype(np.uint32)))
    assert np.array_equal(got.astype(np.int64), _scalar_intt(fh))
    assert np.array_equal(got.astype(np.int64), f)


def test_polymul_matches_schoolbook_negacyclic(rng):
    a = rng.integers(0, Q, 256)
    b = rng.integers(0, Q, 256)
    got = np.asarray(D.dilithium_polymul(a.astype(np.uint32),
                                         b.astype(np.uint32)))
    want = ref.schoolbook_negacyclic(a, b, Q)
    assert np.array_equal(got.astype(np.int64), want)


def test_native_schoolbook_gate(tmp_path, rng):
    from ntt_aie import native_oracle as native

    a = rng.integers(0, Q, 256)
    b = rng.integers(0, Q, 256)
    got = np.asarray(D.dilithium_polymul(a.astype(np.uint32),
                                         b.astype(np.uint32)))
    path = tmp_path / "mldsa.nttv"
    native.write_vectors(path, "negacyclic_schoolbook", Q, 256, 0,
                         a.astype(np.uint64), got.astype(np.uint64),
                         b=b.astype(np.uint64))
    assert native.run_verify_gate(path)


def test_batched(rng):
    B = 4
    a = rng.integers(0, Q, (B, 256)).astype(np.uint32)
    got = np.asarray(D.dilithium_ntt(a))
    for i in range(B):
        assert np.array_equal(got[i], np.asarray(D.dilithium_ntt(a[i])))
    assert np.array_equal(np.asarray(D.dilithium_intt(got)), a)

def test_matvec_matches_schoolbook(rng):
    """w = A*y over the module lattice (k=3, l=2): NTT-domain matvec vs
    per-entry schoolbook negacyclic products summed in Z_q."""
    k, l = 3, 2
    A = rng.integers(0, Q, (k, l, 256))
    y = rng.integers(0, Q, (l, 256))
    Ah = np.asarray(D.dilithium_ntt(A.astype(np.uint32)))
    yh = np.asarray(D.dilithium_ntt(y.astype(np.uint32)))
    wh = np.asarray(D.dilithium_matvec(Ah, yh))
    got = np.asarray(D.dilithium_intt(wh)).astype(np.int64)
    for i in range(k):
        want = np.zeros(256, dtype=np.int64)
        for j in range(l):
            want = (want + ref.schoolbook_negacyclic(A[i, j], y[j], Q)) % Q
        assert np.array_equal(got[i], want)


def test_matvec_batched_broadcast(rng):
    B, k, l = 3, 4, 2
    A = rng.integers(0, Q, (B, k, l, 256)).astype(np.uint32)
    y = rng.integers(0, Q, (B, l, 256)).astype(np.uint32)
    got = np.asarray(D.dilithium_matvec(A, y))
    assert got.shape == (B, k, 256)
    for b in range(B):
        assert np.array_equal(got[b],
                              np.asarray(D.dilithium_matvec(A[b], y[b])))


def test_matvec_shared_matrix_batched_vectors(rng):
    """A fixed per key, a batch of y vectors (the Sign serving shape)."""
    B, k, l = 3, 3, 2
    A = rng.integers(0, Q, (k, l, 256)).astype(np.uint32)
    y = rng.integers(0, Q, (B, l, 256)).astype(np.uint32)
    got = np.asarray(D.dilithium_matvec(A, y))
    assert got.shape == (B, k, 256)
    for b in range(B):
        assert np.array_equal(got[b], np.asarray(D.dilithium_matvec(A, y[b])))


def test_matvec_native_gate(rng):
    """Matvec summation vs the native C++ schoolbook oracle."""
    from ntt_aie import native_oracle as native

    k, l = 2, 2
    A = rng.integers(0, Q, (k, l, 256))
    y = rng.integers(0, Q, (l, 256))
    got = np.asarray(D.dilithium_intt(D.dilithium_matvec(
        D.dilithium_ntt(A.astype(np.uint32)),
        D.dilithium_ntt(y.astype(np.uint32)))))
    for i in range(k):
        want = np.zeros(256, dtype=np.uint64)
        for j in range(l):
            want = (want + native.schoolbook_negacyclic(
                A[i, j].astype(np.uint64), y[j].astype(np.uint64), Q)) % Q
        assert np.array_equal(got[i].astype(np.uint64), want)


def test_make_pipeline_matches_module_fns(rng):
    """The jitted pipeline bundle is bit-exact with the bare module
    functions, including the fixed-A serving form."""
    pipe = D.make_pipeline()
    k, l = 3, 2
    A = rng.integers(0, Q, (4, k, l, 256)).astype(np.uint32)
    y = rng.integers(0, Q, (4, l, 256)).astype(np.uint32)
    a = rng.integers(0, Q, 256).astype(np.uint32)
    b = rng.integers(0, Q, 256).astype(np.uint32)

    assert np.array_equal(np.asarray(pipe["ntt"](a)),
                          np.asarray(D.dilithium_ntt(a)))
    assert np.array_equal(np.asarray(pipe["polymul"](a, b)),
                          np.asarray(D.dilithium_polymul(a, b)))
    want = np.asarray(D.dilithium_intt(D.dilithium_matvec(
        D.dilithium_ntt(A), D.dilithium_ntt(y))))
    assert np.array_equal(np.asarray(pipe["serving_step"](A, y)), want)
    step = pipe["make_serving_step"](pipe["ntt"](A[0]))
    got = np.asarray(step(y))
    ref_fixed = np.asarray(D.dilithium_intt(D.dilithium_matvec(
        D.dilithium_ntt(A[0]), D.dilithium_ntt(y))))
    assert np.array_equal(got, ref_fixed)
