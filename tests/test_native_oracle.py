"""Native C++ oracle vs NumPy oracle: the two golden models must agree
bit-exactly (SURVEY.md §4: 'NumPy + C++ oracles, bit-exact against each
other')."""

import numpy as np
import pytest

from ntt_aie import fields as F
from ntt_aie import reference as ref
from ntt_aie import twiddles as tw

native = pytest.importorskip("ntt_aie.native_oracle")

try:
    native.load()
    HAVE_NATIVE = True
except native.NativeOracleUnavailable:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="no native toolchain")


def test_modpow():
    lib = native.load()
    for base, e, m in [(3, 3328, 3329), (7, 2**32, F.GOLDILOCKS.p), (2, 0, 97)]:
        assert lib.ntt_modpow(base, e, m) == pow(base, e, m)


def test_power_table_matches_numpy():
    for n, f in [(2048, F.KYBER), (256, F.KYBER), (1024, F.P_2013265921)]:
        got = native.make_power_table(n, f.p, f.g)
        want = tw.power_table(f, n)
        assert np.array_equal(got, want)


def test_reference_network_matches_numpy():
    n = 1 << 11
    f = F.KYBER
    table = tw.power_table(f, n)
    a = np.arange(n)
    for stages in [0, 3, 10, None]:
        got = native.reference_network(a, table, f.p, stages)
        want = ref.reference_network(a, table, f.p, stages)
        assert np.array_equal(got, want), f"stages={stages}"


def test_end_to_end_reference_parity():
    """Full reference pipeline in native code == NumPy pipeline == the
    reference device semantics (src/test.cpp:203-219)."""
    n = 1 << 11
    f = F.KYBER
    a = np.arange(n)
    table = native.make_power_table(n, f.p, f.g)
    full = native.reference_network(a, table, f.p)
    dev = native.block_permute16(full)
    assert np.array_equal(dev, ref.reference_device_output(a, f, n))


def test_barrett_scalar_model(rng):
    f = F.KYBER
    w, u = f.barrett_w, f.barrett_u
    a = rng.integers(0, f.p, 500)
    b = rng.integers(0, f.p, 500)
    for x, y in zip(a, b):
        assert native.barrett_mulmod(int(x), int(y), f.p, w, u) == int(x) * int(y) % f.p


def test_montgomery_scalar_model(rng):
    for f in [F.P_998244353, F.P_2013265921, F.DILITHIUM]:
        neg_pinv = f.mont_neg_pinv
        rinv = pow(f.mont_r, -1, f.p)
        a = rng.integers(0, f.p, 200)
        b = rng.integers(0, f.p, 200)
        for x, y in zip(a, b):
            got = native.mont_mulmod(int(x), int(y), f.p, neg_pinv)
            assert got == int(x) * int(y) * rinv % f.p


def test_goldilocks_scalar_model(rng):
    p = F.GOLDILOCKS.p
    a = rng.integers(0, 2**64, 500, dtype=np.uint64)
    b = rng.integers(0, 2**64, 500, dtype=np.uint64)
    for x, y in zip(a, b):
        x, y = int(x) % p, int(y) % p
        assert native.goldilocks_mulmod(x, y) == x * y % p
    # reduction edge cases
    for v in [0, 1, p - 1, p, p + 1, 2**64 - 1, (p - 1) ** 2, 2**128 - 1 - 2**96]:
        want = v % p
        if v < 2**128:
            assert native.goldilocks_reduce128(v) == want, hex(v)


def test_true_ntt_matches_numpy(rng):
    f = F.P_2013265921
    n = 1 << 12
    omega = f.root_of_unity(n)
    a = rng.integers(0, f.p, n)
    got = native.ntt_dif(a, omega, f.p)
    want = ref.ntt_dif(a, f)
    assert np.array_equal(got.astype(np.int64), want)
    back = native.ntt_dit(got, f.inv(omega), f.p, scale=True)
    assert np.array_equal(back.astype(np.int64), a)


def test_goldilocks_ntt_native(rng):
    f = F.GOLDILOCKS
    n = 256
    omega = f.root_of_unity(n)
    a = rng.integers(0, 2**63, n, dtype=np.uint64)
    fwd = native.ntt_dif(a, omega, f.p)
    back = native.ntt_dit(fwd, f.inv(omega), f.p, scale=True)
    assert np.array_equal(back, a % np.uint64(f.p))
    # cross-check vs numpy object-dtype oracle
    want = ref.ntt_dif(a.astype(object), f)
    assert np.array_equal(fwd.astype(object), want)


def test_native_polymul_oracles(rng):
    """C++ cyclic/negacyclic polymul vs the NumPy oracle."""
    from ntt_aie import fields as F
    from ntt_aie import reference as ref
    from ntt_aie import native_oracle as native

    field = F.P_2013265921
    n = 64
    a = rng.integers(0, field.p, n).astype(np.uint64)
    b = rng.integers(0, field.p, n).astype(np.uint64)
    got = native.cyclic_polymul(a, b, field.root_of_unity(n), field.p)
    want = ref.cyclic_polymul(a.astype(np.int64), b.astype(np.int64), field)
    assert np.array_equal(got.astype(np.int64), want)
    gotn = native.negacyclic_polymul(a, b, field.root_of_unity(2 * n), field.p)
    wantn = ref.negacyclic_polymul(a.astype(np.int64), b.astype(np.int64), field)
    assert np.array_equal(gotn.astype(np.int64), wantn)

    # Goldilocks path through the same entry points
    GL = F.GOLDILOCKS
    v = rng.integers(0, 1 << 62, 32, dtype=np.uint64) % np.uint64(GL.p)
    w = rng.integers(0, 1 << 62, 32, dtype=np.uint64) % np.uint64(GL.p)
    got_gl = native.cyclic_polymul(v, w, GL.root_of_unity(32), GL.p)
    want_gl = ref.schoolbook_cyclic(v.astype(object), w.astype(object), GL.p)
    assert np.array_equal(got_gl.astype(object), want_gl.astype(object))


def test_nttverify_gate_roundtrip(tmp_path, rng):
    """The standalone binary PASSes on honest vectors, FAILs on corrupted."""
    from ntt_aie import fields as F
    from ntt_aie import native_oracle as native

    field = F.P_469762049
    n = 256
    a = rng.integers(0, field.p, n).astype(np.uint64)
    omega = field.root_of_unity(n)
    claimed = native.ntt_dif(a, omega, field.p)
    path = tmp_path / "v.nttv"
    native.write_vectors(path, "forward", field.p, n, omega, a, claimed)
    assert native.run_verify_gate(path)
    claimed[3] ^= 1
    native.write_vectors(path, "forward", field.p, n, omega, a, claimed)
    assert not native.run_verify_gate(path)
