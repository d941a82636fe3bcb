"""Field/constants tests (L0 math core)."""

import pytest

from ntt_aie import fields as F


def test_shipped_generators_are_primitive():
    for f in [F.KYBER, F.DILITHIUM, F.P_998244353, F.P_2013265921]:
        # g is primitive iff g^((p-1)/q) != 1 for all prime factors q
        for q in F._factorize(f.p - 1):
            assert F.modpow(f.g, (f.p - 1) // q, f.p) != 1, (f.name, q)


def test_goldilocks_generator():
    f = F.GOLDILOCKS
    assert f.p == 2**64 - 2**32 + 1
    # order of 7 divides p-1; check a few cofactors: p-1 = 2^32 * 3 * 5 * 17 * 257 * 65537
    for q in [2, 3, 5, 17, 257, 65537]:
        assert (f.p - 1) % q == 0
        assert F.modpow(f.g, (f.p - 1) // q, f.p) != 1


def test_max_ntt_size():
    assert F.KYBER.max_n == 256  # p-1 = 2^8 * 13
    assert F.P_998244353.max_n == 2**23
    assert F.P_2013265921.max_n == 2**27
    assert F.GOLDILOCKS.max_n == 2**32


def test_barrett_constants_match_reference():
    # reference src/aie2.py:18-19: w = ceil(log2 p) = 12, u = 2^(2w)//p = 5039
    f = F.KYBER
    assert f.barrett_w == 12
    assert f.barrett_u == 5039
    assert f.supports_barrett32


def test_montgomery_constants():
    for f in [F.P_998244353, F.P_2013265921, F.DILITHIUM, F.KYBER]:
        assert f.supports_mont32
        # p * p^-1 == 1 mod R ; neg_pinv = -p^-1
        assert (f.p * (-f.mont_neg_pinv)) % f.mont_r == 1
        assert f.mont_r2_mod_p == pow(2, 64, f.p)
        # REDC identity: to_mont then reduce by R recovers x
        x = 123456789 % f.p
        assert (f.to_mont(x) * pow(f.mont_r, -1, f.p)) % f.p == x


def test_root_of_unity():
    f = F.P_2013265921
    n = 1 << 16
    w = f.root_of_unity(n)
    assert F.modpow(w, n, f.p) == 1
    assert F.modpow(w, n // 2, f.p) == f.p - 1  # primitive


def test_default_reduction():
    assert F.KYBER.default_reduction() == "barrett"
    assert F.P_2013265921.default_reduction() == "montgomery"
    assert F.GOLDILOCKS.default_reduction() == "goldilocks"
    with pytest.raises(ValueError):
        F.PrimeField(p=(1 << 61) - 1, g=3).default_reduction()
