"""RNS multi-prime polymul + CRT: exact integer convolution."""

import numpy as np

from ntt_aie.rns import RNSPolymul


def _schoolbook_cyclic_int(a, b, n):
    c = [0] * n
    for i in range(n):
        for j in range(n):
            c[(i + j) % n] += int(a[i]) * int(b[j])
    return np.array(c, dtype=object)


def _schoolbook_negacyclic_int(a, b, n):
    c = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                c[k] += int(a[i]) * int(b[j])
            else:
                c[k - n] -= int(a[i]) * int(b[j])
    return np.array(c, dtype=object)


def test_rns_exact_big_coefficients(rng):
    log_n = 5
    n = 1 << log_n
    rns = RNSPolymul(log_n)
    bound = rns.max_input_bound()
    assert bound > (1 << 38)  # three ~30-bit primes minus n
    a = np.array([int(x) for x in rng.integers(0, 1 << 38, n)], dtype=object)
    b = np.array([int(x) for x in rng.integers(0, 1 << 38, n)], dtype=object)
    got = rns.polymul(a, b)
    want = _schoolbook_cyclic_int(a, b, n)
    assert np.array_equal(got, want)  # exact integers, no modulus


def test_rns_negacyclic_signed_exact(rng):
    """Negacyclic products have genuinely negative coefficients; the
    centered lift must return exact signed integers (code-review finding:
    X^3 * X^3 = -X^2 mod X^4+1 must give -1, not M-1)."""
    log_n = 4
    n = 1 << log_n
    rns = RNSPolymul(log_n, negacyclic=True)
    a = np.array([int(x) for x in rng.integers(0, 1 << 20, n)], dtype=object)
    b = np.array([int(x) for x in rng.integers(0, 1 << 20, n)], dtype=object)
    got = rns.polymul(a, b)
    want = _schoolbook_negacyclic_int(a, b, n)
    assert np.array_equal(got, want)  # exact signed, no modulus

    r2 = RNSPolymul(2, negacyclic=True)
    e3 = np.array([0, 0, 0, 1], dtype=object)
    got = r2.polymul(e3, e3)
    assert list(got) == [0, 0, -1, 0]


def test_rns_signed_inputs_exact(rng):
    n = 16
    rns = RNSPolymul(4)
    a = np.array([int(x) for x in rng.integers(-(1 << 30), 1 << 30, n)], dtype=object)
    b = np.array([int(x) for x in rng.integers(-(1 << 30), 1 << 30, n)], dtype=object)
    assert np.array_equal(rns.polymul(a, b), _schoolbook_cyclic_int(a, b, n))


def test_rns_input_validation():
    import pytest

    rns = RNSPolymul(4)
    too_big = np.array([rns.max_input_bound() + 1] + [0] * 15, dtype=object)
    ok = np.zeros(16, dtype=object)
    with pytest.raises(ValueError, match="coefficients"):
        rns.polymul(too_big, ok)
    with pytest.raises(ValueError, match="coprime"):
        from ntt_aie import fields as F

        RNSPolymul(4, (F.P_998244353, F.P_998244353))


def test_rns_modulus_and_basis():
    rns = RNSPolymul(4)
    m = 1
    for f in rns.fields:
        m *= f.p
    assert rns.modulus == m
    # CRT basis property: e_i = 1 mod p_i, 0 mod p_j (j != i)
    for i, f in enumerate(rns.fields):
        for j, g in enumerate(rns.fields):
            assert rns._basis[i] % g.p == (1 if i == j else 0)


def test_rns_distributed_mesh(rng):
    """RNS over the DISTRIBUTED four-step plans (coefficients sharded over
    the virtual mesh): exact big-integer cyclic and negacyclic products."""
    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from ntt_aie.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    log_n = 10
    n = 1 << log_n
    rns = RNSPolymul(log_n, mesh=mesh, overlap_chunks=2)
    bound = rns.max_input_bound()
    a = np.array([int(x) for x in rng.integers(0, bound, n)], dtype=object)
    b = np.array([int(x) for x in rng.integers(0, bound, n)], dtype=object)
    got = rns.polymul(a, b)
    # exact-integer check against the single-chip RNS (itself schoolbook-
    # gated in the tests above) — avoids an O(n^2) object-int schoolbook
    single = RNSPolymul(log_n)
    assert np.array_equal(got, single.polymul(a, b))

    rneg = RNSPolymul(log_n, mesh=mesh, negacyclic=True)
    sneg = RNSPolymul(log_n, negacyclic=True)
    s = np.array([int(x) - bound // 2 for x in rng.integers(0, bound, n)],
                 dtype=object)
    t = np.array([int(x) - bound // 2 for x in rng.integers(0, bound, n)],
                 dtype=object)
    assert np.array_equal(rneg.polymul(s, t), sneg.polymul(s, t))


def test_rns_rejects_wide_primes():
    """A Goldilocks residue would silently wrap in the uint32 staging;
    must be an explicit error pointing at the native limb path."""
    import pytest

    from ntt_aie import fields as F

    with pytest.raises(ValueError, match="2\\^31"):
        RNSPolymul(4, (F.GOLDILOCKS, F.P_998244353))


def test_rns_machine_int_inputs(rng):
    """int64/uint64 inputs take the vectorized encode and give exactly the
    object-array results; floats are rejected."""
    import pytest

    n = 16
    rns = RNSPolymul(4)
    a64 = rng.integers(-(1 << 30), 1 << 30, n)          # int64
    b64 = rng.integers(0, 1 << 31, n).astype(np.uint64)  # uint64
    got = rns.polymul(a64, b64)
    want = rns.polymul(a64.astype(object), b64.astype(object))
    assert np.array_equal(got, want)
    with pytest.raises(TypeError, match="integer"):
        rns.polymul(np.ones(n), np.ones(n))


def test_rns_distributed_dp_batched(rng):
    """RNSPolymul(mesh=2D, dp_axis=...) with batched (B, n) inputs: each
    residue field runs the dp-batched distributed plan (DP over transforms
    composed with coefficient sharding); exact vs the single-chip batched
    RNS. VERDICT r2 next #7 — the production RNS serving shape."""
    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from ntt_aie.parallel.mesh import make_mesh_2d

    mesh = make_mesh_2d(2, 4)
    log_n, B = 10, 4
    n = 1 << log_n
    rns = RNSPolymul(log_n, mesh=mesh, dp_axis="dp",
                     overlap_chunks=2)
    bound = rns.max_input_bound()
    a = np.array([[int(x) for x in rng.integers(-bound, bound, n)]
                  for _ in range(B)], dtype=object)
    b = np.array([[int(x) for x in rng.integers(-bound, bound, n)]
                  for _ in range(B)], dtype=object)
    got = rns.polymul(a, b)
    single = RNSPolymul(log_n)
    want = single.polymul(a, b)
    assert got.shape == (B, n)
    assert np.array_equal(got, want)

    # limb-form output keeps the batch axis
    limbs = np.asarray(rns.polymul_limbs(a, b))
    assert limbs.shape == (B, n, rns.nwords)

    # guard rails: unbatched input with dp_axis, batch without dp_axis
    with pytest.raises(ValueError, match="dp_axis plans take batched"):
        rns.polymul(a[0], b[0])
    flat = RNSPolymul(log_n, mesh=make_mesh_2d(2, 4))
    with pytest.raises(ValueError, match="needs dp_axis"):
        flat.polymul(a, b)
