"""Device-side CRT combine (ops/crt.py): Garner limb recomposition.

Every test gates the uint32-lane device path against exact host object
math — the same bit-exactness contract as the NTT kernels."""

import numpy as np
import pytest

from ntt_aie import fields as F
from ntt_aie.ops.crt import limbs_to_int, make_crt_combine

FIELD_SETS = [
    (F.P_998244353, F.P_2013265921),
    (F.P_2013265921, F.P_998244353, F.P_469762049),  # DEFAULT_FIELDS order
    (F.KYBER, F.DILITHIUM, F.P_469762049, F.P_998244353, F.P_2013265921),
]


def _host_crt(residues, fields, centered):
    m = 1
    for f in fields:
        m *= f.p
    acc = np.zeros(residues[0].shape, dtype=object)
    for r, f in zip(residues, fields):
        mi = m // f.p
        e = mi * f.inv(mi % f.p)
        acc += r.astype(object) * e
    acc %= m
    if centered:
        half = m >> 1
        acc = np.where(acc > half, acc - m, acc)
    return acc


@pytest.mark.parametrize("fields", FIELD_SETS)
@pytest.mark.parametrize("centered", [True, False])
def test_combine_matches_host_crt(rng, fields, centered):
    fn, nwords = make_crt_combine(fields, centered=centered)
    n = 257  # odd length: exercises non-lane-aligned shapes
    residues = [rng.integers(0, f.p, n).astype(np.uint32) for f in fields]
    got = limbs_to_int(np.asarray(fn(*residues)), signed=centered)
    want = _host_crt(residues, fields, centered)
    assert np.array_equal(got, want)


def test_combine_order_independent(rng):
    """The Garner chain internally re-sorts primes ascending; the public
    argument order must stay the caller's `fields` order."""
    fields = (F.P_2013265921, F.P_469762049, F.P_998244353)
    fn, _ = make_crt_combine(fields)
    n = 64
    residues = [rng.integers(0, f.p, n).astype(np.uint32) for f in fields]
    got = limbs_to_int(np.asarray(fn(*residues)))
    assert np.array_equal(got, _host_crt(residues, fields, True))


def test_combine_boundary_values():
    """x = 0, x = M-1 (-> -1 centered), x = M//2 (stays positive),
    x = M//2 + 1 (first negative centered value)."""
    fields = (F.P_998244353, F.P_2013265921, F.P_469762049)
    m = 1
    for f in fields:
        m *= f.p
    fn, nwords = make_crt_combine(fields)
    xs = [0, m - 1, m >> 1, (m >> 1) + 1, 1, m - 2]
    residues = [
        np.array([x % f.p for x in xs], dtype=np.uint32) for f in fields
    ]
    got = limbs_to_int(np.asarray(fn(*residues)))
    want = [x - m if x > (m >> 1) else x for x in xs]
    assert list(got) == want
    # uncentered mode returns the [0, M) representative exactly
    fnu, _ = make_crt_combine(fields, centered=False)
    gotu = limbs_to_int(np.asarray(fnu(*residues)), signed=False)
    assert list(gotu) == xs


def test_combine_rejects_wide_primes():
    with pytest.raises(ValueError, match="odd primes"):
        make_crt_combine((F.GOLDILOCKS, F.P_998244353))


def test_rns_limbs_path_matches_object_path(rng):
    """RNSPolymul.polymul_limbs == the host-combine fallback exactly."""
    from ntt_aie.rns import RNSPolymul

    n = 16
    rns = RNSPolymul(4, negacyclic=True)
    assert rns._combine is not None
    a = np.array([int(x) for x in rng.integers(-(1 << 30), 1 << 30, n)],
                 dtype=object)
    b = np.array([int(x) for x in rng.integers(-(1 << 30), 1 << 30, n)],
                 dtype=object)
    got = limbs_to_int(np.asarray(rns.polymul_limbs(a, b)))
    # force the host fallback on the same instance
    combine = rns._combine
    rns._combine = None
    try:
        want = rns.polymul(a, b)
    finally:
        rns._combine = combine
    assert np.array_equal(got, want)


def test_limbs_to_int_sign_extension():
    # top-bit-set limb pattern decodes as negative two's complement
    arr = np.array([[0xFFFFFFFF, 0xFFFFFFFF], [1, 0]], dtype=np.uint32)
    out = limbs_to_int(arr, signed=True)
    assert list(out) == [-1, 1]
    outu = limbs_to_int(arr, signed=False)
    assert list(outu) == [(1 << 64) - 1, 1]


def test_limbs_to_int_empty_limb_axis():
    # L=0 degenerate case: the empty positional sum is zero (object dtype),
    # matching the pre-vectorization loop semantics.
    arr = np.empty((3, 0), dtype=np.uint32)
    out = limbs_to_int(arr, signed=True)
    assert out.shape == (3,) and out.dtype == object
    assert list(out) == [0, 0, 0]


def test_rns_batched_polymul(rng):
    """(B, n) inputs route to the plans' batched kernel builders and the
    elementwise device combine broadcasts over the batch axis."""
    from ntt_aie.rns import RNSPolymul

    n, B = 16, 3
    rns = RNSPolymul(4)
    bound = 1 << 30
    a = np.array([[int(x) for x in rng.integers(-bound, bound, n)]
                  for _ in range(B)], dtype=object)
    b = np.array([[int(x) for x in rng.integers(-bound, bound, n)]
                  for _ in range(B)], dtype=object)
    limbs = np.asarray(rns.polymul_limbs(a, b))
    assert limbs.shape == (B, n, rns.nwords)
    got = rns.polymul(a, b)
    assert got.shape == (B, n)
    for i in range(B):
        assert np.array_equal(got[i], rns.polymul(a[i], b[i])), f"row {i}"

    # batched host-combine fallback agrees too
    combine = rns._combine
    rns._combine = None
    try:
        host = rns.polymul(a, b)
    finally:
        rns._combine = combine
    assert np.array_equal(host, got)

    # mesh + batch without dp_axis is an explicit error (the dp-batched
    # path needs a 2D dp x coeff mesh — see test_distributed's RNS dp test)
    import jax
    import pytest as _pytest

    if len(jax.devices()) >= 8:
        from ntt_aie.parallel.mesh import make_mesh

        rm = RNSPolymul(10, mesh=make_mesh(8), engine="xla")
        ab = np.ones((2, 1 << 10), dtype=object)
        with _pytest.raises(ValueError, match="dp_axis"):
            rm.polymul(ab, ab)


def test_combine_rejects_duplicate_primes():
    with pytest.raises(ValueError, match="coprime"):
        make_crt_combine((F.P_998244353, F.P_998244353))
