"""Device modular arithmetic vs native scalar models: bit-exact, exhaustive
edge cases + randomized sweeps (jit-compiled; runs on the CPU backend here,
integer semantics are identical on the GPU)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ntt_aie import fields as F
from ntt_aie.ops import modops as M

GL_P = F.GOLDILOCKS.p


def rand_u32(rng, n, lo=0, hi=2**32):
    return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)


def test_umulhi32_and_wide(rng):
    a = rand_u32(rng, 4096)
    b = rand_u32(rng, 4096)
    # force edge values
    a[:8] = [0, 1, 0xFFFFFFFF, 0xFFFF, 0x10000, 0xFFFF0000, 0x80000000, 2]
    b[:8] = [0, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFF, 0x10000, 0xFFFF0000, 2, 0x80000000]
    hi, lo = jax.jit(M.umul32_wide)(jnp.asarray(a), jnp.asarray(b))
    wide = a.astype(np.uint64) * b.astype(np.uint64)
    assert np.array_equal(np.asarray(hi), (wide >> 32).astype(np.uint32))
    assert np.array_equal(np.asarray(lo), (wide & 0xFFFFFFFF).astype(np.uint32))


@pytest.mark.parametrize("field", [F.KYBER, F.DILITHIUM, F.P_998244353, F.P_2013265921])
def test_add_sub_mod(field, rng):
    p = field.p
    a = rng.integers(0, p, 4096).astype(np.uint32)
    b = rng.integers(0, p, 4096).astype(np.uint32)
    a[:4] = [0, p - 1, p - 1, 0]
    b[:4] = [0, p - 1, 0, p - 1]
    s = jax.jit(lambda x, y: M.add_mod(x, y, p))(jnp.asarray(a), jnp.asarray(b))
    d = jax.jit(lambda x, y: M.sub_mod(x, y, p))(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(np.asarray(s), (a.astype(np.uint64) + b) % p)
    assert np.array_equal(
        np.asarray(d), (a.astype(np.int64) - b.astype(np.int64)) % p
    )


def test_barrett_mul_matches_native(rng):
    native = pytest.importorskip("ntt_aie.native_oracle")
    try:
        native.load()
    except native.NativeOracleUnavailable:
        pytest.skip("no native toolchain")
    f = F.KYBER
    a = rng.integers(0, f.p, 2048).astype(np.uint32)
    b = rng.integers(0, f.p, 2048).astype(np.uint32)
    got = np.asarray(
        jax.jit(lambda x, y: M.barrett_mul(x, y, f.p, f.barrett_w, f.barrett_u))(
            jnp.asarray(a), jnp.asarray(b)
        )
    )
    want = a.astype(np.uint64) * b % f.p
    assert np.array_equal(got, want)
    # scalar spot-check against the native model itself
    for i in range(32):
        assert got[i] == native.barrett_mulmod(
            int(a[i]), int(b[i]), f.p, f.barrett_w, f.barrett_u
        )


@pytest.mark.parametrize("field", [F.DILITHIUM, F.P_998244353, F.P_2013265921])
def test_mont_mul(field, rng):
    p = field.p
    neg_pinv = field.mont_neg_pinv
    rinv = pow(field.mont_r, -1, p)
    a = rng.integers(0, p, 4096).astype(np.uint32)
    b = rng.integers(0, p, 4096).astype(np.uint32)
    a[:4] = [0, p - 1, 1, p - 1]
    b[:4] = [0, p - 1, p - 1, 1]
    got = np.asarray(
        jax.jit(lambda x, y: M.mont_mul(x, y, p, neg_pinv))(
            jnp.asarray(a), jnp.asarray(b)
        )
    )
    want = (a.astype(object) * b.astype(object) * rinv) % p
    assert np.array_equal(got.astype(object), want)


def test_mont_form_twiddle_trick(rng):
    """mont_mul(standard a, w*R mod p) == a*w mod p — the form used on device."""
    f = F.P_2013265921
    p = f.p
    a = rng.integers(0, p, 1024).astype(np.uint32)
    w = rng.integers(0, p, 1024).astype(np.uint32)
    w_mont = (w.astype(np.uint64) * f.mont_r_mod_p % p).astype(np.uint32)
    got = np.asarray(M.mont_mul(jnp.asarray(a), jnp.asarray(w_mont), p, f.mont_neg_pinv))
    assert np.array_equal(got, a.astype(np.uint64) * w % p)


# ---- Goldilocks ----

def _gl_rand(rng, n):
    v = rng.integers(0, GL_P, n, dtype=np.uint64)
    return v


def _edges():
    return np.array(
        [0, 1, 2, 0xFFFFFFFF, 0x100000000, GL_P - 1, GL_P - 2,
         0xFFFFFFFE00000002, 2**63, 2**63 - 1],
        dtype=np.uint64,
    ) % np.uint64(GL_P)


def test_gl_add_sub(rng):
    a = np.concatenate([_edges(), _gl_rand(rng, 4096)])
    b = np.concatenate([np.flip(_edges()), _gl_rand(rng, 4096)])
    ah, al = M.gl_from_u64(a)
    bh, bl = M.gl_from_u64(b)
    sh, sl = jax.jit(M.gl_add)(ah, al, bh, bl)
    dh, dl = jax.jit(M.gl_sub)(ah, al, bh, bl)
    got_s = M.gl_to_u64(sh, sl).astype(object)
    got_d = M.gl_to_u64(dh, dl).astype(object)
    want_s = (a.astype(object) + b.astype(object)) % GL_P
    want_d = (a.astype(object) - b.astype(object)) % GL_P
    assert np.array_equal(got_s, want_s)
    assert np.array_equal(got_d, want_d)


def test_gl_mul(rng):
    a = np.concatenate([_edges(), _gl_rand(rng, 8192)])
    b = np.concatenate([np.flip(_edges()), _gl_rand(rng, 8192)])
    ah, al = M.gl_from_u64(a)
    bh, bl = M.gl_from_u64(b)
    rh, rl = jax.jit(M.gl_mul)(ah, al, bh, bl)
    got = M.gl_to_u64(rh, rl).astype(object)
    want = (a.astype(object) * b.astype(object)) % GL_P
    assert np.array_equal(got, want)


def test_gl_mul_matches_native(rng):
    native = pytest.importorskip("ntt_aie.native_oracle")
    try:
        native.load()
    except native.NativeOracleUnavailable:
        pytest.skip("no native toolchain")
    a = _gl_rand(rng, 64)
    b = _gl_rand(rng, 64)
    ah, al = M.gl_from_u64(a)
    bh, bl = M.gl_from_u64(b)
    rh, rl = M.gl_mul(ah, al, bh, bl)
    got = M.gl_to_u64(rh, rl)
    for i in range(64):
        assert int(got[i]) == native.goldilocks_mulmod(int(a[i]), int(b[i]))


def test_gl_mul_karatsuba_matches_schoolbook(rng):
    """3-partial Karatsuba limb product == 4-partial schoolbook == object
    ints, over randoms and edge values."""
    a = np.concatenate([_edges(), _gl_rand(rng, 8192)])
    b = np.concatenate([np.flip(_edges()), _gl_rand(rng, 8192)])
    ah, al = M.gl_from_u64(a)
    bh, bl = M.gl_from_u64(b)
    kh, kl = jax.jit(M.gl_mul_kara)(ah, al, bh, bl)
    sh, sl = jax.jit(M.gl_mul)(ah, al, bh, bl)
    assert np.array_equal(np.asarray(kh), np.asarray(sh))
    assert np.array_equal(np.asarray(kl), np.asarray(sl))
    want = (a.astype(object) * b.astype(object)) % GL_P
    assert np.array_equal(M.gl_to_u64(kh, kl).astype(object), want)


def test_harvey4_mul_data_lazy_domain_bound(rng):
    """harvey4 mul_data's single-operand one-fold REDC bound: canonical
    products from any inputs in the full [0, 4p) travel domain, including
    the extremes (VERDICT r2 weak #6 / next #8). Bound: x folded once to
    [0, 2p), y untouched in [0, 4p) -> x*y < 8p^2 < p*2^32 for p < 2^29."""
    from ntt_aie.ops.reductions import make_reduction

    field = F.P_469762049
    p = field.p
    assert p < (1 << 29)
    red = make_reduction("harvey4", field)
    edges = np.array([0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p, 2 * p + 1,
                      3 * p - 1, 3 * p, 4 * p - 1], dtype=np.uint64)
    xs = np.concatenate([edges, rng.integers(0, 4 * p, 4096)]).astype(np.uint64)
    ys = np.concatenate([np.flip(edges), rng.integers(0, 4 * p, 4096)]).astype(np.uint64)
    # all-pairs over the edge block, elementwise over the random tail
    ex, ey = np.meshgrid(edges, edges)
    xs = np.concatenate([ex.ravel(), xs])
    ys = np.concatenate([ey.ravel(), ys])
    got = np.asarray(jax.jit(red.mul_data)(
        jnp.asarray(xs, jnp.uint32), jnp.asarray(ys, jnp.uint32)))
    want = (xs.astype(object) * ys.astype(object)) % p
    assert np.array_equal(got.astype(object), want)
    assert got.max() < p  # canonical output
