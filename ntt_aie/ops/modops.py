"""Device-side modular arithmetic in uint32 lanes.

A jnp uint32 multiply yields only the low 32 bits — there is no 64-bit
accumulator like the reference's AIE acc64 (reference src/aie_core.cc:68-73).
SURVEY.md §7 hard part 1: the high product word is reconstructed from 16-bit
limb partial products (each fits uint32 exactly: (2^16-1)^2 < 2^32). On top
of that sit three reduction strategies:

- ``barrett_mul`` — the reference's Barrett "2k" (src/aie_core.cc:27-39):
  all intermediates fit 32 bits for p < 2^14 (Kyber). Single low-mul path.
- ``mont_mul`` — Montgomery REDC with R = 2^32 for odd p < 2^31. Twiddles
  are stored premultiplied by R ("Montgomery form"), so
  mont_mul(standard_data, mont_twiddle) returns standard form directly.
- ``gl_*`` — Goldilocks p = 2^64 - 2^32 + 1 on two uint32 limbs
  (BASELINE.json config 4's "64-bit prime via 32-bit limb decomposition").

The conditional-subtract add/sub mirror the reference's vector mask/select
idiom (src/aie_core.cc:41-62): compute, compare, select — branch-free.

Everything here is pure jnp on uint32 and works identically under jit on
the GPU and on the CPU (used by the 8-virtual-device tests); integer ops
are bit-exact across XLA backends.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

U32 = jnp.uint32  # dtype for casts
# Scalar constants are numpy scalars (not jnp arrays): they fold into the
# jaxpr as literals.
C32 = np.uint32
_MASK16 = np.uint32(0xFFFF)


def _u32(x):
    return jnp.asarray(x, dtype=U32)


# ---------------------------------------------------------------------------
# 32x32 -> 64 multiply from 16-bit limbs
# ---------------------------------------------------------------------------

def umulhi32(a, b):
    """High 32 bits of the 64-bit product of two uint32 arrays.

    Schoolbook over 16-bit halves; every partial product and carry-sum
    provably fits in uint32.
    """
    a = _u32(a)
    b = _u32(b)
    al = a & _MASK16
    ah = a >> 16
    bl = b & _MASK16
    bh = b >> 16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = lh + (ll >> 16)            # <= (2^16-1)^2 + (2^16-1) < 2^32
    mid2 = hl + (mid & _MASK16)      # same bound
    return hh + (mid >> 16) + (mid2 >> 16)


def umul32_wide(a, b):
    """(hi, lo) of the 64-bit product of two uint32 arrays."""
    a = _u32(a)
    b = _u32(b)
    return umulhi32(a, b), a * b


# ---------------------------------------------------------------------------
# add/sub with conditional reduction (the reference's mask/select idiom,
# src/aie_core.cc:41-62)
# ---------------------------------------------------------------------------

def add_mod(a, b, p: int):
    """(a + b) mod p for a, b in [0, p), p < 2^31 (sum fits uint32)."""
    s = _u32(a) + _u32(b)
    return jnp.where(s >= C32(p), s - C32(p), s)


def sub_mod(a, b, p: int):
    """(a - b) mod p for a, b in [0, p)."""
    a = _u32(a)
    b = _u32(b)
    d = a + (C32(p) - b)             # in [0, 2p) — no wrap since 2p < 2^32
    return jnp.where(d >= C32(p), d - C32(p), d)


def neg_mod(a, p: int):
    a = _u32(a)
    return jnp.where(a == 0, a, C32(p) - a)


# ---------------------------------------------------------------------------
# Barrett "2k" (p < 2^14) — reference src/aie_core.cc:27-39 semantics
# ---------------------------------------------------------------------------

def barrett_mul(a, b, p: int, w: int, u: int):
    """a*b mod p via Barrett 2k. Requires p < 2^14 so t = a*b < 2^28 and
    u*x1 < 2^(2w+3) <= 2^31 all fit in uint32. Bit-exact with the native
    scalar model ntt_barrett_mulmod."""
    t = _u32(a) * _u32(b)
    x1 = t >> (w - 2)
    s = (x1 * C32(u)) >> (w + 2)
    c = t - s * C32(p)
    return jnp.where(c >= C32(p), c - C32(p), c)


# ---------------------------------------------------------------------------
# Montgomery REDC, R = 2^32 (odd p < 2^31)
# ---------------------------------------------------------------------------

def mont_redc(hi, lo, p: int, neg_pinv: int):
    """REDC: given T = hi*2^32 + lo with T < p*2^32, return T*R^-1 mod p.

    m = lo * (-p^-1) mod 2^32;  t = (T + m*p) / 2^32. The low word of
    T + m*p is zero by construction, so the division is
    hi + umulhi(m, p) + carry, carry = (lo != 0) — because
    lo + mullo(m, p) is either 0 (lo == 0) or exactly 2^32.
    """
    lo = _u32(lo)
    m = lo * C32(neg_pinv)
    t = _u32(hi) + umulhi32(m, C32(p)) + (lo != 0).astype(U32)
    return jnp.where(t >= C32(p), t - C32(p), t)


def mont_mul(a, b, p: int, neg_pinv: int):
    """a * b * R^-1 mod p. With b a Montgomery-form twiddle (b = w*R mod p)
    this returns a*w mod p for standard-form a."""
    hi, lo = umul32_wide(a, b)
    return mont_redc(hi, lo, p, neg_pinv)


def mont_sqr(a, p: int, neg_pinv: int):
    return mont_mul(a, a, p, neg_pinv)


# ---------------------------------------------------------------------------
# Goldilocks p = 2^64 - 2^32 + 1 on (hi, lo) uint32 limb pairs
# ---------------------------------------------------------------------------

GL_P_HI = 0xFFFFFFFF
GL_P_LO = 0x00000001
_EPS = np.uint32(0xFFFFFFFF)  # 2^32 - 1 = 2^64 mod p


def _ge_p_gl(hi, lo):
    """value >= p for a (hi, lo) pair; p = (0xffffffff, 0x00000001)."""
    return (hi == _EPS) & (lo >= C32(GL_P_LO))


def gl_canonical(hi, lo):
    """Conditional subtract p once (inputs < 2p fold to [0, p))."""
    ge = _ge_p_gl(hi, lo)
    # subtract p = 2^64 - 2^32 + 1: lo' = lo - 1 (borrow), hi' = hi - 0xffffffff - borrow
    blo = lo - C32(GL_P_LO)
    borrow = (lo < C32(GL_P_LO)).astype(U32)
    bhi = hi - _EPS - borrow
    return jnp.where(ge, bhi, hi), jnp.where(ge, blo, lo)


def gl_add(ahi, alo, bhi, blo):
    """(a + b) mod p for a, b in [0, p). Two-limb add; a 2^64 wrap adds
    eps = 2^32 - 1 (cannot re-wrap since wrapped sum < p)."""
    lo = alo + blo
    c = (lo < alo).astype(U32)
    hi_nc = ahi + bhi
    c2 = (hi_nc < ahi).astype(U32)
    hi2 = hi_nc + c
    c3 = (hi2 < hi_nc).astype(U32)
    wrap = (c2 + c3) > 0  # carry out of the high add = crossed 2^64
    lo_w = lo + _EPS
    cw = (lo_w < lo).astype(U32)
    hi_w = hi2 + cw
    hi_f = jnp.where(wrap, hi_w, hi2)
    lo_f = jnp.where(wrap, lo_w, lo)
    return gl_canonical(hi_f, lo_f)


def gl_sub(ahi, alo, bhi, blo):
    """(a - b) mod p for a, b in [0, p)."""
    lo = alo - blo
    borrow = (alo < blo).astype(U32)
    hi = ahi - bhi - borrow
    under = (ahi < bhi) | ((ahi == bhi) & (borrow == 1))
    # underflow: true value gained -2^64 ≡ -(2^32 - 1): subtract eps
    lo_u = lo - _EPS
    bu = (lo < _EPS).astype(U32)
    hi_u = hi - bu
    hi_f = jnp.where(under, hi_u, hi)
    lo_f = jnp.where(under, lo_u, lo)
    return gl_canonical(hi_f, lo_f)


def _add3_with_carry(x, y, z):
    """x + y + z over uint32, returning (sum, carry in {0,1,2})."""
    s1 = x + y
    c1 = (s1 < x).astype(U32)
    s2 = s1 + z
    c2 = (s2 < s1).astype(U32)
    return s2, c1 + c2


def gl_mul(ahi, alo, bhi, blo):
    """(a * b) mod p on limb pairs: 4 wide partial products -> 128-bit
    (r3, r2, r1, r0) -> reduce via 2^64 ≡ eps, 2^96 ≡ -1 (same identity as
    the native ntt_goldilocks_reduce128, kept bit-compatible)."""
    h00, l00 = umul32_wide(alo, blo)
    h01, l01 = umul32_wide(alo, bhi)
    h10, l10 = umul32_wide(ahi, blo)
    h11, l11 = umul32_wide(ahi, bhi)

    r0 = l00
    r1, c1 = _add3_with_carry(h00, l01, l10)
    r2a, c2a = _add3_with_carry(h01, h10, l11)
    r2, c2b = _add3_with_carry(r2a, c1, C32(0))
    r3 = h11 + c2a + c2b  # < 2^32: full product < 2^128
    return _gl_reduce128(r3, r2, r1, r0)


def gl_mul_kara(ahi, alo, bhi, blo):
    """(a * b) mod p via Karatsuba: 3 wide partial products (15 uint32
    muls) instead of gl_mul's 4 (20), paying ~15 extra carry/select
    lane-ops for the middle-term reconstruction
    P1 = (alo+ahi)(blo+bhi) - P0 - P2 (33-bit sums handled with 1-bit
    carry corrections). Bit-exact with gl_mul (fuzz-tested); whether the
    mul-vs-carry trade wins depends on the hardware."""
    p0h, p0l = umul32_wide(alo, blo)
    p2h, p2l = umul32_wide(ahi, bhi)
    sa = alo + ahi
    ca = sa < alo                      # carry bit of the 33-bit sum
    sb = blo + bhi
    cb = sb < blo
    mh, ml = umul32_wide(sa, sb)
    # M = (sa + ca*2^32)(sb + cb*2^32)
    #   = mh:ml + (ca?sb + cb?sa) << 32 + (ca&cb) << 64  — 3 limbs m2:mh:ml
    t1 = jnp.where(ca, _u32(sb), C32(0))
    t2 = jnp.where(cb, _u32(sa), C32(0))
    mh2, cm = _add3_with_carry(mh, t1, t2)
    m2 = (ca & cb).astype(U32) + cm
    # P1 = M - P0 - P2 (>= 0 mathematically; 3-limb borrows)
    def sub3(x2, x1, x0, y1, y0):
        z0 = x0 - y0
        b0 = (x0 < y0).astype(U32)
        z1 = x1 - y1 - b0
        b1 = ((x1 < y1) | ((x1 == y1) & (b0 == 1))).astype(U32)
        return x2 - b1, z1, z0

    q2, q1, q0 = sub3(m2, mh2, ml, p0h, p0l)
    q2, q1, q0 = sub3(q2, q1, q0, p2h, p2l)
    # r = P2 << 64 + P1 << 32 + P0
    r0 = p0l
    r1, c1 = _add3_with_carry(p0h, q0, C32(0))
    r2, c2 = _add3_with_carry(p2l, q1, c1)
    r3 = p2h + q2 + c2
    return _gl_reduce128(r3, r2, r1, r0)


def _gl_reduce128(r3, r2, r1, r0):
    """(r3:r2:r1:r0) mod p via 2^64 ≡ eps, 2^96 ≡ -1; canonical output."""
    # reduce: x ≡ (r1:r0) + r2*eps - r3  (mod p), eps = 2^32 - 1
    # step 1: t = (r1:r0) - r3  (borrow -> add p)
    tlo = r0 - r3
    borrow = (r0 < r3).astype(U32)
    thi = r1 - borrow
    under = (r1 == 0) & (borrow == 1)
    # add p on underflow: (hi, lo) += (0xffffffff, 1)
    plo = tlo + C32(1)
    pc = (plo < tlo).astype(U32)
    phi = thi + _EPS + pc
    thi = jnp.where(under, phi, thi)
    tlo = jnp.where(under, plo, tlo)

    # step 2: u = r2 * eps = (r2 << 32) - r2 = (r2 - (r2 != 0), -r2)
    uhi = r2 - (r2 != 0).astype(U32)
    ulo = C32(0) - r2

    # step 3: s = t + u with 2^64-wrap adding eps
    lo = tlo + ulo
    ca = (lo < tlo).astype(U32)
    hi_nc = thi + uhi
    cb = (hi_nc < thi).astype(U32)
    hi = hi_nc + ca
    cc = (hi < hi_nc).astype(U32)
    wrap = (cb + cc) > 0
    lo_w = lo + _EPS
    cw = (lo_w < lo).astype(U32)
    hi_w = hi + cw
    hi = jnp.where(wrap, hi_w, hi)
    lo = jnp.where(wrap, lo_w, lo)
    return gl_canonical(hi, lo)


def gl_from_u64(x):
    """Split a numpy/python uint64 array-like into (hi, lo) uint32 jnp arrays."""
    import numpy as np

    x = np.asarray(x, dtype=np.uint64)
    return (
        jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


def gl_to_u64(hi, lo):
    import numpy as np

    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo
