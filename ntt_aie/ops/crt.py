"""Device-side CRT recombination for RNS results (uint32 limb output).

The RNS polymul (rns.py) runs one device transform per residue prime; the
reconstruction c = CRT(r_1..r_k) mod M was, until this module, host-side
object math — O(n * k) arbitrary-precision multiplies per call, which made
end-to-end RNS throughput host-bound at large n (DESIGN.md §5). Here the
combine runs on device as pure uint32 lane arithmetic (one jitted
elementwise dispatch, fused by XLA), and the host reads back ONE
(n, L)-limb array instead of k residue arrays.

Algorithm: Garner's mixed-radix conversion. With the prime chain sorted
ascending (p_1 < p_2 < ... < p_k), the digits

    v_1 = r_1
    v_i = (..((r_i - v_1) * inv(p_1) - v_2) * inv(p_2) .. - v_{i-1})
          * inv(p_{i-1})  (mod p_i)

satisfy  x = v_1 + v_2 p_1 + v_3 p_1 p_2 + ... = CRT(r) in [0, M).
Ascending order guarantees v_j < p_j < p_i, so every subtraction is a
plain conditional-subtract `sub_mod` (ops/modops.py) and every multiply
is a Montgomery constant multiply against the precomputed
inv(p_j) * R mod p_i table. The positional sum is then accumulated in
L = ceil(bits(M)/32) uint32 limbs (carry-propagating add of the 64-bit
partial products v_i * P_i, P_i = prod_{j<i} p_j precomputed as limb
words), and the centered lift (x > M/2 -> x - M) is a multi-word
conditional subtract whose wrap-around IS the two's-complement encoding
of the negative value.

The reference has no CRT at all (single prime); this is the multi-word
reconstruction every production RNS deployment needs, built for uint32 lanes:
branch-free where/select lanes (the reference's mask/select idiom,
src/aie_core.cc:41-62, extended to multi-word carries).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ntt_aie.ops import modops as M

U32 = jnp.uint32
C32 = np.uint32


def _to_limbs(x: int, nwords: int) -> list[np.uint32]:
    """Little-endian uint32 limb decomposition of a nonnegative int."""
    out = []
    for _ in range(nwords):
        out.append(C32(x & 0xFFFFFFFF))
        x >>= 32
    if x:
        raise ValueError("value does not fit in the requested limb count")
    return out


def limbs_to_int(limbs: np.ndarray, *, signed: bool = True) -> np.ndarray:
    """Recombine an (..., L) uint32 little-endian limb array into object
    ints. With signed=True the top limb's MSB is the two's-complement sign
    (the encoding `make_crt_combine`'s centered lift produces)."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    L = limbs.shape[-1]
    if L == 0:
        # Degenerate zero-length limb axis: the empty positional sum is 0
        # (matches the pre-vectorization loop; make_crt_combine always
        # produces nwords >= 1, so this is only reachable via direct use).
        return np.zeros(limbs.shape[:-1], dtype=object)
    # pair uint32 limbs into uint64 words with vectorized machine math
    # first: halves the number of object-array passes (measured -25% on
    # the n=2^20 L=3 decode, the host-bound tail of RNSPolymul.polymul)
    l64 = limbs.astype(np.uint64)
    words = [l64[..., i] | (l64[..., i + 1] << np.uint64(32))
             for i in range(0, L - 1, 2)]
    if L % 2:
        words.append(l64[..., L - 1])
    acc = words[-1].astype(object)
    for w in reversed(words[:-1]):
        acc = (acc << 64) + w.astype(object)
    if signed:
        sign_bit = 1 << (32 * L - 1)
        full = 1 << (32 * L)
        acc = np.where(acc >= sign_bit, acc - full, acc)
    return acc


def make_crt_combine(fields: Sequence, *, centered: bool = True):
    """Build a jitted device CRT combine for the given residue fields.

    Returns (fn, nwords): fn maps k equally-shaped uint32 residue arrays
    (canonical, [0, p_i), in the ORDER of `fields`) to one
    (..., nwords) uint32 array — the little-endian limbs of
    CRT(r) in [0, M), or, with centered=True, of the centered
    representative in (-M/2, M/2] encoded two's-complement.

    Requires every prime odd and < 2^31 (Montgomery R = 2^32 chain
    constants; the standard word-size NTT primes all qualify).
    """
    fields = list(fields)
    k = len(fields)
    if k < 1:
        raise ValueError("need at least one residue field")
    for f in fields:
        if f.p % 2 == 0 or f.p >= (1 << 31):
            raise ValueError(
                f"device CRT needs odd primes < 2^31, got {f.p}")
    import math

    for i, f in enumerate(fields):
        for g in fields[i + 1:]:
            if math.gcd(f.p, g.p) != 1:
                raise ValueError(
                    f"CRT moduli must be pairwise coprime; got {f.p} and "
                    f"{g.p} (a shared factor makes the basis degenerate)")
    # Garner chain in ascending-prime order so every digit v_j < p_j is
    # already reduced mod any later (larger) p_i.
    order = sorted(range(k), key=lambda i: fields[i].p)
    chain = [fields[i] for i in order]
    modulus = 1
    for f in chain:
        modulus *= f.p
    nwords = max(1, -(-modulus.bit_length() // 32))

    # inv_const[i][j] = inv(p_j) * R mod p_i (Montgomery form), j < i
    inv_const = []
    neg_pinv = []
    for i, fi in enumerate(chain):
        neg_pinv.append(fi.mont_neg_pinv)
        row = []
        for fj in chain[:i]:
            inv_pj = fi.inv(fj.p % fi.p)
            row.append(C32(fi.to_mont(inv_pj)))
        inv_const.append(row)

    # Positional weights P_i = prod_{j<i} p_j as limb words.
    weights = []
    acc_mod = 1
    for f in chain:
        weights.append(_to_limbs(acc_mod, nwords))
        acc_mod *= f.p
    m_limbs = _to_limbs(modulus, nwords)
    half_limbs = _to_limbs(modulus >> 1, nwords)

    def combine(*residues):
        if len(residues) != k:
            raise ValueError(f"expected {k} residue arrays, got {len(residues)}")
        res = [jnp.asarray(residues[i], dtype=U32) for i in order]
        # Garner digits.
        digits = []
        for i, fi in enumerate(chain):
            t = res[i]
            for j in range(i):
                t = M.sub_mod(t, digits[j], fi.p)
                t = M.mont_mul(t, inv_const[i][j], fi.p, neg_pinv[i])
            digits.append(t)
        # Positional recomposition: acc += v_i * P_i, limbwise with carries.
        zero = jnp.zeros_like(res[0])
        acc = [zero for _ in range(nwords)]
        for v, wlimbs in zip(digits, weights):
            carry = zero
            for t, w in enumerate(wlimbs):
                if int(w) == 0 and t > 0:
                    # still must flush the running carry into this limb
                    s0 = acc[t] + carry
                    carry = (s0 < acc[t]).astype(U32)
                    acc[t] = s0
                    continue
                hi, lo = M.umul32_wide(v, w)
                s0 = acc[t] + lo
                c0 = (s0 < acc[t]).astype(U32)
                s1 = s0 + carry
                c1 = (s1 < s0).astype(U32)
                acc[t] = s1
                # next carry: hi + c0 + c1 (hi <= 2^32-2, sum fits uint32)
                carry = hi + c0 + c1
            # v * P_i + previous acc < M <= 2^(32*nwords): no carry out.
        if centered:
            # x > M/2 ? two's-complement wrap of the multi-word subtract
            # x - M is exactly the signed encoding of the negative lift.
            gt = jnp.zeros_like(res[0], dtype=bool)
            eq = jnp.ones_like(res[0], dtype=bool)
            for t in reversed(range(nwords)):
                h = half_limbs[t]
                gt = gt | (eq & (acc[t] > h))
                eq = eq & (acc[t] == h)
            borrow = zero
            sub = []
            for t in range(nwords):
                mw = m_limbs[t]
                d0 = acc[t] - mw
                b0 = (acc[t] < mw).astype(U32)
                d1 = d0 - borrow
                b1 = (d0 < borrow).astype(U32)
                sub.append(d1)
                borrow = b0 + b1
            acc = [jnp.where(gt, s, a) for s, a in zip(sub, acc)]
        return jnp.stack(acc, axis=-1)

    return jax.jit(combine), nwords
