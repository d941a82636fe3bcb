"""ML-DSA (FIPS 204 / Dilithium) native NTT over Z_8380417[X]/(X^256 + 1).

Unlike ML-KEM's incomplete transform (kyber.py), ML-DSA's q = 8380417 has
512th roots of unity (zeta = 1753), so its NTT is COMPLETE: 8 layers down
to len = 1, plain coefficient-wise products in the NTT domain, and the
standard's exact BitRev8 zeta ordering (FIPS 204 Algorithms 41-45). The
NTT-domain representation here is bit-compatible with the standard —
signatures/keys that store NTT-domain polynomials interoperate.

Arithmetic: q > 2^14 rules out the Barrett-2k path, so butterflies use
Montgomery REDC (R = 2^32) with zeta tables premultiplied into Montgomery
form — mont_mul(standard_value, zeta*R) = standard_value * zeta
(ops/modops.py, same machinery as the generic Montgomery plans).

Layer structure and layout are shared with kyber.py via ring_layers.py:
coefficients on the row axis, batch on lanes. All functions accept
(..., 256) uint32 arrays, batched or single.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ntt_aie import fields as F
from ntt_aie import ring_layers as RL
from ntt_aie.ops import modops as M

Q = 8380417
ZETA = 1753
N = 256
_FIELD = F.DILITHIUM
_NEG_PINV = _FIELD.mont_neg_pinv
_R2 = _FIELD.mont_r2_mod_p

_ZETAS = RL.layer_zeta_tables(ZETA, Q, 8, 8, post=_FIELD.to_mont)
_IZETAS = RL.layer_zeta_tables(ZETA, Q, 8, 8, inverse=True,
                               post=_FIELD.to_mont)
_N_INV_MONT = np.uint32(_FIELD.to_mont(F.modpow(256, Q - 2, Q)))


def _mulz(a, z):
    """a * zeta for Montgomery-form zeta tables."""
    return M.mont_mul(a, z, Q, _NEG_PINV)


def dilithium_ntt(f):
    """FIPS 204 Algorithm 41 over the last axis (length 256)."""
    x, restore = RL.as_cols(f, N)
    return restore(RL.layered_fwd(x, _ZETAS, _mulz, Q))


def dilithium_intt(fhat):
    """FIPS 204 Algorithm 42 (inverse layers in reverse, 1/256 scale)."""
    x, restore = RL.as_cols(fhat, N)
    x = RL.layered_inv(x, _IZETAS, _mulz, Q)
    x = _mulz(x, jnp.full((1, 1), _N_INV_MONT, dtype=jnp.uint32))
    return restore(x)


def dilithium_pointwise(ahat, bhat):
    """Coefficient-wise product in the NTT domain (FIPS 204 Algorithm 45;
    the complete NTT needs no basemul)."""
    a = jnp.asarray(ahat, dtype=jnp.uint32)
    b = jnp.asarray(bhat, dtype=jnp.uint32)
    ab = M.mont_mul(a, b, Q, _NEG_PINV)          # a*b*R^-1
    return M.mont_mul(ab, np.uint32(_R2), Q, _NEG_PINV)  # fixup -> a*b


def dilithium_polymul(a, b):
    """a * b in Z_8380417[X]/(X^256 + 1) via the ML-DSA pipeline."""
    return dilithium_intt(dilithium_pointwise(dilithium_ntt(a),
                                              dilithium_ntt(b)))


def make_pipeline():
    """Jitted ML-DSA pipeline bundle (ring_layers.jit_pipeline): THE
    documented way to run these functions hot — the bare dilithium_*
    functions dispatch eagerly, one op at a time. The ML-DSA-65 serving step is
    make_pipeline()["make_serving_step"](A_hat) with A_hat (k=6, l=5,
    256) applied to (B, 5, 256) batches."""
    return RL.jit_pipeline(dilithium_ntt, dilithium_intt, dilithium_matvec,
                           dilithium_polymul, dilithium_pointwise)


def dilithium_matvec(ahat, yhat):
    """Module-lattice matrix-vector product in the NTT domain: the ML-DSA
    serving primitive (w = A*y in Sign / verify's A*z, FIPS 204 Algorithms
    7-8). ``ahat``: (..., k, l, 256), ``yhat``: (..., l, 256), NTT-domain;
    returns (..., k, 256) = sum_j ahat[..., i, j, :] * yhat[..., j, :]
    coefficient-wise. The R^-1 factor from raw mont_mul commutes with the
    sum, so terms accumulate unfixed and the R^2 fixup happens once on the
    accumulator (l+1 muls per coefficient instead of 2l)."""
    a = jnp.asarray(ahat, dtype=jnp.uint32)
    y = jnp.asarray(yhat, dtype=jnp.uint32)
    raw = RL.matvec_terms(
        a, y, lambda u, v: M.mont_mul(u, v, Q, _NEG_PINV),
        lambda u, v: M.add_mod(u, v, Q))
    return M.mont_mul(raw, np.uint32(_R2), Q, _NEG_PINV)
