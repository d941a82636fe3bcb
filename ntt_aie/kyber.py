"""ML-KEM (FIPS 203 / Kyber) native NTT over Z_3329[X]/(X^256 + 1).

The reference runs the Kyber prime through a generic 2048-point butterfly
network that is not the Kyber transform at all (SURVEY.md §0: its table
isn't even a root of unity at n=2048). This module implements the REAL
ML-KEM arithmetic, batched on device:

- ``kyber_ntt``  — the 7-layer incomplete NTT (zeta = 17, layers len =
  128..2, zetas in BitRev7 order; FIPS 203 Algorithm 9),
- ``kyber_intt`` — its inverse with the 1/128 scale (Algorithm 10),
- ``kyber_basemul`` — MultiplyNTTs: 128 products of degree-1 polynomials
  mod (X^2 - zeta^(2*BitRev7(i)+1)) (Algorithms 11-12),
- ``kyber_polymul`` — intt(basemul(ntt(a), ntt(b))): the negacyclic
  product in the ML-KEM ring,
- ``kyber_matvec`` — NTT-domain module-lattice A*s (the K-PKE shape).

Layer structure and layout are shared with dilithium.py via
ring_layers.py: coefficients ride the row axis, the batch rides lanes
— (256, B) matrices through the same Barrett mask/select arithmetic as
the reference's kernels (ops/modops.barrett_mul, p = 3329 fits its
bounds). All functions accept (..., 256) uint32 arrays, batched or single.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ntt_aie import fields as F
from ntt_aie import ring_layers as RL
from ntt_aie.ops import modops as M
from ntt_aie.twiddles import bit_reverse_indices

Q = 3329
ZETA = 17
N = 256
_W, _U = F.KYBER.barrett_w, F.KYBER.barrett_u  # Barrett constants for 3329

_ZETAS = RL.layer_zeta_tables(ZETA, Q, 7, 7)
_IZETAS = RL.layer_zeta_tables(ZETA, Q, 7, 7, inverse=True)
_REV7 = bit_reverse_indices(128)
_GAMMAS = np.array(
    [F.modpow(ZETA, 2 * int(_REV7[i]) + 1, Q) for i in range(128)],
    dtype=np.uint32,
)
_N_INV = F.modpow(128, Q - 2, Q)  # 3303


def _mul(a, b):
    return M.barrett_mul(a, b, Q, _W, _U)


def kyber_ntt(f):
    """FIPS 203 Algorithm 9 over the last axis (length 256)."""
    x, restore = RL.as_cols(f, N)
    return restore(RL.layered_fwd(x, _ZETAS, _mul, Q))


def kyber_intt(fhat):
    """FIPS 203 Algorithm 10 (inverse layers in reverse, GS butterflies,
    final 1/128 scale)."""
    x, restore = RL.as_cols(fhat, N)
    x = RL.layered_inv(x, _IZETAS, _mul, Q)
    x = _mul(x, jnp.full((1, 1), np.uint32(_N_INV), dtype=jnp.uint32))
    return restore(x)


def kyber_basemul(ahat, bhat):
    """MultiplyNTTs (FIPS 203 Algorithms 11-12): pairwise products of
    degree-1 polynomials mod (X^2 - gamma_i)."""
    a = jnp.asarray(ahat, dtype=jnp.uint32)
    b = jnp.asarray(bhat, dtype=jnp.uint32)
    shape = a.shape
    a2 = a.reshape(-1, 128, 2)
    b2 = b.reshape(-1, 128, 2)
    a0, a1 = a2[..., 0], a2[..., 1]
    b0, b1 = b2[..., 0], b2[..., 1]
    g = jnp.asarray(_GAMMAS).reshape(1, 128)
    c0 = M.add_mod(_mul(a0, b0), _mul(_mul(a1, b1), g), Q)
    c1 = M.add_mod(_mul(a0, b1), _mul(a1, b0), Q)
    return jnp.stack([c0, c1], axis=-1).reshape(shape)


def kyber_polymul(a, b):
    """a * b in Z_3329[X]/(X^256 + 1) via the ML-KEM pipeline."""
    return kyber_intt(kyber_basemul(kyber_ntt(a), kyber_ntt(b)))


def make_pipeline():
    """Jitted ML-KEM pipeline bundle (ring_layers.jit_pipeline): THE
    documented way to run these functions hot. The bare kyber_* functions
    are traceable building blocks that dispatch eagerly, one op at a
    time. Shapes follow the
    module functions; e.g. the ML-KEM-768 serving step is
    make_pipeline()["make_serving_step"](A_hat) with A_hat (k=3, l=3, 256)
    applied to (B, 3, 256) batches."""
    return RL.jit_pipeline(kyber_ntt, kyber_intt, kyber_matvec,
                           kyber_polymul, kyber_basemul)


def kyber_matvec(ahat, shat):
    """Module-lattice matrix-vector product in the NTT domain: the ML-KEM
    serving primitive (K-PKE encrypt/decrypt, FIPS 203 Algorithms 14-15,
    t = A*s + e shapes). ``ahat``: (..., k, l, 256), ``shat``: (..., l,
    256), both NTT-domain; returns (..., k, 256) = sum_j ahat[..., i, j,
    :] o shat[..., j, :]. Either side may carry extra batch dims (shared
    per-key A against a batch of vectors, or batched A). k, l are small
    (2..4) so the sum is an unrolled add_mod chain; the 256-point basemuls
    stay batched on lanes."""
    a = jnp.asarray(ahat, dtype=jnp.uint32)
    s = jnp.asarray(shat, dtype=jnp.uint32)
    return RL.matvec_terms(a, s, kyber_basemul,
                           lambda u, v: M.add_mod(u, v, Q))
