"""Shared layered-NTT machinery for the FIPS 203/204 ring modules.

ML-KEM (kyber.py, 7 layers, Barrett) and ML-DSA (dilithium.py, 8 layers,
Montgomery) run the same CT/GS layer structure over Z_q[X]/(X^256 + 1);
only the layer count, the zeta tables, and the modmul primitive differ.
This module holds the single copy of that structure (the spectral-order
tables were once triplicated across plan builders and diverged — see
CLAUDE.md invariants — so the per-scheme modules stay thin wrappers).

Data layout: coefficients on the row axis, batch on lanes — (n, B)
uint32 matrices, the batch-to-lanes layout from the small-n plans.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ntt_aie import fields as F
from ntt_aie.ops import modops as M
from ntt_aie.twiddles import bit_reverse_indices


def as_cols(f, n: int):
    """(..., n) -> (n, B) uint32 and a restorer for the original shape."""
    f = jnp.asarray(f, dtype=jnp.uint32)
    shape = f.shape
    return f.reshape(-1, n).T, lambda y: y.T.reshape(shape)


def layer_zeta_tables(zeta: int, q: int, n_layers: int, rev_bits: int,
                      inverse: bool = False, post=int) -> list[np.ndarray]:
    """Per-layer per-block zeta vectors. Layer L has 2^L blocks; the
    standards' sequential index k gives block i of layer L the value
    zeta^BitRev(2^L + i) with BitRev over ``rev_bits`` bits (BitRev7 for
    ML-KEM, BitRev8 for ML-DSA). ``post`` maps each scalar into the table
    representation (e.g. Montgomery form)."""
    rev = bit_reverse_indices(1 << rev_bits)
    layers = []
    for L in range(n_layers):
        blocks = 1 << L
        vals = [F.modpow(zeta, int(rev[blocks + i]), q) for i in range(blocks)]
        if inverse:
            vals = [F.modpow(v, q - 2, q) for v in vals]
        layers.append(np.array([post(v) for v in vals], dtype=np.uint32))
    return layers


def layered_fwd(x, layer_zetas, mulz, q: int):
    """CT butterfly layers over (n, B): layer L splits into 2^L blocks of
    half-length (n/2) >> L; (u, v) -> (u + z*v, u - z*v)."""
    n, c = x.shape
    for L, ztab in enumerate(layer_zetas):
        len_ = (n // 2) >> L
        blocks = 1 << L
        xr = x.reshape(blocks, 2, len_, c)
        u, v = xr[:, 0], xr[:, 1]
        z = jnp.asarray(ztab).reshape(blocks, 1, 1)
        t = mulz(v, z)
        x = jnp.stack(
            [M.add_mod(u, t, q), M.sub_mod(u, t, q)], axis=1
        ).reshape(n, c)
    return x


def layered_inv(x, layer_izetas, mulz, q: int):
    """GS butterfly layers in reverse order: (u, v) ->
    (u + v, z^-1 * (u - v)). Caller applies the final 1/n-ish scale."""
    n, c = x.shape
    for L in reversed(range(len(layer_izetas))):
        len_ = (n // 2) >> L
        blocks = 1 << L
        xr = x.reshape(blocks, 2, len_, c)
        u, v = xr[:, 0], xr[:, 1]
        z = jnp.asarray(layer_izetas[L]).reshape(blocks, 1, 1)
        new_u = M.add_mod(u, v, q)
        new_v = mulz(M.sub_mod(u, v, q), z)
        x = jnp.stack([new_u, new_v], axis=1).reshape(n, c)
    return x


def jit_pipeline(ntt, intt, matvec, polymul, pointwise):
    """Jitted serving-pipeline bundle — the plan-builder convention
    (plan.py returns jitted callables; these modules' bare functions are
    plain traceable fns and dispatch ~50 tiny ops per call when run
    eagerly).
    Every recorded throughput number goes through this builder.

    Returns a dict of jitted callables:
      ntt / intt / polymul / pointwise / matvec — the module functions,
        compiled (cached per input shape; any batch shape works).
      serving_step(A, x) — intt(matvec(ntt(A), ntt(x))): the full
        module-lattice product with fresh A per call.
      make_serving_step(A_hat) — closure over a FIXED NTT-domain matrix
        (the serving shape: per-key A reused across a batch of vectors);
        returns a jitted x -> intt(matvec(A_hat, ntt(x))).
    """
    import jax

    def serving_step(A, x):
        return intt(matvec(ntt(A), ntt(x)))

    def make_serving_step(A_hat):
        A_hat = jnp.asarray(A_hat, dtype=jnp.uint32)
        return jax.jit(lambda x: intt(matvec(A_hat, ntt(x))))

    return {
        "ntt": jax.jit(ntt),
        "intt": jax.jit(intt),
        "polymul": jax.jit(polymul),
        "pointwise": jax.jit(pointwise),
        "matvec": jax.jit(matvec),
        "serving_step": jax.jit(serving_step),
        "make_serving_step": make_serving_step,
    }


def matvec_terms(ahat, xhat, pointwise, add_mod_q):
    """sum_j pointwise(ahat[..., :, j, :], xhat[..., j, :]) — the
    module-lattice matvec skeleton. Broadcasts the shared vector against
    the matrix rows (either side may carry extra batch dims)."""
    l = ahat.shape[-2]

    def term(j):
        aj = ahat[..., :, j, :]
        xj = xhat[..., None, j, :]
        shape = jnp.broadcast_shapes(aj.shape, xj.shape)
        return pointwise(jnp.broadcast_to(aj, shape),
                         jnp.broadcast_to(xj, shape))

    acc = term(0)
    for j in range(1, l):
        acc = add_mod_q(acc, term(j))
    return acc
