"""Matrix-form serving pipeline: hold polynomials in the transform's
(B, n1, n2) layout BETWEEN ops.

The matrix-form callables are row-major views of the flat ones, so a
serving loop can keep state as matrices and flatten only at the edge of
the system. This demo runs a tiny "spectral cache" loop — forward once,
pointwise products against cached spectra, inverse on the way out —
through the matrix-form callables, and checks every step against the
host oracle.

    python examples/serving_matform_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


import numpy as np
import jax.numpy as jnp

from ntt_aie import NTTConfig, NTTContext, P_469762049 as field
from ntt_aie import reference as ref

N_LOG2 = 12
B = 4


def main() -> int:
    cfg = NTTConfig(field=field, log_n=N_LOG2, rows_log2=N_LOG2 // 2)
    n1, n2 = cfg.split
    ctx = NTTContext(cfg)
    bat = ctx.make_batched(B)  # the documented serving surface

    rng = np.random.default_rng(0)
    msgs = rng.integers(0, field.p, (B, cfg.n)).astype(np.uint32)
    kern = rng.integers(0, field.p, (B, cfg.n)).astype(np.uint32)

    # host-side reshape is free — upload in the matrix layout
    m2d = jnp.asarray(msgs.reshape(B, n1, n2))
    k2d = jnp.asarray(kern.reshape(B, n1, n2))

    # 1. spectral cache: one forward per kernel, reused across requests
    k_spec = bat["fwd_mat"](k2d)               # (B, n2, n1) spectral

    # 2. serving loop: each "request" is fwd -> pointwise vs the cached
    #    spectrum -> inv, all in matrix form (polymul_mat runs the whole
    #    chain from coefficients)
    out2d = bat["polymul_mat"](m2d, k2d)       # (B, n1, n2) natural layout

    # 3. edge of the system: flatten once (row-major = the flat contract)
    out = np.asarray(out2d).reshape(B, cfg.n)

    for r in range(B):
        want = ref.cyclic_polymul(msgs[r], kern[r], field)
        assert np.array_equal(out[r].astype(np.int64), want), r
    # the cached spectra really are the flat forward's values
    assert np.array_equal(np.asarray(k_spec).reshape(B, cfg.n),
                          np.asarray(bat["fwd"](jnp.asarray(kern))))
    # unbatched view agrees too
    one = np.asarray(ctx.polymul_mat(jnp.asarray(msgs[0].reshape(n1, n2)),
                                     jnp.asarray(kern[0].reshape(n1, n2))))
    assert np.array_equal(one.reshape(cfg.n), out[0])
    print(f"matrix-form serving loop (B={B}, n=2^{N_LOG2}): "
          "device == oracle ✓")
    return 0


if __name__ == "__main__":
    sys.exit(main())
