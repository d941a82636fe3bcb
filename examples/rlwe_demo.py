"""Negacyclic polynomial arithmetic in Z_p[X]/(X^n + 1) — the RLWE ring.

Uses the fully fused device pipeline (psi scalings ride the NTT kernels).

    python examples/rlwe_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


import numpy as np
import jax.numpy as jnp

from ntt_aie import NTTConfig, NTTContext, P_469762049 as field
from ntt_aie import reference as ref

N_LOG2 = 10  # ring dimension 1024


def main() -> int:
    cfg = NTTConfig(field=field, log_n=N_LOG2, negacyclic=True)
    ctx = NTTContext(cfg)
    rng = np.random.default_rng(0)
    a = rng.integers(0, field.p, cfg.n)
    s = rng.integers(0, 3, cfg.n)  # small "secret"

    prod = np.asarray(ctx.plan.negacyclic_polymul(
        jnp.asarray(a, dtype=jnp.uint32), jnp.asarray(s, dtype=jnp.uint32)))
    want = ref.negacyclic_polymul(a, s, field)
    assert np.array_equal(prod.astype(np.int64), want)
    print(f"a(X)*s(X) mod (X^{cfg.n}+1, {field.p}): device == oracle ✓")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
