"""Batched post-quantum-crypto serving: ML-KEM and ML-DSA module-lattice
arithmetic on device.

The serving-side hot loop of both FIPS standards is NTT -> NTT-domain
matrix-vector product -> inverse NTT (K-PKE encrypt computes u = A^T*r,
ML-DSA Sign computes w = A*y). This demo runs a batch of those products
through the device pipeline and cross-checks one lane against the
schoolbook oracle.

    python examples/pqc_serving_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


import numpy as np

from ntt_aie import dilithium as DL
from ntt_aie import kyber as KY
from ntt_aie import reference as ref

BATCH = 64


def _check_one(A, s, got, q, label):
    want = np.zeros(256, dtype=np.int64)
    for j in range(A.shape[1]):
        want = (want + ref.schoolbook_negacyclic(A[0, j], s[j], q)) % q
    assert np.array_equal(got.astype(np.int64), want), label
    print(f"{label}: device == schoolbook oracle ✓")


def main() -> int:
    rng = np.random.default_rng(0)

    # The jitted pipeline builders are the documented hot path: the bare
    # kyber_*/dilithium_* functions dispatch eagerly (one op at a time).
    ky = KY.make_pipeline()
    dl = DL.make_pipeline()

    # --- ML-KEM-512 shape: t = A*s, A in R_q^{2x2}, batch of keygens ---
    k = 2
    A = rng.integers(0, KY.Q, (BATCH, k, k, 256), dtype=np.uint32)
    s = rng.integers(0, KY.Q, (BATCH, k, 256), dtype=np.uint32)
    t = np.asarray(ky["serving_step"](A, s))
    _check_one(A[0], s[0], t[0, 0], KY.Q, f"ML-KEM t=A*s (k={k}, B={BATCH})")

    # --- ML-DSA-65 shape: w = A*y, A in R_q^{6x5}, batch of signatures ---
    kk, ll = 6, 5
    A2 = rng.integers(0, DL.Q, (BATCH, kk, ll, 256), dtype=np.uint32)
    y = rng.integers(0, DL.Q, (BATCH, ll, 256), dtype=np.uint32)
    w = np.asarray(dl["serving_step"](A2, y))
    _check_one(A2[0], y[0], w[0, 0], DL.Q,
               f"ML-DSA w=A*y (k={kk}, l={ll}, B={BATCH})")

    # Fixed-A serving form: one key's NTT-domain matrix reused across
    # vector batches (what a KEM/signing service actually runs).
    A_hat = ky["ntt"](A[0])
    step = ky["make_serving_step"](A_hat)
    t0 = np.asarray(step(s[:8]))
    assert np.array_equal(t0[0], t[0]), "fixed-A serving step mismatch"
    print(f"ML-KEM fixed-A serving step: matches fresh-A pipeline ✓")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
