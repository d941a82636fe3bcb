"""RNS (residue number system) polynomial multiplication.

Exact convolution of polynomials with coefficients far beyond any single
word prime: pick pairwise-coprime NTT primes p_1..p_k, run the device
polymul independently in each residue field (a batched fan-out — one more
batch axis to the same kernels), and CRT-reconstruct mod M = prod(p_i).
The result is the exact integer convolution whenever every output
coefficient is < M (for inputs bounded by B: n * B^2 < M).

The reference has nothing like this (single prime, p = 3329); it is the
standard production deployment of NTT polymul (big-integer multiplication,
RNS-form homomorphic encryption), so the framework ships it as a
first-class API.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ntt_aie import fields as F
from ntt_aie.config import NTTConfig

DEFAULT_FIELDS = (F.P_2013265921, F.P_998244353, F.P_469762049)


class RNSPolymul:
    """Exact polynomial multiplication over Z via multi-prime NTTs + CRT.

    Usage:
        rns = RNSPolymul(log_n=12)            # M ~ 2^91: inputs up to ~2^39
        c = rns.polymul(a, b)                 # object-int coefficients
    """

    def __init__(self, log_n: int, prime_fields: Sequence = DEFAULT_FIELDS,
                 *, negacyclic: bool = False, engine: str = "auto",
                 rows_log2: int | None = None,
                 mesh=None, overlap_chunks: int = 1,
                 dp_axis: str | None = None):
        """mesh: a jax.sharding.Mesh runs every residue field's polymul on
        the DISTRIBUTED four-step plan (coefficients sharded over the mesh
        axis 'x') — exact big-integer convolution at pod scale; the k
        residue products still dispatch concurrently. overlap_chunks is
        forwarded to the distributed plans (chunked transpose overlap).
        dp_axis: name of a 2D mesh's data-parallel axis — batched (B, n)
        inputs then shard transforms over dp_axis composed with
        coefficient sharding within each transform (the production RNS
        serving shape)."""
        import math

        from ntt_aie.plan import build_plan

        self.log_n = log_n
        self.n = 1 << log_n
        self.fields = tuple(prime_fields)
        for f in self.fields:
            if f.p >= (1 << 31):
                # residues are staged through uint32 device arrays; a wide
                # prime (Goldilocks) would silently wrap. Wide-coefficient
                # workloads either use more word primes here or the native
                # limb path directly (DESIGN.md §5 decision rule).
                raise ValueError(
                    f"RNS residue primes must be < 2^31 (got {f.p}); use "
                    "additional word primes, or goldilocks_plan for native "
                    "mod-p_gl arithmetic")
        for i, f in enumerate(self.fields):
            for g in self.fields[i + 1 :]:
                if math.gcd(f.p, g.p) != 1:
                    raise ValueError(
                        f"RNS primes must be pairwise coprime; got {f.p} "
                        f"and {g.p} (duplicate/shared factor would make the "
                        "CRT basis degenerate)"
                    )
        self.negacyclic = negacyclic
        self.mesh = mesh
        self.dp_axis = dp_axis
        if mesh is None and dp_axis is not None:
            raise ValueError("dp_axis requires mesh= (a 2D dp x coeff mesh)")
        if mesh is None:
            # rows_log2 forwards to the per-prime configs (spectral order
            # is internal here: RNS only consumes polymul outputs, which
            # are order-agnostic coefficients either way)
            cfg_kw = {} if rows_log2 is None else {"rows_log2": rows_log2}
            self.plans = [
                build_plan(
                    NTTConfig(field=f, log_n=log_n, negacyclic=negacyclic,
                              **cfg_kw),
                    engine=engine,
                )
                for f in self.fields
            ]
        else:
            from ntt_aie.parallel.fourstep import build_distributed_plan

            D = mesh.shape["x"]
            rows_log2 = max(log_n // 2, D.bit_length() - 1)
            self.plans = [
                build_distributed_plan(
                    NTTConfig(field=f, log_n=log_n, negacyclic=negacyclic,
                              num_shards=D, rows_log2=rows_log2),
                    mesh, overlap_chunks=overlap_chunks,
                    dp_axis=dp_axis,
                )
                for f in self.fields
            ]
        self.modulus = 1
        for f in self.fields:
            self.modulus *= f.p
        # CRT basis: e_i = M_i * (M_i^-1 mod p_i), M_i = M / p_i
        # (host-combine fallback for primes the device chain can't take)
        self._basis = []
        for f in self.fields:
            mi = self.modulus // f.p
            self._basis.append(mi * f.inv(mi % f.p))
        # Device-side combine (Garner limb recomposition, ops/crt.py):
        # one jitted elementwise dispatch + ONE limb-array readback instead
        # of k residue readbacks + O(n*k) host object math.
        if all(f.p % 2 == 1 and f.p < (1 << 31) for f in self.fields):
            from ntt_aie.ops.crt import make_crt_combine

            self._combine, self.nwords = make_crt_combine(self.fields)
        else:
            self._combine, self.nwords = None, None

    def max_input_bound(self) -> int:
        """Largest allowed |coefficient| for exact signed results: outputs
        span (-n*B^2, n*B^2], which the centered lift recovers exactly when
        2 * n * B^2 < M."""
        import math

        return math.isqrt((self.modulus - 1) // (2 * self.n)) - 1

    def _residues(self, a) -> list[np.ndarray]:
        a = np.asarray(a)
        if a.dtype != object and a.dtype.kind not in "iu":
            # floats/bools would silently truncate; ints only
            raise TypeError(f"integer coefficients required, got {a.dtype}")
        bound = self.max_input_bound()
        if not (a.shape == (self.n,)
                or (a.ndim == 2 and a.shape[1] == self.n)):
            raise ValueError(
                f"expected shape ({self.n},) or (B, {self.n}), got {a.shape}")
        lo, hi = int(a.min()), int(a.max())
        if lo < -bound or hi > bound:
            raise ValueError(
                f"coefficients must satisfy |c| <= {bound} for exact "
                f"results (got range [{lo}, {hi}]); use more/larger primes"
            )
        # machine-int inputs take the vectorized numpy modulo (object math
        # only when coefficients genuinely exceed the word range); numpy %
        # returns nonnegative remainders for signed inputs, as needed
        return [(a % f.p).astype(np.uint32) for f in self.fields]

    def _residue_products(self, a, b) -> tuple[list, bool]:
        """Dispatch every prime's polymul before fetching any result:
        JAX dispatch is async, so the k independent transforms overlap.
        Inputs may carry a leading batch dim (single-chip plans route to
        the batched kernel builders; see Plan.make_batched). Returns the
        pending products: flat on a single device, (n1, n2) matrices (or
        (B, n1, n2) dp-batched) on a mesh."""
        import jax.numpy as jnp

        ra_all, rb_all = self._residues(a), self._residues(b)
        batch = ra_all[0].shape[0] if ra_all[0].ndim == 2 else None
        key = "negacyclic_polymul" if self.negacyclic else "polymul"
        pending = []
        for plan, ra, rb in zip(self.plans, ra_all, rb_all):
            if self.mesh is not None:
                if batch is not None and self.dp_axis is None:
                    raise ValueError(
                        "batched RNS polymul over a mesh needs dp_axis= "
                        "(a 2D dp x coeff mesh); with a 1D mesh pass one "
                        "(n,) vector per call")
                if batch is None and self.dp_axis is not None:
                    raise ValueError(
                        "dp_axis plans take batched (B, n) inputs with B "
                        "divisible by the dp axis size; pass a batch or "
                        "drop dp_axis for single-vector calls")
                fn = plan.negacyclic_polymul if self.negacyclic else plan.polymul
                pending.append(fn(plan.shard_input(ra), plan.shard_input(rb)))
            elif batch is not None:
                fn = plan.make_batched(batch)[key]
                pending.append(fn(jnp.asarray(ra), jnp.asarray(rb)))
            else:
                fn = (plan.negacyclic_polymul if self.negacyclic
                      else plan.polymul)
                pending.append(fn(jnp.asarray(ra), jnp.asarray(rb)))
        return pending

    def polymul_limbs(self, a, b):
        """Exact product with the CRT combine ON DEVICE: returns an
        (n, nwords) — or (B, n, nwords) for batched (B, n) inputs,
        single-chip — uint32 device array: little-endian limbs of the
        centered representative in (-M/2, M/2], two's-complement encoded
        (ops/crt.py). The k residue transforms AND the Garner
        recomposition run without any host round trip; consumers that
        want Python ints apply `ops.crt.limbs_to_int` (what `polymul`
        does), consumers that keep multi-word form (bignum pipelines)
        read the limbs directly."""
        if self._combine is None:
            raise ValueError(
                "device CRT combine needs odd primes < 2^31; this prime "
                "set falls back to host combine (use polymul())")
        pending = self._residue_products(a, b)
        out = self._combine(*pending)  # elementwise: any residue shape
        if self.mesh is not None:
            # distributed (n1, n2) / dp-batched (B, n1, n2) products:
            # flatten each transform once on the combined output (row-major
            # flattening of the natural-layout product IS the flat vector)
            if out.ndim == 4:
                out = out.reshape(out.shape[0], self.n, self.nwords)
            else:
                out = out.reshape(self.n, self.nwords)
        return out

    def polymul(self, a, b) -> np.ndarray:
        """Exact cyclic (or negacyclic) product of signed-integer-coefficient
        polynomials; inputs must be ints with |c| <= max_input_bound().
        Output coefficients are exact signed integers (centered lift)."""
        if self._combine is not None:
            from ntt_aie.ops.crt import limbs_to_int

            return limbs_to_int(np.asarray(self.polymul_limbs(a, b)))
        pending = self._residue_products(a, b)
        res = [np.asarray(r) for r in pending]
        if self.mesh is not None:
            res = [r.reshape(self.n) if r.ndim == 2
                   else r.reshape(r.shape[0], self.n) for r in res]
        # CRT: c = sum_i r_i * e_i mod M (object math, exact)
        acc = np.zeros(res[0].shape, dtype=object)
        for r, e in zip(res, self._basis):
            acc += r.astype(object) * e
        acc %= self.modulus
        # centered lift (-M/2, M/2]: negacyclic products (and any signed
        # inputs) have genuinely negative coefficients
        half = self.modulus >> 1
        return np.where(acc > half, acc - self.modulus, acc)
