"""High-level API: NTTContext.

The L3 layer (SURVEY.md §7): where the reference has a C++/XRT host driver
(src/test.cpp:62-248) that loads an xclbin and programs DMA buffer
descriptors, the driver here is a plan object holding jitted
callables — XLA's compiled executable replaces insts.txt, jax.jit dispatch
replaces xrt::kernel(...) (SURVEY.md §2 N11).
"""

from __future__ import annotations

import numpy as np

from ntt_aie.config import NTTConfig
from ntt_aie import reference as ref
from ntt_aie import twiddles as tw


class NTTContext:
    """A compiled NTT plan: forward / inverse / polymul on device.

    Usage:
        ctx = NTTContext(NTTConfig(field=P_2013265921, log_n=20))
        A = ctx.forward(a)           # device NTT
        c = ctx.polymul(a, b)        # fused NTT -> pointwise -> INTT

    With `mesh=` (a jax.sharding.Mesh), the same API runs the distributed
    four-step plan (coefficient sharding + all_to_all transpose) —
    flat host vectors are placed automatically; already-sharded device
    matrices pass through. Extra keyword args (engine single-chip;
    wmat_factored, overlap_chunks, dp_axis, ... on a mesh) forward to the
    plan builder.
    config.ordering is honored in both modes: ordering='natural' with
    mesh= returns/accepts flat natural-order vectors (a cross-shard
    gather rides the output — use the default spectral ordering for
    layout-free serving); the reference parity conventions are
    single-chip only and raise with mesh=.
    """

    def __init__(self, config: NTTConfig, *, mesh=None, **plan_kwargs):
        self.config = config
        self.mesh = mesh
        self._plan_kwargs = plan_kwargs
        if mesh is None and plan_kwargs:
            # Single-chip contexts forward plan.build_plan's own knobs
            # (one entry point, all knobs — the reference's single CLI
            # surface, src/test.cpp:85-92); only genuinely distributed
            # options still require mesh=.
            single = {"engine"}
            bad = sorted(set(plan_kwargs) - single)
            if bad:
                raise TypeError(
                    f"plan kwargs {bad} need mesh= (they configure the "
                    "distributed plan builder); single-chip contexts "
                    f"accept {sorted(single)}"
                )
        if mesh is not None and (config.table_convention == "reference"
                                 or config.ordering == "reference"):
            raise NotImplementedError(
                "the reference parity conventions (table_convention/"
                "ordering='reference') are single-chip modes — the "
                "reference butterfly network is not a DFT and has no "
                "four-step decomposition (SURVEY.md §0); drop mesh="
            )
        if mesh is not None and config.ordering == "natural" and \
                plan_kwargs.get("dp_axis"):
            raise NotImplementedError(
                "ordering='natural' is not wired for dp_axis-batched "
                "meshes (the gather wrapper assumes flat vectors); use "
                "the default spectral ordering"
            )
        # Device plans are built lazily (imports jax only when used, so the
        # pure-NumPy oracle path stays importable anywhere).
        self._fwd = None
        self._inv = None
        self._polymul = None

    # ---- host oracle paths (always available) ----

    def forward_host(self, a) -> np.ndarray:
        """Host-oracle forward transform in the SAME output order as the
        device plan (spectral four-step order for ordering='bitrev' with an
        (n1, n2) split; plain bit reversal on the flat path)."""
        cfg = self.config
        if cfg.table_convention == "reference":
            table = tw.power_table(cfg.field, cfg.n)
            out = ref.reference_network(a, table, cfg.field.p)
            if cfg.ordering == "reference":
                out = ref.block_permute(out)
            return out
        natural = ref.ntt_forward(np.asarray(a), cfg.field)
        if cfg.ordering == "natural":
            return natural
        # device spectral order: flat[pos[k]] = natural[k]
        pos = tw.spectral_positions(*cfg.split)
        out = np.empty_like(natural)
        out[pos] = natural
        return out

    def inverse_host(self, a) -> np.ndarray:
        cfg = self.config
        if cfg.table_convention == "reference":
            raise NotImplementedError(
                "reference table convention has no inverse (not a DFT; "
                "SURVEY.md §0)"
            )
        a = np.asarray(a)
        if cfg.ordering != "natural":
            a = a[tw.spectral_positions(*cfg.split)]  # -> natural order
        # natural-order spectrum -> coefficients: bit-reverse into the DIT
        return ref.ntt_dit(a[tw.bit_reverse_indices(cfg.n)], cfg.field,
                           inverse=True)

    # ---- device paths ----

    def _build(self):
        if self.mesh is not None:
            self._build_distributed()
            return
        from ntt_aie.plan import build_plan

        plan = build_plan(self.config, **self._plan_kwargs)
        self._fwd, self._inv, self._polymul = plan.fwd, plan.inv, plan.polymul
        self._plan = plan

    def _build_distributed(self):
        import jax

        from ntt_aie.parallel.fourstep import build_distributed_plan

        if self.config.field.is_goldilocks:
            # 64-bit values travel as (hi, lo) uint32 limb pairs through a
            # dedicated builder — route there instead of crashing in the
            # single-array machinery.
            self._build_distributed_gl()
            return

        plan = build_distributed_plan(self.config, self.mesh,
                                      **self._plan_kwargs)

        def _placed(x, place):
            # sharded device matrices pass through; flat host vectors (or
            # 1-D device arrays) are placed into the plan layout
            if isinstance(x, jax.Array) and x.ndim >= 2:
                return x
            return place(np.asarray(x))

        self._fwd = lambda a: plan.fwd(_placed(a, plan.shard_input))
        self._inv = lambda s: plan.inv(_placed(s, plan.shard_spectral))
        self._polymul = lambda a, b: plan.polymul(
            _placed(a, plan.shard_input), _placed(b, plan.shard_input))
        if plan.negacyclic_polymul is not None:
            nfn = plan.negacyclic_polymul
            self._nega = lambda a, b: nfn(
                _placed(a, plan.shard_input), _placed(b, plan.shard_input))
        self._plan = plan

        # Honor config.ordering exactly like the single-chip plan wrappers
        # (plan.py "ordering wrappers"; CLAUDE.md invariant): with
        # ordering='natural' the context's forward returns a flat
        # natural-order vector and inverse accepts one. Spectral-order
        # mode (the default 'bitrev') keeps the sharded matrix layout.
        if self.config.ordering == "natural":
            import jax.numpy as jnp

            n = self.config.n
            pos_np = np.asarray(tw.spectral_positions(*self.config.split))
            inv_perm = np.empty(n, dtype=np.int32)
            inv_perm[pos_np] = np.arange(n, dtype=np.int32)
            pos_d = jnp.asarray(pos_np)
            raw_fwd, raw_inv = self._fwd, self._inv

            def nat_fwd(a):
                return jnp.take(raw_fwd(a).reshape(n), pos_d)

            def nat_inv(s):
                s = np.asarray(s).reshape(-1)
                if s.shape != (n,):
                    raise ValueError(
                        f"ordering='natural' inverse expects a flat "
                        f"({n},) natural-order spectrum, got {s.shape}")
                return raw_inv(s[inv_perm])

            self._fwd, self._inv = nat_fwd, nat_inv

    def _build_distributed_gl(self):
        """Goldilocks distributed context: same surface as the 32-bit path
        but values are uint64 vectors (converted) or (hi, lo) uint32 limb
        pairs (passed through), mirroring the single-chip GL plan's
        convention (goldilocks_plan._in/_out)."""
        import jax
        import jax.numpy as jnp

        from ntt_aie.ops import modops as M
        from ntt_aie.parallel.fourstep import build_gl_distributed_plan

        cfg = self.config
        # dp_axis stays excluded: the context's ordering/conversion wrappers
        # below assume unbatched flat vectors (use the builder directly for
        # dp-batched GL work).
        ok = {"overlap_chunks", "hier_axes", "wmat_factored"}
        bad = sorted(set(self._plan_kwargs) - ok)
        if bad:
            raise TypeError(
                f"plan kwargs {bad} are not supported by the Goldilocks "
                f"distributed builder here (only {sorted(ok)})")
        plan = build_gl_distributed_plan(cfg, self.mesh, **self._plan_kwargs)
        n = cfg.n
        natural = cfg.ordering == "natural"
        if natural:
            pos_np = np.asarray(tw.spectral_positions(*cfg.split))
            inv_perm = np.empty(n, dtype=np.int32)
            inv_perm[pos_np] = np.arange(n, dtype=np.int32)
            pos_d = jnp.asarray(pos_np)

        def _in(x, place):
            # device-placed limb pairs pass through; host uint64 vectors
            # (or host limb pairs) are placed into the plan layout
            if isinstance(x, tuple):
                if all(isinstance(v, jax.Array) and v.ndim >= 2 for v in x):
                    return x, False
                return place(x), False
            return place(x), True

        def _out(h, l, u64):
            return M.gl_to_u64(h, l) if u64 else (h, l)

        def fwd(a):
            hl, u64 = _in(a, plan.shard_input)
            h, l = plan.fwd(hl)
            if natural:
                h = jnp.take(h.reshape(n), pos_d)
                l = jnp.take(l.reshape(n), pos_d)
            return _out(h, l, u64)

        def inv(s):
            if natural:
                # flat natural-order spectrum in: permute, then place
                if isinstance(s, tuple):
                    hi, lo = (np.asarray(v).reshape(-1) for v in s)
                    hl = plan.shard_spectral((hi[inv_perm], lo[inv_perm]))
                    u64 = False
                else:
                    v = np.asarray(s, dtype=np.uint64).reshape(-1)
                    hl = plan.shard_spectral(v[inv_perm])
                    u64 = True
            else:
                hl, u64 = _in(s, plan.shard_spectral)
            return _out(*plan.inv(hl), u64)

        def polymul(a, b):
            ahl, u64 = _in(a, plan.shard_input)
            bhl, _ = _in(b, plan.shard_input)
            return _out(*plan.polymul(ahl, bhl), u64)

        self._fwd, self._inv, self._polymul = fwd, inv, polymul
        if plan.negacyclic_polymul is not None:
            nfn = plan.negacyclic_polymul

            def nega(a, b):
                ahl, u64 = _in(a, plan.shard_input)
                bhl, _ = _in(b, plan.shard_input)
                return _out(*nfn(ahl, bhl), u64)

            self._nega = nega
        self._plan = plan

    @property
    def plan(self):
        if self._fwd is None:
            self._build()
        return self._plan

    def make_batched(self, batch: int) -> dict:
        """Batched serving callables over (batch, n) operands — the
        throughput path (one dispatch per op for the whole batch).
        Returns the plan's dict: `fwd`/`inv`/`polymul` (flat contract)
        plus, on four-step plans, the matrix-form views
        `fwd_mat`/`inv_mat`/`polymul_mat` (and negacyclic twins) over
        (batch, n1, n2) matrices. Single-chip contexts only: distributed
        serving batches shard over a 2D mesh via the builder's dp_axis=
        instead (parallel/fourstep.py)."""
        if self.mesh is not None:
            raise NotImplementedError(
                "make_batched is the single-chip serving surface; with "
                "mesh= use dp_axis= on the distributed builder (a 2D "
                "dp x coeff mesh) for batched serving")
        return self.plan.make_batched(batch)

    # Unbatched matrix-form views (None-guarded delegation to
    # Plan.fwd_mat/inv_mat/polymul_mat).
    def _mat(self, name):
        fn = getattr(self.plan, name, None)
        if fn is None:
            raise NotImplementedError(
                f"this plan has no {name} (matrix-form views exist "
                "on single-chip four-step plans; fwd/inv views "
                "need the default spectral ordering)")
        return fn

    def forward_mat(self, a):
        """Matrix-form forward: (n1, n2) natural-layout -> (n2, n1)
        spectral (row-major flattening equals forward()'s vector
        bit-exactly). Goldilocks plans take/return
        uint64 matrices or (hi, lo) uint32 limb-pair matrices."""
        return self._mat("fwd_mat")(a)

    def inverse_mat(self, s):
        return self._mat("inv_mat")(s)

    def polymul_mat(self, a, b):
        return self._mat("polymul_mat")(a, b)

    def negacyclic_polymul_mat(self, a, b):
        return self._mat("negacyclic_polymul_mat")(a, b)

    def forward(self, a):
        if self._fwd is None:
            self._build()
        return self._fwd(a)

    def inverse(self, a):
        if self._inv is None:
            self._build()
        return self._inv(a)

    def polymul(self, a, b):
        if self._polymul is None:
            self._build()
        return self._polymul(a, b)

    def negacyclic_polymul(self, a, b):
        """a * b in Z_p[X]/(X^n + 1) (RLWE-style). Requires
        NTTConfig(negacyclic=True) so the psi tables were planned."""
        if not self.config.negacyclic:
            raise ValueError(
                "negacyclic_polymul needs NTTConfig(negacyclic=True)"
            )
        self.plan  # ensure built
        fn = getattr(self, "_nega", None) or self.plan.negacyclic_polymul
        if fn is None:
            raise ValueError("plan has no negacyclic path")
        return fn(a, b)
