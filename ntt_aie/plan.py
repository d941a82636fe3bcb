"""Plan builder: compiles an NTTConfig into jitted device callables.

The forward transform is the four-step decomposition (SURVEY.md §5.7): with
N = N1 x N2 and input viewed row-major as an (N1, N2) matrix,

    fwd = flatten . colDIF_{N2} . transpose . (* W) . colDIF_{N1} . reshape

where colDIF is a butterfly column pass (butterflies along the row axis)
and W[r, j2] = omega^(s1(r) * j2) has the pass-1 output order baked in
host-side. The flat output is in a fixed "spectral" order:

    flat[c*N1 + r] = X[s2(c)*N1 + s1(r)]

(twiddles.spectral_positions). Pointwise products are order-agnostic, so
polymul never permutes; a natural-order gather is planned only when
config.ordering == 'natural'.

The inverse runs the mirror (colDIT passes) with the full 1/N scale — and,
on the Montgomery path, the stray R^-1 from pointwise products — folded into
the inverse twiddle matrix, so no extra passes over the data.

Two engines run the four-step column passes, bit-identical by contract:
- 'xla'  — ops/colnet.py stage loops under jit (runs anywhere; also the
           multi-device shard_map building block),
- 'cuda' — ops/cuda_colpass.py, one CUDA kernel per pass on NVIDIA GPUs
           (device memory read and written once per pass).
engine='auto' resolves to 'cuda' on a GPU backend for the splits the
kernel covers, and to 'xla' otherwise; Plan.engine says which.

Lazy-domain note: with the Harvey reductions the XLA engine's values travel
in [0, 2p) or [0, 4p) through all passes and are canonicalized once at
pipeline exit; the CUDA kernel keeps them canonical throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ntt_aie.config import NTTConfig
from ntt_aie import twiddles as tw
from ntt_aie import reference as ref
from ntt_aie.ops import colnet
from ntt_aie.ops.reductions import make_reduction, resolve_kind


@dataclasses.dataclass
class Plan:
    config: NTTConfig
    fwd: Callable
    inv: Callable
    polymul: Callable
    negacyclic_polymul: Optional[Callable]
    spectral_to_natural: Optional[np.ndarray]  # gather indices, or None
    engine: str
    reduction: str
    # make_batched(B) -> dict(fwd=..., inv=..., polymul=...) over (B, n)
    # uint32 arrays: one dispatch per op for the whole batch. Four-step
    # plans add matrix-form views: `fwd_mat` (B, n1, n2) natural-layout
    # -> (B, n2, n1) spectral and `inv_mat` its converse (spectral-order
    # plans only), plus `polymul_mat`/`negacyclic_polymul_mat` over
    # (B, n1, n2) operands. They are row-major reshapes of the flat
    # callables, so flattening a matrix-form result gives the flat
    # callable's vector bit-exactly.
    _batched_builder: Optional[Callable] = None
    _batched_cache: dict = dataclasses.field(default_factory=dict)
    # Unbatched matrix-form views with the same contract (no leading batch
    # dim). None on flat-split plans and, for fwd/inv, on
    # ordering='natural' plans.
    fwd_mat: Optional[Callable] = None
    inv_mat: Optional[Callable] = None
    polymul_mat: Optional[Callable] = None
    negacyclic_polymul_mat: Optional[Callable] = None

    def make_batched(self, batch: int) -> dict:
        if batch not in self._batched_cache:
            if self._batched_builder is None:
                raise NotImplementedError("no batched path for this plan")
            self._batched_cache[batch] = self._batched_builder(batch)
        return self._batched_cache[batch]


def _u32cast(a):
    return a if a.dtype == jnp.uint32 else a.astype(jnp.uint32)


def _dev(tables: tuple) -> tuple:
    return tuple(jnp.asarray(np.ascontiguousarray(t)) for t in tables)


def _reshaped(v, shape):
    """Reshape a value: an array, or a (hi, lo) limb pair of arrays."""
    if isinstance(v, tuple):
        return tuple(_reshaped(x, shape) for x in v)
    return v.reshape(shape)


def _batch_dims(v):
    """Leading dims of a matrix-form value (array or limb pair)."""
    x = v[0] if isinstance(v, tuple) else v
    return tuple(x.shape[:-2])


def mat_views(fns: dict, n1: int, n2: int, *, spectral: bool) -> dict:
    """Matrix-form views of flat four-step callables (Plan.fwd_mat
    contract): fwd_mat (.., n1, n2) natural layout -> (.., n2, n1)
    spectral, inv_mat the converse (spectral plans only), polymul_mat and
    negacyclic_polymul_mat (.., n1, n2) -> (.., n1, n2). Row-major
    reshapes around the flat callables; values may be limb pairs."""
    n = n1 * n2
    out = {}

    def view(fn, out_shape):
        def call(*args):
            lead = _batch_dims(args[0])
            flat = fn(*(_reshaped(a, lead + (n,)) for a in args))
            return _reshaped(flat, lead + out_shape)
        return call

    if spectral:
        out["fwd_mat"] = view(fns["fwd"], (n2, n1))
        out["inv_mat"] = view(fns["inv"], (n1, n2))
    out["polymul_mat"] = view(fns["polymul"], (n1, n2))
    if fns.get("negacyclic_polymul") is not None:
        out["negacyclic_polymul_mat"] = view(fns["negacyclic_polymul"],
                                             (n1, n2))
    return out


def resolve_engine(engine: str, config: NTTConfig) -> str:
    """'auto' -> 'cuda' on a GPU backend when the CUDA column pass covers
    the config's four-step split, else 'xla'. An explicit 'cuda' raises
    (ValueError for a split or prime the kernel does not cover,
    RuntimeError off the GPU) — it never gives way to another engine."""
    from ntt_aie.ops import cuda_colpass as CC

    field = config.field
    n1, n2 = config.split
    covered = (config.table_convention == "standard" and n2 > 1
               and CC.supports(field, n1, n2))
    if engine == "xla":
        return "xla"
    if engine == "auto":
        return "cuda" if covered and jax.default_backend() == "gpu" else "xla"
    if engine == "cuda":
        if not covered:
            raise ValueError(
                f"the CUDA column pass covers four-step splits with both "
                f"factors in {CC.SUPPORTED_COLUMNS} over odd p < 2^31, not "
                f"split {config.split} with p={field.p}")
        if jax.default_backend() != "gpu":
            raise RuntimeError(
                "engine='cuda' needs an NVIDIA GPU backend; JAX reports "
                f"{jax.default_backend()!r}")
        return "cuda"
    raise ValueError(f"unknown engine {engine!r} (auto | xla | cuda)")


def build_plan(config: NTTConfig, *, engine: str = "auto") -> Plan:
    """engine: 'auto' (see resolve_engine), 'xla' or 'cuda'."""
    field = config.field
    kind = resolve_kind(config.reduction, field)

    if config.table_convention == "reference":
        return _build_reference_plan(config, kind)
    if kind == "goldilocks":
        from ntt_aie.goldilocks_plan import build_goldilocks_plan

        return build_goldilocks_plan(config, engine=engine)

    engine = resolve_engine(engine, config)
    n = config.n
    p = field.p
    red = make_reduction(kind, field)
    n1, n2 = config.split

    @jax.jit
    def _pointwise(fa, fb):
        """Spectral pointwise product (Montgomery leaves a stray R^-1 that
        the iwmat_poly tables fold away in the poly-inverse)."""
        if kind == "montgomery":
            from ntt_aie.ops import modops as M

            return M.mont_mul(fa, fb, p, field.mont_neg_pinv)
        return red.mul_data(fa, fb)

    nega_fn = None
    batched_builder = None

    # ---- host-side tables ----
    if n2 > 1:
        tabs = tw.fourstep_tables(field, n1, n2)
        wmat, iwmat_scaled, pos = tabs["wmat"], tabs["iwmat_scaled"], tabs["pos"]
        if kind == "montgomery":
            iwmat_poly = (iwmat_scaled.astype(np.uint64) * np.uint64(field.mont_r_mod_p) % np.uint64(p)).astype(np.int64)
        else:
            iwmat_poly = iwmat_scaled
    else:
        n_inv = field.inv(n)
        scale = np.full(1, n_inv, dtype=object)
        if kind == "montgomery":
            scale_poly = scale * field.mont_r_mod_p % p
        else:
            scale_poly = scale
        pos = tw.spectral_positions(n1, 1)

    # ---- column-pass engines ----
    if engine == "cuda":
        from ntt_aie.ops import cuda_colpass as CC

        # Every pass takes (B, rows, cols); the four-step twiddle multiply
        # rides the transposing pass's store, in the output orientation.
        cp1 = CC.make_colpass(field, n1, inverse=False, transpose_out=True,
                              post=np.ascontiguousarray(wmat.T))
        cp2 = CC.make_colpass(field, n2, inverse=False)
        icp2 = CC.make_colpass(field, n2, inverse=True, transpose_out=True,
                               post=iwmat_scaled)
        icp2p = (icp2 if iwmat_poly is iwmat_scaled else
                 CC.make_colpass(field, n2, inverse=True, transpose_out=True,
                                 post=iwmat_poly))
        icp1 = CC.make_colpass(field, n1, inverse=True)

        # The flat callables accept (n,) or (B, n): leading dims ride the
        # kernels' batch axis.
        def fwd_fn(a):
            x = _u32cast(a).reshape(-1, n1, n2)
            return cp2(cp1(x)).reshape(a.shape)

        def _inv_core(a, icp2_, icp1_):
            x = _u32cast(a).reshape(-1, n2, n1)
            return icp1_(icp2_(x)).reshape(a.shape)

        inv_fn = lambda a: _inv_core(a, icp2, icp1)  # noqa: E731
        inv_poly_fn = lambda a: _inv_core(a, icp2p, icp1)  # noqa: E731

        if config.negacyclic:
            # psi^j rides pass 1's load, psi^-j the last pass's store
            psi_mat = tw.negacyclic_psi_powers(field, n).reshape(n1, n2)
            psi_inv_mat = tw.negacyclic_psi_powers(
                field, n, inverse=True).reshape(n1, n2)
            ncp1 = CC.make_colpass(field, n1, inverse=False,
                                   transpose_out=True, pre=psi_mat,
                                   post=np.ascontiguousarray(wmat.T))
            nicp1 = CC.make_colpass(field, n1, inverse=True,
                                    post=psi_inv_mat)

            def nega_fn(a, b):
                fa = cp2(ncp1(_u32cast(a).reshape(-1, n1, n2)))
                fb = cp2(ncp1(_u32cast(b).reshape(-1, n1, n2)))
                return _inv_core(_pointwise(fa, fb), icp2p,
                                 nicp1).reshape(a.shape)

    elif n2 > 1:  # xla engine
        col1 = colnet.make_col_transform(field, n1, direction="dif", red=red)
        col2 = colnet.make_col_transform(field, n2, direction="dif", red=red)
        icol1 = colnet.make_col_transform(field, n1, direction="dit",
                                          inverse=True, red=red)
        icol2 = colnet.make_col_transform(field, n2, direction="dit",
                                          inverse=True, red=red)
        wmat_dev = _dev(red.prep_mat(wmat))
        iwmat_dev = _dev(red.prep_mat(iwmat_scaled))
        iwmat_poly_dev = _dev(red.prep_mat(iwmat_poly))

        def fwd_fn(a):
            x = a.astype(jnp.uint32).reshape(n1, n2)
            x = col1(x)
            x = red.mulc_mat(x, *wmat_dev)
            x = x.T
            x = col2(x)
            return red.canonicalize(x).reshape(n)

        def _inv_core(a, iw):
            x = a.astype(jnp.uint32).reshape(n2, n1)
            x = icol2(x)
            x = x.T
            x = red.mulc_mat(x, *iw)
            x = icol1(x)
            return red.canonicalize(x).reshape(n)

        inv_fn = lambda a: _inv_core(a, iwmat_dev)  # noqa: E731
        inv_poly_fn = lambda a: _inv_core(a, iwmat_poly_dev)  # noqa: E731

    else:  # flat path (small n): plain DIF/DIT on (n, 1), xla engine
        dif1 = colnet.make_flat_transform(field, n1, direction="dif", red=red)
        dit1 = colnet.make_flat_transform(field, n1, direction="dit",
                                          inverse=True, red=red)
        scale_dev = _dev(red.prepare_table(scale))
        scale_poly_dev = _dev(red.prepare_table(scale_poly))

        def fwd_fn(a):
            x = a.astype(jnp.uint32).reshape(n1, 1)
            return red.canonicalize(dif1(x)).reshape(n)

        def _inv_core(a, sc):
            x = dit1(a.astype(jnp.uint32).reshape(n1, 1))
            x = red.mul_const(x, *(s.reshape(1, 1) for s in sc))
            return red.canonicalize(x).reshape(n)

        inv_fn = lambda a: _inv_core(a, scale_dev)  # noqa: E731
        inv_poly_fn = lambda a: _inv_core(a, scale_poly_dev)  # noqa: E731

        # Batch-to-lanes layout: a (B, n) batch transposes to (n, B) so the
        # batch rides the lane axis and butterflies the row axis (a vmap of
        # the (n, 1) path would leave the lane axis one wide). The serving
        # shape for Kyber/Dilithium-sized rings.
        def batched_builder(B):
            # (n, B)-domain cores; the public callables transpose at the
            # boundary and are jitted as COMPOSED functions (including the
            # ordering wrapper) so each call is one dispatch.
            def fwd_cols(x):               # (n, B) -> (n, B)
                return red.canonicalize(dif1(x))

            def inv_cols(x, sc):           # (n, B) -> (n, B)
                x = dit1(x)
                x = red.mul_const(x, *(s.reshape(1, 1) for s in sc))
                return red.canonicalize(x)

            def fwd_b(a):
                return fwd_cols(_u32cast(a).reshape(B, n).T).T

            def inv_b(a):
                return inv_cols(_u32cast(a).reshape(B, n).T, scale_dev).T

            def polymul_b(a, b):
                fa = fwd_cols(_u32cast(a).reshape(B, n).T)
                fb = fwd_cols(_u32cast(b).reshape(B, n).T)
                return inv_cols(_pointwise(fa, fb), scale_poly_dev).T

            out = {"polymul": jax.jit(polymul_b)}
            if config.negacyclic:
                psi_b = _dev(red.prepare_table(
                    tw.negacyclic_psi_powers(field, n).reshape(-1, 1)))
                psi_inv_b = _dev(red.prepare_table(
                    tw.negacyclic_psi_powers(field, n, inverse=True).reshape(-1, 1)))

                def nega_b(a, b):
                    ta = red.canonicalize(red.mul_const(
                        _u32cast(a).reshape(B, n).T, *psi_b))
                    tb = red.canonicalize(red.mul_const(
                        _u32cast(b).reshape(B, n).T, *psi_b))
                    tc = inv_cols(_pointwise(fwd_cols(ta), fwd_cols(tb)),
                                  scale_poly_dev)
                    return red.canonicalize(
                        red.mul_const(tc, *psi_inv_b)).T

                out["negacyclic_polymul"] = jax.jit(nega_b)
            if config.ordering == "natural":
                raw_fwd_fb, raw_inv_fb = fwd_b, inv_b
                fwd_b = lambda a: jnp.take(raw_fwd_fb(a), perm, axis=1)  # noqa: E731
                inv_b = lambda a: raw_inv_fb(jnp.take(a, inv_perm, axis=1))  # noqa: E731
            out["fwd"] = jax.jit(fwd_b)
            out["inv"] = jax.jit(inv_b)
            return out

    # _fwd/_inv bind the *spectral-order* callables now, before the ordering
    # wrappers rebind fwd_fn below: pointwise products are order-agnostic, so
    # polymul always runs in spectral order regardless of config.ordering.
    def polymul_fn(a, b, _fwd=fwd_fn, _inv=inv_poly_fn):
        fa = _fwd(a)
        fb = _fwd(b)
        fc = _pointwise(fa, fb)
        return _inv(fc)

    spectral_to_natural = pos

    # ---- ordering wrappers ----
    if config.ordering == "natural":
        perm = jnp.asarray(spectral_to_natural)
        inv_perm = np.empty(n, dtype=np.int32)
        inv_perm[spectral_to_natural] = np.arange(n, dtype=np.int32)
        inv_perm = jnp.asarray(inv_perm)
        raw_fwd, raw_inv = fwd_fn, inv_fn
        fwd_fn = lambda a: jnp.take(raw_fwd(a), perm, axis=-1)  # noqa: E731
        inv_fn = lambda a: raw_inv(jnp.take(a, inv_perm, axis=-1))  # noqa: E731

    # ---- negacyclic (XLA engine; the cuda branch fused its own) ----
    if config.negacyclic and nega_fn is None:
        psi = _dev(red.prepare_table(tw.negacyclic_psi_powers(field, n)))
        psi_inv = _dev(red.prepare_table(tw.negacyclic_psi_powers(field, n, inverse=True)))

        def nega_fn(a, b):
            ta = red.canonicalize(red.mul_const(a.astype(jnp.uint32), *psi))
            tb = red.canonicalize(red.mul_const(b.astype(jnp.uint32), *psi))
            tc = polymul_fn(ta, tb)
            return red.canonicalize(red.mul_const(tc, *psi_inv))

    flat_fns = {"fwd": fwd_fn, "inv": inv_fn, "polymul": polymul_fn,
                "negacyclic_polymul": nega_fn}

    if batched_builder is None:
        # four-step: the cuda callables take (B, n) as they are; the XLA
        # engine's are vmapped. Matrix-form views ride on top.
        def batched_builder(B):
            wrap = jax.jit if engine == "cuda" else (
                lambda f: jax.jit(jax.vmap(f)))
            out = {k: wrap(f) for k, f in flat_fns.items() if f is not None}
            out.update(mat_views(out, n1, n2,
                                 spectral=config.ordering == "bitrev"))
            return out

    jitted = {k: jax.jit(f) for k, f in flat_fns.items() if f is not None}
    mat_kw = {}
    if n2 > 1:
        mat_kw = mat_views(jitted, n1, n2,
                           spectral=config.ordering == "bitrev")
    return Plan(
        config=config,
        fwd=jitted["fwd"],
        inv=jitted["inv"],
        polymul=jitted["polymul"],
        negacyclic_polymul=jitted.get("negacyclic_polymul"),
        spectral_to_natural=spectral_to_natural,
        engine=engine,
        reduction=kind,
        _batched_builder=batched_builder,
        **mat_kw,
    )


def _build_reference_plan(config: NTTConfig, kind: str) -> Plan:
    """Bit-exact parity with the reference device (butterfly network with the
    caller's natural-order table + ANS_ORDER_16 block layout)."""
    field = config.field
    n = config.n
    p = field.p
    red = make_reduction(kind, field)
    table = _dev(red.prepare_table(tw.power_table(field, n)))

    if config.ordering == "reference":
        inv_order = np.empty(16, dtype=np.int32)
        inv_order[ref.ANS_ORDER_16] = np.arange(16, dtype=np.int32)
        inv_order = jnp.asarray(inv_order)

        def fwd_fn(a):
            x = colnet.reference_network_stages(a.astype(jnp.uint32), table, p, red)
            return jnp.take(x.reshape(16, n // 16), inv_order, axis=0).reshape(n)

    else:

        def fwd_fn(a):
            return colnet.reference_network_stages(a.astype(jnp.uint32), table, p, red)

    def _no_inverse(*_):
        raise NotImplementedError(
            "reference table convention has no inverse (not a DFT; SURVEY.md §0)"
        )

    return Plan(
        config=config,
        fwd=jax.jit(fwd_fn),
        inv=_no_inverse,
        polymul=_no_inverse,
        negacyclic_polymul=None,
        spectral_to_natural=None,
        engine="xla",
        reduction=kind,
    )
