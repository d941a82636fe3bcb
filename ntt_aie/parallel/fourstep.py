"""Distributed four-step NTT under shard_map.

This is the L2 scale-out layer (SURVEY.md §7): the reference scales by
pairing tiles per global butterfly stage through a hand-routed lock/swap
network (reference src/aie2.py:183-295, §2.5) — log2(#tiles) exchange
phases. The replacement here reshapes N = N1 x N2 and trades all of that
for ONE all_to_all transpose (SURVEY.md §5.7):

    (N1, N2) sharded P(None, 'x')        each device: (N1, N2/D)
    1. local column DIFs over N1         no communication
    2. local four-step twiddle multiply  W sharded like the data
    3. all_to_all + local transpose      the only collective
    4. local column DIFs over N2         no communication
    -> (N2, N1) sharded P(None, 'x'), same spectral order as the
       single-chip plan (bit-exact).

The inverse mirrors it. The local passes are the same XLA stage loops as
the single-device plan — one code path from 1 device to many. A ppermute-based pairwise-exchange mode (`pairwise_stage`) is
also provided: it is the direct analog of the reference's per-stage
neighbor exchange (reference src/aie_core.cc:161-187 + src/aie2.py swap
phases) and is exposed for comparison benchmarks; four-step wins at scale
because it communicates once instead of log2(D) times.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ntt_aie.config import NTTConfig
from ntt_aie import twiddles as tw
from ntt_aie.ops import colnet
from ntt_aie.ops.reductions import make_reduction, resolve_kind


def _regroup_rows(y, axis: int, a: int, b: int, r: int):
    """View `axis` (length a*b*r) as (a, b, r) blocks and swap a <-> b.

    The static send-side permutation that makes the two-phase hierarchical
    all_to_all land rows in the flat collective's order (see
    _make_transpose_pair); same trick as the overlap-chunk regroup."""
    shp = y.shape
    y = y.reshape(shp[:axis] + (a, b, r) + shp[axis + 1:])
    perm = list(range(y.ndim))
    perm[axis], perm[axis + 1] = perm[axis + 1], perm[axis]
    return y.transpose(perm).reshape(shp)


def _make_transpose_pair(ax, mesh: Mesh):
    """Tiled transpose collectives over `ax`, plus the total shard count.

    `ax` is a mesh axis name (flat: ONE all_to_all), or a (major, minor)
    tuple of axis names for a HIERARCHICAL two-level decomposition — the
    multi-host shape, mesh axes (dcn, ici): a send-side row regroup, an
    all_to_all over the minor axis (rides ICI inside each host group),
    then an all_to_all over the major axis whose messages are L-times
    larger and fewer (the fine-grained per-chip reshuffle already
    happened on ICI, so DCN moves contiguous blocks). Total bytes match
    the flat collective; outputs are bit-identical (fwd(hier) == fwd(flat)
    is regression-tested, and inv is the exact functional mirror
    R^-1 . A_minor^-1 . A_major^-1, so it matches too).

    Returned closures take (y, r, row_axis, col_axis): r is the per-shard
    row-block height of the transpose (n1/D, or the chunk width w1), and
    row/col axes locate the split/concat dims (shifted by one under a
    leading dp batch dim).
    """
    if isinstance(ax, str):
        def fwd(y, r, row_axis=0, col_axis=1):
            return jax.lax.all_to_all(y, ax, split_axis=row_axis,
                                      concat_axis=col_axis, tiled=True)

        def inv(y, r, row_axis=0, col_axis=1):
            return jax.lax.all_to_all(y, ax, split_axis=col_axis,
                                      concat_axis=row_axis, tiled=True)

        return fwd, inv, mesh.shape[ax]

    axg, axl = ax
    G, L = mesh.shape[axg], mesh.shape[axl]

    def fwd(y, r, row_axis=0, col_axis=1):
        # want device (g, l) to receive sender row block g*L + l (the flat
        # id); the two-phase exchange delivers block l*G + g, so pre-swap
        y = _regroup_rows(y, row_axis, G, L, r)
        y = jax.lax.all_to_all(y, axl, split_axis=row_axis,
                               concat_axis=col_axis, tiled=True)
        return jax.lax.all_to_all(y, axg, split_axis=row_axis,
                                  concat_axis=col_axis, tiled=True)

    def inv(y, r, row_axis=0, col_axis=1):
        y = jax.lax.all_to_all(y, axg, split_axis=col_axis,
                               concat_axis=row_axis, tiled=True)
        y = jax.lax.all_to_all(y, axl, split_axis=col_axis,
                               concat_axis=row_axis, tiled=True)
        return _regroup_rows(y, row_axis, L, G, r)

    return fwd, inv, G * L


@dataclasses.dataclass
class DistributedPlan:
    config: NTTConfig
    mesh: Mesh
    fwd: Callable        # (n1, n2) col-sharded -> (n2, n1) col-sharded
    inv: Callable        # (n2, n1) col-sharded -> (n1, n2) col-sharded
    polymul: Callable    # two (n1, n2) -> (n1, n2), cyclic
    spectral_to_natural: np.ndarray  # over the row-major flattened output
    in_sharding: NamedSharding
    out_sharding: NamedSharding
    reduction: str
    # X^n + 1 product (config.negacyclic plans only; fused psi scaling)
    negacyclic_polymul: Optional[Callable] = None
    # True when the four-step twiddle multiply runs from the factored
    # sqrt-size tables (the distributed default since round 4).
    wmat_factored: bool = False

    def shard_input(self, a_flat):
        """Place a flat (n,) host array into the plan's input layout:
        row-major (n1, n2) with columns sharded over the mesh axis."""
        n1, n2 = self.config.split
        a = np.asarray(a_flat)
        shape = (n1, n2) if a.ndim == 1 else (a.shape[0], n1, n2)
        return jax.device_put(a.reshape(shape), self.in_sharding)

    def shard_spectral(self, s_flat):
        """Place a flat spectral (n,) host array into the inverse input
        layout: (n2, n1) with columns sharded (the fwd output layout)."""
        n1, n2 = self.config.split
        s = np.asarray(s_flat)
        shape = (n2, n1) if s.ndim == 1 else (s.shape[0], n2, n1)
        return jax.device_put(s.reshape(shape), self.out_sharding)


def build_distributed_plan(
    config: NTTConfig,
    mesh: Mesh,
    *,
    dp_axis: str | None = None,
    overlap_chunks: int = 1,
    wmat_factored: bool | None = None,
    hier_axes: tuple | None = None,
) -> DistributedPlan:
    """Distributed plan over `mesh`'s `config.mesh_axis`.

    wmat_factored=True applies the four-step twiddle multiply from
    factored sqrt-size tables (twiddles.fourstep_wfac_T) instead of the
    full n1 x n2 matrix. The multiply then rides the pass on the OTHER
    side of the transpose collective — pass 2 'pre' (forward) / pass 2
    'post' (inverse), where local rows are the linear exponent axis and
    lanes are this shard's slice of the bit-reversed axis — mathematically
    the same elementwise multiply (it commutes with the transpose).
    Negacyclic psi matrices become rank-1 row/col vector operands on
    pass 1. Cuts per-shard twiddle traffic ~sqrt(n2)/2 x and the host
    table build/transfer likewise (64 MB -> ~6 MB at the n=2^24
    north-star shape). Bit-identical outputs (tested); None = True.
    Pass False for the full-matrix mode (the A/B comparison path).

    Input is the row-major (n1, n2) coefficient matrix with columns sharded
    over the axis (use plan.shard_input for a flat host vector); output is
    the (n2, n1) spectral matrix, columns sharded. Flattened row-major, the
    output is bit-identical to the single-chip plan's flat spectral order
    for the same (n1, n2) split — verified in tests/test_distributed.py.
    The only cross-device communication in a transform is one all_to_all.

    With dp_axis set (2D mesh), inputs carry a leading batch dim:
    (B, n1, n2) sharded P(dp, None, x) — data parallelism over transforms
    composed with coefficient sharding within each transform.

    hier_axes = (major, minor) mesh axis names decomposes the transpose
    collective hierarchically for two-level networks (DCN hosts x ICI
    chips): the minor-axis all_to_all rides ICI inside each group, the
    major-axis one then moves L-times-larger contiguous blocks across
    groups (see _make_transpose_pair). Coefficients shard over BOTH axes
    (P(None, (major, minor))); outputs are bit-identical to the flat
    single-axis plan on the same total device count (regression-tested).
    Composes with overlap_chunks (each chunk's collective decomposes the
    same way).

    overlap_chunks = C > 1 splits the transpose collective into C
    independent all_to_alls chunked over the n1 axis so the collective
    rides the ICI *while* local butterfly passes run (SURVEY.md §7 hard
    part 4; the analog of the reference's depth-2 FIFO overlap,
    src/aie2.py:28). Forward: chunk k's pass-2 column NTTs start as soon
    as chunk k lands, while chunk k+1 is in flight (consumer-side
    overlap). Inverse: chunk k's collective flies while pass-2 of chunk
    k+1 is computed (producer-side overlap). Chunks are formed over each
    device's *target* row set with a static strided regroup on the send
    side, so the result layout — and every output bit — is identical to
    the monolithic path (regression-tested). Exposed collective time
    drops from 100% to ~1/C once XLA's async scheduler hides the rest.
    Requires n1 % (D * C) == 0. The dp-batched path chunks the same way
    (each transform's collective splits into C per-chunk all_to_alls).
    """
    field = config.field
    kind = resolve_kind(config.reduction, field)
    red = make_reduction(kind, field)
    n = config.n
    p = field.p
    ax = tuple(hier_axes) if hier_axes is not None else config.mesh_axis
    a2a_f, a2a_i, D = _make_transpose_pair(ax, mesh)
    n1, n2 = config.split
    if n2 % D:
        raise ValueError(f"n2={n2} must divide by mesh axis size {D}")
    if n1 % D:
        raise ValueError(f"n1={n1} must divide by mesh axis size {D} (for the transpose)")
    C = overlap_chunks
    if C < 1:
        raise ValueError("overlap_chunks must be >= 1")
    w1 = n1 // (D * C)
    if C > 1 and w1 * D * C != n1:
        raise ValueError(
            f"n1={n1} must divide by D*overlap_chunks={D * C} for chunked overlap"
        )

    # ---- host tables (same as single-chip plan) ----
    # Distributed default: factored. Full-table broadcast is exactly what
    # does not scale (SURVEY.md §7 hard part 5).
    wfac_on = bool(wmat_factored) if wmat_factored is not None else True
    if wfac_on:
        # Factored mode never touches the full n1 x n2 matrices: skip
        # their O(n) host build (and 2 x 134 MB footprint at n=2^24).
        tabs = tw.fourstep_tables_light(field, n1, n2)
    else:
        tabs = tw.fourstep_tables(field, n1, n2)
        wmat, iwmat_scaled = tabs["wmat"], tabs["iwmat_scaled"]
        if kind == "montgomery":
            iwmat_poly = (
                iwmat_scaled.astype(np.uint64) * np.uint64(field.mont_r_mod_p) % np.uint64(p)
            ).astype(np.int64)
        else:
            iwmat_poly = iwmat_scaled
    pos = tabs["pos"]

    ntab = red.n_tables
    if wfac_on:
        S_split = tw.default_wfac_split(n2)
        n_inv = tabs["n_inv"]
        poly_scale = (n_inv * field.mont_r_mod_p % p
                      if kind == "montgomery" else n_inv)
        _pw = tw.root_powers(field, n)  # one O(n) table for all three
        wfac_f = tw.fourstep_wfac_T(field, n1, n2, split=S_split, _pows=_pw)
        wfac_i = tw.fourstep_wfac_T(field, n1, n2, inverse=True,
                                    scale=n_inv, split=S_split, _pows=_pw)
        wfac_ip = (wfac_i if poly_scale == n_inv else
                   tw.fourstep_wfac_T(field, n1, n2, inverse=True,
                                      scale=poly_scale, split=S_split,
                                      _pows=_pw))
        del _pw

        def _prep_fac(fac):
            t1, t2 = fac
            return (tuple(jnp.asarray(t) for t in red.prepare_table(t1))
                    + tuple(jnp.asarray(t) for t in red.prepare_table(t2)))

        wfac_f_d = _prep_fac(wfac_f)
        wfac_i_d = _prep_fac(wfac_i)
        wfac_ip_d = wfac_i_d if wfac_ip is wfac_i else _prep_fac(wfac_ip)
    else:
        S_split = 0

    if wfac_on:
        # The full n1 x n2 matrices are never shipped to the devices in
        # factored mode — that is the point.
        wmat_d = iwmat_d = iwmat_poly_d = ()
    else:
        wmat_d = tuple(jnp.asarray(t) for t in red.prep_mat(wmat))
        iwmat_d = tuple(jnp.asarray(t) for t in red.prep_mat(iwmat_scaled))
        iwmat_poly_d = tuple(jnp.asarray(t) for t in red.prep_mat(iwmat_poly))
    nw = len(wmat_d)  # device tables per full-matrix operand (0 if factored)

    if dp_axis is None:
        colshard = P(None, ax)      # (rows, cols) with cols sharded
        wspec = colshard
    else:
        colshard = P(dp_axis, None, ax)  # (batch, rows, cols)
        wspec = P(None, ax)

    # ---- local pass engines ----
    # Uniform signatures across engines and twiddle modes:
    #   p1(x, t1)       pass 1 on the local (n1, n2/D) coefficient block
    #   p2(xl, t2, c)   pass 2 on transposed overlap chunk c: (n2, w1)
    #   ip2(xl, t2, c)  inverse pass 2 on spectral chunk c: (n2, w1)
    #   ip1(y, t1)      inverse pass 1 on the regrouped (n1, n2/D) block
    # t1/t2 are the shard_map table operands consumed by that pass. In
    # factored mode the four-step multiply (t2 = wfac slices, sharded over
    # their n1 lane axis) rides pass 2, on the far side of the collective;
    # c is the STATIC overlap-chunk index selecting the lane sub-slice.

    def _fac_slice(t2, c):
        if C == 1:
            return t2
        return tuple(jax.lax.slice_in_dim(a, c * w1, (c + 1) * w1, axis=1)
                     for a in t2)

    # Column transforms from the shared schedule (twiddles.col_network —
    # nested phases for columns >= 256; same spectral order as the
    # single-chip plan by construction).
    col1 = colnet.make_col_transform(field, n1, direction="dif", red=red)
    col2 = colnet.make_col_transform(field, n2, direction="dif", red=red)
    icol1 = colnet.make_col_transform(field, n1, direction="dit",
                                      inverse=True, red=red)
    icol2 = colnet.make_col_transform(field, n2, direction="dit",
                                      inverse=True, red=red)

    def p1_std(x, t1):
        y = col1(x)
        return red.mulc_mat(y, *t1) if t1 else y

    def p2(xl, t2, c):
        if t2:
            w = _fac_slice(t2, c)
            xl = colnet.apply_wfac_arrays(xl, w[:ntab], w[ntab:], red)
        return red.canonicalize(col2(xl))

    def ip2(xl, t2, c):
        y = icol2(xl)
        if t2:
            w = _fac_slice(t2, c)
            y = colnet.apply_wfac_arrays(y, w[:ntab], w[ntab:], red)
        return y

    def ip1_std(y, t1):
        if t1:
            y = red.mulc_mat(y, *t1)
        return red.canonicalize(icol1(y))

    # ---- negacyclic psi-scaling engines (X^n + 1 arithmetic) ----
    # Fused exactly like the single-chip plan (plan.py): psi^j rides pass 1
    # as a second 'pre' multiply; psi^-j rides the LAST inverse pass as a
    # 'post' multiply before canonicalization. Full psi matrices shard like
    # wmat (columns over the mesh axis); in factored mode psi is its exact
    # rank-1 factorization — a replicated (n1, 1) row factor plus a
    # column-sharded (1, n2) lane factor (twiddles.negacyclic_psi_factors).
    if config.negacyclic:
        if wfac_on:
            def _prep_r1(fac):
                rvec, cvec = fac
                return (tuple(jnp.asarray(np.ascontiguousarray(t.reshape(n1, 1)))
                              for t in red.prepare_table(rvec))
                        + tuple(jnp.asarray(np.ascontiguousarray(t.reshape(1, n2)))
                                for t in red.prepare_table(cvec)))

            psi_d = _prep_r1(tw.negacyclic_psi_factors(field, n1, n2))
            ipsi_d = _prep_r1(tw.negacyclic_psi_factors(field, n1, n2,
                                                        inverse=True))
        else:
            psi_mat = tw.negacyclic_psi_powers(field, n).reshape(n1, n2)
            psi_inv_mat = tw.negacyclic_psi_powers(field, n, inverse=True).reshape(n1, n2)
            psi_d = tuple(jnp.asarray(t) for t in red.prep_mat(psi_mat))
            ipsi_d = tuple(jnp.asarray(t) for t in red.prep_mat(psi_inv_mat))
        if wfac_on:

            def p1_neg(x, t1):
                y = red.mul_const(red.mul_const(x, *t1[:ntab]), *t1[ntab:])
                return col1(y)

            def ip1_neg(y, t1):
                y = icol1(y)
                y = red.mul_const(red.mul_const(y, *t1[:ntab]), *t1[ntab:])
                return red.canonicalize(y)
        else:

            def p1_neg(x, t1):
                y = red.mulc_mat(x, *t1[nw:])
                y = col1(y)
                return red.mulc_mat(y, *t1[:nw])

            def ip1_neg(y, t1):
                y = red.mulc_mat(y, *t1[:nw])
                y = icol1(y)
                return red.canonicalize(red.mulc_mat(y, *t1[nw:]))

    # ---- shard_map bodies ----
    if dp_axis is None:
        def make_fwd_body(p1, n_t1):
            def fwd_body(x, *tabs):
                # x: local (n1, n2/D); tabs: local table-operand slices,
                # pass-1 operands first, pass-2 operands after
                t1, t2 = tabs[:n_t1], tabs[n_t1:]
                y = p1(x, t1)
                if C == 1:
                    # one monolithic all_to_all: (n1, n2/D) -> (n1/D, n2)
                    y = a2a_f(y, w1)
                    return p2(y.T, t2, 0)
                # Chunked overlap: regroup rows by (dest device, chunk) and
                # issue one independent all_to_all per chunk — pass-2 column
                # NTTs on chunk k have no data dependence on chunk k+1's
                # collective, so XLA's async scheduler overlaps them. Chunk c
                # carries every device's target rows d*(n1/D) + c*w1 + [0,w1),
                # which makes the concatenated output bit-identical to C == 1.
                yg = y.reshape(D, C, w1, n2 // D)
                outs = []
                for c in range(C):
                    yc = yg[:, c].reshape(D * w1, n2 // D)
                    tc = a2a_f(yc, w1)                    # (w1, n2)
                    outs.append(p2(tc.T, t2, c))          # (n2, w1)
                return jnp.concatenate(outs, axis=1)      # (n2, n1/D)
            return fwd_body

        def make_inv_body(ip1, n_t2):
            def inv_body(x, *tabs):
                # x: local (n2, n1/D) spectral; pass-2 operands first
                t2, t1 = tabs[:n_t2], tabs[n_t2:]
                if C == 1:
                    y = ip2(x, t2, 0)
                    y = y.T  # (n1/D, n2)
                    y = a2a_i(y, w1)
                    return ip1(y, t1)  # (n1, n2/D)
                # Producer-side overlap: chunk k's collective flies while
                # pass-2 (ipass2) computes chunk k+1. Received chunks are
                # regrouped to the monolithic row order before ipass1.
                recv = []
                for c in range(C):
                    xc = jax.lax.slice_in_dim(x, c * w1, (c + 1) * w1, axis=1)
                    yc = ip2(xc, t2, c)                   # (n2, w1)
                    tc = a2a_i(yc.T, w1)
                    recv.append(tc)                       # (D*w1, n2/D)
                z = jnp.stack(recv, axis=0)               # (C, D*w1, n2/D)
                z = z.reshape(C, D, w1, n2 // D).transpose(1, 0, 2, 3)
                return ip1(z.reshape(n1, n2 // D), t1)
            return inv_body
    else:
        # batched: local blocks (B/dp, n1, n2/D); vmap the 2D local passes.
        # Chunked overlap mirrors the 1D bodies with a leading batch dim
        # (the a2a row/col axes shift by one).
        def make_fwd_body(p1, n_t1):
            def fwd_body(x, *tabs):
                t1, t2 = tabs[:n_t1], tabs[n_t1:]
                y = jax.vmap(lambda xb: p1(xb, t1))(x)
                if C == 1:
                    y = a2a_f(y, w1, 1, 2)
                    y = jnp.transpose(y, (0, 2, 1))
                    return jax.vmap(lambda xb: p2(xb, t2, 0))(y)
                bl = y.shape[0]
                yg = y.reshape(bl, D, C, w1, n2 // D)
                outs = []
                for c in range(C):
                    yc = yg[:, :, c].reshape(bl, D * w1, n2 // D)
                    tc = a2a_f(yc, w1, 1, 2)           # (bl, w1, n2)
                    tc = jnp.transpose(tc, (0, 2, 1))  # (bl, n2, w1)
                    outs.append(jax.vmap(lambda xb: p2(xb, t2, c))(tc))
                return jnp.concatenate(outs, axis=2)   # (bl, n2, n1/D)
            return fwd_body

        def make_inv_body(ip1, n_t2):
            def inv_body(x, *tabs):
                t2, t1 = tabs[:n_t2], tabs[n_t2:]
                if C == 1:
                    y = jax.vmap(lambda xb: ip2(xb, t2, 0))(x)
                    y = jnp.transpose(y, (0, 2, 1))
                    y = a2a_i(y, w1, 1, 2)
                    return jax.vmap(lambda xb: ip1(xb, t1))(y)
                bl = x.shape[0]
                recv = []
                for c in range(C):
                    xc = jax.lax.slice_in_dim(x, c * w1, (c + 1) * w1, axis=2)
                    yc = jax.vmap(lambda xb: ip2(xb, t2, c))(xc)  # (bl, n2, w1)
                    tc = a2a_i(jnp.transpose(yc, (0, 2, 1)), w1, 1, 2)
                    recv.append(tc)                    # (bl, D*w1, n2/D)
                z = jnp.stack(recv, axis=1)            # (bl, C, D*w1, n2/D)
                z = z.reshape(bl, C, D, w1, n2 // D).transpose(0, 2, 1, 3, 4)
                z = z.reshape(bl, n1, n2 // D)
                return jax.vmap(lambda xb: ip1(xb, t1))(z)
            return inv_body

    def smap(body, tab_specs):
        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(colshard,) + tuple(tab_specs),
            out_specs=colshard,
        )

    if wfac_on:
        # wfac tables (n2/S, n1) + (S, n1): sharded over their n1 LANE axis
        facspec = (wspec,) * (2 * ntab)
        fwd_m = smap(make_fwd_body(p1_std, 0), facspec)
        inv_m = smap(make_inv_body(ip1_std, 2 * ntab), facspec)
        fwd_tabs, inv_tabs, inv_poly_tabs = wfac_f_d, wfac_i_d, wfac_ip_d
    else:
        mspec = (wspec,) * nw
        fwd_m = smap(make_fwd_body(p1_std, nw), mspec)
        inv_m = smap(make_inv_body(ip1_std, 0), mspec)
        fwd_tabs, inv_tabs, inv_poly_tabs = wmat_d, iwmat_d, iwmat_poly_d

    def fwd_fn(a):
        return fwd_m(a.astype(jnp.uint32), *fwd_tabs)

    def inv_fn(a):
        return inv_m(a.astype(jnp.uint32), *inv_tabs)

    def _pointwise(fa, fb):
        if kind == "montgomery":
            from ntt_aie.ops import modops as M

            return M.mont_mul(fa, fb, p, field.mont_neg_pinv)
        return red.mul_data(fa, fb)

    def polymul_fn(a, b):
        fa = fwd_fn(a)
        fb = fwd_fn(b)
        fc = _pointwise(fa, fb)
        return inv_m(fc, *inv_poly_tabs)

    negacyclic_fn = None
    if config.negacyclic:
        if wfac_on:
            # psi rank-1: replicated row factor + column-sharded lane factor
            r1spec = (P(None, None),) * ntab + (wspec,) * ntab
            fwd_neg_m = smap(make_fwd_body(p1_neg, 2 * ntab), r1spec + facspec)
            inv_neg_m = smap(make_inv_body(ip1_neg, 2 * ntab), facspec + r1spec)
            neg_fwd_tabs = psi_d + wfac_f_d
            neg_inv_tabs = wfac_ip_d + ipsi_d
        else:
            fwd_neg_m = smap(make_fwd_body(p1_neg, 2 * nw), (wspec,) * (2 * nw))
            inv_neg_m = smap(make_inv_body(ip1_neg, 0), (wspec,) * (2 * nw))
            neg_fwd_tabs = wmat_d + psi_d
            neg_inv_tabs = iwmat_poly_d + ipsi_d

        def negacyclic_fn(a, b):
            fa = fwd_neg_m(a.astype(jnp.uint32), *neg_fwd_tabs)
            fb = fwd_neg_m(b.astype(jnp.uint32), *neg_fwd_tabs)
            fc = _pointwise(fa, fb)
            return inv_neg_m(fc, *neg_inv_tabs)

    in_sharding = NamedSharding(mesh, P(None, ax) if dp_axis is None else P(dp_axis, None, ax))

    return DistributedPlan(
        config=config,
        mesh=mesh,
        fwd=jax.jit(fwd_fn),
        inv=jax.jit(inv_fn),
        polymul=jax.jit(polymul_fn),
        spectral_to_natural=pos,
        in_sharding=in_sharding,
        out_sharding=in_sharding,
        reduction=kind,
        negacyclic_polymul=(jax.jit(negacyclic_fn)
                            if negacyclic_fn is not None else None),
        wmat_factored=wfac_on,
    )


# ---------------------------------------------------------------------------
# Reference-style pairwise exchange (comparison mode)
# ---------------------------------------------------------------------------

def pairwise_global_stage(x_local, stage_idx: int, D: int, axis: str,
                          w_tables: tuple, red, *, top_half_first: bool = True):
    """One cross-shard GS butterfly stage via ppermute, the direct analog of
    the reference's ntt_1stage over paired tiles (src/aie_core.cc:161-187):
    device d pairs with d ^ (D >> (stage_idx+1)); both exchange their blocks
    and each computes its half of the butterfly.

    x_local: this shard's (m,) or (m, c) block. w_tables: this shard's
    twiddle (broadcast slice prepared host-side). Used by the comparison
    benchmark, not the production path (four-step communicates once).
    """
    half = D >> (stage_idx + 1)
    me = jax.lax.axis_index(axis)
    partner = me ^ half
    perm = [(d, d ^ half) for d in range(D)]
    other = jax.lax.ppermute(x_local, axis, perm)
    am_upper = (me & half) != 0
    u = jnp.where(am_upper, other, x_local)
    v = jnp.where(am_upper, x_local, other)
    out_lower = red.add(u, v)
    out_upper = red.mul_const(red.sub(u, v), *w_tables)
    return jnp.where(am_upper, out_upper, out_lower)


# ---------------------------------------------------------------------------
# Goldilocks (64-bit prime) distributed four-step on (hi, lo) limb pairs
# ---------------------------------------------------------------------------

def build_gl_distributed_plan(config: NTTConfig, mesh: Mesh, *,
                              overlap_chunks: int = 1,
                              dp_axis: str | None = None,
                              hier_axes: tuple | None = None,
                              wmat_factored: bool | None = None) -> DistributedPlan:
    """Distributed four-step NTT for p = 2^64 - 2^32 + 1: same structure as
    build_distributed_plan but every value travels as a (hi, lo) uint32 limb
    pair — two same-shaped arrays through the same shardings and the same
    single all_to_all (issued per limb).

    The local passes are goldilocks_plan.gl_col_transform, the
    single-chip XLA Goldilocks engine's column transform.

    With dp_axis set (2D mesh), inputs carry a leading batch dim:
    (B, n1, n2) limb pairs sharded P(dp, None, x) — the same DP x coeff
    composition as the 32-bit plan; overlap_chunks splits each
    transform's collective per chunk in both the 1D and batched paths.
    hier_axes decomposes the transpose per network tier exactly as in
    build_distributed_plan.

    wmat_factored mirrors build_distributed_plan at 64 bits: the
    four-step multiply runs from sqrt-size factored limb tables riding
    pass 2 on the far side of the collective (fwd 'pre' / inv 'post');
    negacyclic psi becomes rank-1 limb-pair vector operands. GL is where
    full matrices hurt most — TWO limb planes per (n1, n2) operand.
    None = True (the distributed default since round 4); bit-identical
    outputs either way (tested)."""
    from ntt_aie.goldilocks_plan import _dev_limbs, _split_limbs
    from ntt_aie.ops import modops as M

    field = config.field
    n = config.n
    p = field.p
    ax = tuple(hier_axes) if hier_axes is not None else config.mesh_axis
    a2a_f, a2a_i, D = _make_transpose_pair(ax, mesh)
    n1, n2 = config.split
    if n2 % D or n1 % D:
        raise ValueError(f"split {config.split} must divide by mesh size {D}")
    C = overlap_chunks
    w1 = n1 // (D * C)
    if C < 1 or (C > 1 and w1 * D * C != n1):
        raise ValueError(
            f"n1={n1} must divide by D*overlap_chunks={D * C} for chunked overlap"
        )
    wfac_on = bool(wmat_factored) if wmat_factored is not None else True
    if wfac_on:
        tabs = tw.fourstep_tables_light(field, n1, n2)
        pos = tabs["pos"]
        S_split = tw.default_wfac_split(n2)
        _pw = tw.root_powers(field, n)  # one O(n) table for both
        wf_f = tw.fourstep_wfac_T(field, n1, n2, split=S_split, _pows=_pw)
        wf_i = tw.fourstep_wfac_T(field, n1, n2, inverse=True,
                                  scale=tabs["n_inv"], split=S_split,
                                  _pows=_pw)
        del _pw
        # 4 limb arrays per direction: T1 (n2/S, n1) hi/lo + T2 (S, n1)
        # hi/lo, sharded over their n1 LANE axis with the data
        wfac_f_d = _dev_limbs(wf_f[0]) + _dev_limbs(wf_f[1])
        wfac_i_d = _dev_limbs(wf_i[0]) + _dev_limbs(wf_i[1])
        wmat_d = iwmat_d = ()
    else:
        S_split = 0
        tabs = tw.fourstep_tables(field, n1, n2)
        wmat, iwmat_scaled, pos = (tabs["wmat"], tabs["iwmat_scaled"],
                                   tabs["pos"])
        wmat_d = _dev_limbs(wmat)
        iwmat_d = _dev_limbs(iwmat_scaled)
        wfac_f_d = wfac_i_d = ()

    def _fac_slice(t2, c):
        # slice the lane axis of the 4 factored limb arrays per chunk
        if C == 1 or not t2:
            return t2
        return tuple(jax.lax.slice_in_dim(a, c * w1, (c + 1) * w1, axis=1)
                     for a in t2)

    def _gl_apply_wfac(h, l, t2):
        # rows are the linear exponent axis c = c1*S + c0 (same math as
        # colnet.apply_wfac_arrays, on limbs)
        rr, cc = h.shape
        s = t2[2].shape[0]
        hr, lr = h.reshape(rr // s, s, cc), l.reshape(rr // s, s, cc)
        hr, lr = M.gl_mul(hr, lr, t2[0].reshape(rr // s, 1, cc),
                          t2[1].reshape(rr // s, 1, cc))
        hr, lr = M.gl_mul(hr, lr, t2[2].reshape(1, s, cc),
                          t2[3].reshape(1, s, cc))
        return hr.reshape(rr, cc), lr.reshape(rr, cc)

    # ---- local pass engines (uniform signatures, like the 32-bit plan) ----
    #   p1(h, l, t1)      pass 1 on the local (n1, n2/D) block; t1 = full
    #                     wmat limb pair [+ psi pair], or psi rank-1 limbs
    #   p2(h, l, t2, c)   pass 2 on a transposed (n2, w1) chunk; t2 = the
    #                     factored limb tables (sliced per chunk c), or ()
    #   ip2(h, l, t2, c)  inverse pass 2 on a spectral (n2, w1) chunk
    #   ip1(h, l, t1)     inverse pass 1 on the regrouped (n1, n2/D) block
    # Column networks from the shared schedule (same spectral order as
    # every other engine by construction).
    from ntt_aie.goldilocks_plan import gl_col_transform

    gcol1 = gl_col_transform(field, n1, direction="dif")
    gcol2 = gl_col_transform(field, n2, direction="dif")
    gicol1 = gl_col_transform(field, n1, direction="dit", inverse=True)
    gicol2 = gl_col_transform(field, n2, direction="dit", inverse=True)

    def p1(h, l, t1):
        if wfac_on:
            if t1:  # psi rank-1 limbs: (rh, rl, ch, cl)
                h, l = M.gl_mul(h, l, t1[0], t1[1])
                h, l = M.gl_mul(h, l, t1[2], t1[3])
            return gcol1(h, l)
        if len(t1) > 2:  # (wmat pair, psi pair): psi applies FIRST
            h, l = M.gl_mul(h, l, t1[2], t1[3])
        h, l = gcol1(h, l)
        return M.gl_mul(h, l, t1[0], t1[1])

    def p2(h, l, t2, c):
        if t2:  # factored four-step multiply rides pass 2 'pre'
            h, l = _gl_apply_wfac(h, l, _fac_slice(t2, c))
        return gcol2(h, l)

    def ip2(h, l, t2, c):
        h, l = gicol2(h, l)
        if t2:
            h, l = _gl_apply_wfac(h, l, _fac_slice(t2, c))
        return h, l

    def ip1(h, l, t1):
        if wfac_on:
            h, l = gicol1(h, l)
            if t1:  # psi^-1 rank-1 limbs applied after the stages
                h, l = M.gl_mul(h, l, t1[0], t1[1])
                h, l = M.gl_mul(h, l, t1[2], t1[3])
            return h, l
        h, l = M.gl_mul(h, l, t1[0], t1[1])
        h, l = gicol1(h, l)
        if len(t1) > 2:
            h, l = M.gl_mul(h, l, t1[2], t1[3])
        return h, l

    if dp_axis is None:
        colshard = P(None, ax)      # (rows, cols) with cols sharded
        wspec = colshard
    else:
        colshard = P(dp_axis, None, ax)  # (batch, rows, cols)
        wspec = P(None, ax)

    def _a2a_fwd(h, l, r, row_axis=0, col_axis=1):
        return a2a_f(h, r, row_axis, col_axis), a2a_f(l, r, row_axis, col_axis)

    def _a2a_inv(h, l, r, row_axis=0, col_axis=1):
        return a2a_i(h, r, row_axis, col_axis), a2a_i(l, r, row_axis, col_axis)

    def make_fwd_body(n_t1):
        def fwd_body(h, l, *tabs):
            # tabs: pass-1 limb operands first (n_t1), pass-2 after
            t1, t2 = tabs[:n_t1], tabs[n_t1:]
            h, l = p1(h, l, t1)
            if C == 1:
                h, l = _a2a_fwd(h, l, w1)
                return p2(h.T, l.T, t2, 0)
            # Chunked overlap over the target n1 rows — the same
            # regrouping as the 32-bit plan, applied to both limb planes.
            hg = h.reshape(D, C, w1, n2 // D)
            lg = l.reshape(D, C, w1, n2 // D)
            oh, ol = [], []
            for c in range(C):
                tch, tcl = _a2a_fwd(hg[:, c].reshape(D * w1, n2 // D),
                                    lg[:, c].reshape(D * w1, n2 // D), w1)
                rh, rl = p2(tch.T, tcl.T, t2, c)         # (n2, w1)
                oh.append(rh)
                ol.append(rl)
            return jnp.concatenate(oh, axis=1), jnp.concatenate(ol, axis=1)
        return fwd_body

    def make_inv_body(n_t2):
        def inv_body(h, l, *tabs):
            t2, t1 = tabs[:n_t2], tabs[n_t2:]
            if C == 1:
                h, l = ip2(h, l, t2, 0)
                h, l = _a2a_inv(h.T, l.T, w1)
            else:
                rh, rl = [], []
                for c in range(C):
                    hc = jax.lax.slice_in_dim(h, c * w1, (c + 1) * w1, axis=1)
                    lc = jax.lax.slice_in_dim(l, c * w1, (c + 1) * w1, axis=1)
                    yh, yl = ip2(hc, lc, t2, c)          # (n2, w1)
                    tch, tcl = _a2a_inv(yh.T, yl.T, w1)  # (D*w1, n2/D)
                    rh.append(tch)
                    rl.append(tcl)
                h = jnp.stack(rh, 0).reshape(C, D, w1, n2 // D) \
                       .transpose(1, 0, 2, 3).reshape(n1, n2 // D)
                l = jnp.stack(rl, 0).reshape(C, D, w1, n2 // D) \
                       .transpose(1, 0, 2, 3).reshape(n1, n2 // D)
            return ip1(h, l, t1)
        return inv_body

    if dp_axis is not None:
        # Batched bodies: vmap the local limb passes over the per-device
        # batch; the two all_to_alls move to the shifted axes (the same
        # composition as the 32-bit plan's batched bodies, incl. the
        # per-chunk collective split when C > 1).
        def make_fwd_body(n_t1):  # noqa: F811
            def fwd_body(h, l, *tabs):
                t1, t2 = tabs[:n_t1], tabs[n_t1:]
                h, l = jax.vmap(lambda hb, lb: p1(hb, lb, t1))(h, l)
                if C == 1:
                    h, l = _a2a_fwd(h, l, w1, 1, 2)
                    h = jnp.transpose(h, (0, 2, 1))
                    l = jnp.transpose(l, (0, 2, 1))
                    return jax.vmap(lambda hb, lb: p2(hb, lb, t2, 0))(h, l)
                bl = h.shape[0]
                hg = h.reshape(bl, D, C, w1, n2 // D)
                lg = l.reshape(bl, D, C, w1, n2 // D)
                oh, ol = [], []
                for c in range(C):
                    tch, tcl = _a2a_fwd(
                        hg[:, :, c].reshape(bl, D * w1, n2 // D),
                        lg[:, :, c].reshape(bl, D * w1, n2 // D), w1, 1, 2)
                    rh, rl = jax.vmap(lambda hb, lb, _c=c: p2(hb, lb, t2, _c))(
                        jnp.transpose(tch, (0, 2, 1)),
                        jnp.transpose(tcl, (0, 2, 1)))
                    oh.append(rh)
                    ol.append(rl)
                return (jnp.concatenate(oh, axis=2),
                        jnp.concatenate(ol, axis=2))
            return fwd_body

        def make_inv_body(n_t2):  # noqa: F811
            def inv_body(h, l, *tabs):
                t2, t1 = tabs[:n_t2], tabs[n_t2:]
                if C == 1:
                    h, l = jax.vmap(lambda hb, lb: ip2(hb, lb, t2, 0))(h, l)
                    h = jnp.transpose(h, (0, 2, 1))
                    l = jnp.transpose(l, (0, 2, 1))
                    h, l = _a2a_inv(h, l, w1, 1, 2)
                else:
                    bl = h.shape[0]
                    rh, rl = [], []
                    for c in range(C):
                        hc = jax.lax.slice_in_dim(h, c * w1, (c + 1) * w1,
                                                  axis=2)
                        lc = jax.lax.slice_in_dim(l, c * w1, (c + 1) * w1,
                                                  axis=2)
                        yh, yl = jax.vmap(
                            lambda hb, lb, _c=c: ip2(hb, lb, t2, _c))(hc, lc)
                        tch, tcl = _a2a_inv(jnp.transpose(yh, (0, 2, 1)),
                                            jnp.transpose(yl, (0, 2, 1)),
                                            w1, 1, 2)
                        rh.append(tch)
                        rl.append(tcl)

                    def _regroup_b(parts):
                        z = jnp.stack(parts, axis=1)  # (bl, C, D*w1, n2/D)
                        z = z.reshape(bl, C, D, w1, n2 // D) \
                             .transpose(0, 2, 1, 3, 4)
                        return z.reshape(bl, n1, n2 // D)

                    h, l = _regroup_b(rh), _regroup_b(rl)
                return jax.vmap(lambda hb, lb: ip1(hb, lb, t1))(h, l)
            return inv_body

    def smap(body, tab_specs):
        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(colshard, colshard) + tuple(tab_specs),
            out_specs=(colshard, colshard),
        )

    if wfac_on:
        # wfac limb tables (n2/S, n1) + (S, n1) hi/lo: sharded over their
        # n1 LANE axis with the data; they ride pass 2
        facspec = (wspec,) * 4
        fwd_m = smap(make_fwd_body(0), facspec)
        inv_m = smap(make_inv_body(4), facspec)
        fwd_tabs, inv_tabs = wfac_f_d, wfac_i_d
    else:
        fwd_m = smap(make_fwd_body(2), (wspec,) * 2)
        inv_m = smap(make_inv_body(0), (wspec,) * 2)
        fwd_tabs, inv_tabs = wmat_d, iwmat_d

    def fwd_fn(hl):
        return fwd_m(hl[0], hl[1], *fwd_tabs)

    def inv_fn(hl):
        return inv_m(hl[0], hl[1], *inv_tabs)

    def polymul_fn(a, b):
        fah, fal = fwd_fn(a)
        fbh, fbl = fwd_fn(b)
        fc = M.gl_mul(fah, fal, fbh, fbl)
        return inv_fn(fc)

    negacyclic_fn = None
    if config.negacyclic:
        if wfac_on:
            # psi rank-1 limb factors: replicated row pair (n1, 1) +
            # column-sharded lane pair (1, n2) — ordered (rh, rl, ch, cl)
            def _r1_limbs(fac):
                row, col = fac
                rh, rl = _split_limbs(np.reshape(row, (n1, 1)))
                ch, cl = _split_limbs(np.reshape(col, (1, n2)))
                return (jnp.asarray(rh), jnp.asarray(rl),
                        jnp.asarray(ch), jnp.asarray(cl))

            psi_d = _r1_limbs(tw.negacyclic_psi_factors(field, n1, n2))
            ipsi_d = _r1_limbs(tw.negacyclic_psi_factors(field, n1, n2,
                                                         inverse=True))
            r1spec = (P(None, None),) * 2 + (wspec,) * 2
            fwd_neg_m = smap(make_fwd_body(4), r1spec + facspec)
            inv_neg_m = smap(make_inv_body(4), facspec + r1spec)
            neg_fwd_tabs = psi_d + wfac_f_d
            neg_inv_tabs = wfac_i_d + ipsi_d
        else:
            psi_d = _dev_limbs(
                tw.negacyclic_psi_powers(field, n).reshape(n1, n2))
            ipsi_d = _dev_limbs(
                tw.negacyclic_psi_powers(field, n,
                                         inverse=True).reshape(n1, n2))
            fwd_neg_m = smap(make_fwd_body(4), (wspec,) * 4)
            inv_neg_m = smap(make_inv_body(0), (wspec,) * 4)
            neg_fwd_tabs = wmat_d + psi_d
            neg_inv_tabs = iwmat_d + ipsi_d

        def negacyclic_fn(a, b):
            fah, fal = fwd_neg_m(a[0], a[1], *neg_fwd_tabs)
            fbh, fbl = fwd_neg_m(b[0], b[1], *neg_fwd_tabs)
            fc = M.gl_mul(fah, fal, fbh, fbl)
            return inv_neg_m(fc[0], fc[1], *neg_inv_tabs)

    in_sharding = NamedSharding(mesh, colshard)

    plan = DistributedPlan(
        config=config,
        mesh=mesh,
        fwd=jax.jit(fwd_fn),
        inv=jax.jit(inv_fn),
        polymul=jax.jit(polymul_fn),
        spectral_to_natural=pos,
        in_sharding=in_sharding,
        out_sharding=in_sharding,
        reduction="goldilocks",
        negacyclic_polymul=(jax.jit(negacyclic_fn)
                            if negacyclic_fn is not None else None),
        wmat_factored=wfac_on,
    )

    def _split_u64(a_flat):
        if isinstance(a_flat, tuple):
            return tuple(np.asarray(x) for x in a_flat)
        v = np.asarray(a_flat, dtype=np.uint64)
        return ((v >> np.uint64(32)).astype(np.uint32),
                (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    def _place(pair, r, c):
        # one transform is r*c values (however shaped); anything bigger
        # is a dp_axis batch with a leading batch dim
        hi, lo = pair
        shape = (r, c) if hi.size == r * c else (hi.shape[0], r, c)
        return (jax.device_put(hi.reshape(shape), in_sharding),
                jax.device_put(lo.reshape(shape), in_sharding))

    def shard_input_gl(a_flat):
        """uint64 host vector — or (B, n) batch with dp_axis — (or a
        (hi, lo) pair) -> sharded limb pair."""
        return _place(_split_u64(a_flat), n1, n2)

    def shard_spectral_gl(s_flat):
        """flat spectral uint64 vector (or (hi, lo) pair) -> the inverse
        input layout: (n2, n1) sharded limb pair (the fwd output layout)."""
        return _place(_split_u64(s_flat), n2, n1)

    plan.shard_input = shard_input_gl
    plan.shard_spectral = shard_spectral_gl
    return plan


def build_pairwise_plan(config: NTTConfig, mesh: Mesh):
    """Full forward NTT in the REFERENCE's scaling topology: the first
    log2(D) butterfly stages exchange shard halves pairwise per stage
    (ppermute), then all remaining stages run shard-local — the direct
    transcription of the reference's cross-tile phase structure
    (src/aie2.py:183-295: stage-per-exchange over the tile grid, then
    tile-local stages). Provided as the comparison mode to the production
    four-step plan: log2(D) collectives instead of one all_to_all.

    Input: flat (n,) contiguously sharded over the mesh axis. Output: the
    standard DIF bit-reversed order, same sharding — bit-exact with
    reference.ntt_dif. Returns (fwd, in_sharding).
    """
    field = config.field
    kind = resolve_kind(config.reduction, field)
    red = make_reduction(kind, field)
    n = config.n
    p = field.p
    ax = config.mesh_axis
    D = mesh.shape[ax]
    logd = D.bit_length() - 1
    m = n // D
    if m * D != n or m < 2:
        raise ValueError(f"n={n} must split into >=2 rows per device over D={D}")

    # Cross-shard stage twiddles: stage s, stride t = n >> (s+1). Shard d's
    # m elements (in the lower role of each pair) use vec[j0 + r] with
    # j0 = (lower_shard & (2*half - 1)) * m; upper shards share the lower
    # partner's slice (one twiddle per butterfly). Shipped as (n,) arrays
    # sharded over the axis so each shard reads exactly its slice.
    vecs = tw.dif_stage_twiddles(field, n)
    cross_tables = []
    for s in range(logd):
        half = D >> (s + 1)
        vec = vecs[s]  # length t = half * m
        slices = []
        for d in range(D):
            dl = min(d, d ^ half)
            k = dl & (2 * half - 1)
            slices.append(vec[k * m : (k + 1) * m])
        full = np.concatenate(slices)
        cross_tables.extend(red.prepare_table(full))
    nt = red.n_tables

    # Local stages: identical twiddle values to the global stages at the
    # same stride (omega_m = omega_n^D), so the plain size-m tables apply.
    dif_local = colnet.make_flat_transform(field, m, direction="dif",
                                           red=red)

    def body(x, *cross):
        for s in range(logd):
            w = tuple(cross[s * nt + k] for k in range(nt))
            x = pairwise_global_stage(x, s, D, ax, w, red)
        x = dif_local(x.reshape(m, 1)).reshape(m)
        return red.canonicalize(x)

    fwd_m = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ax),) * (1 + logd * nt),
        out_specs=P(ax),
    )
    cross_dev = [jnp.asarray(t) for t in cross_tables]

    def fwd(a):
        return fwd_m(a.astype(jnp.uint32), *cross_dev)

    return jax.jit(fwd), NamedSharding(mesh, P(ax))
