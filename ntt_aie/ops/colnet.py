"""Column-transform stage schedule in plain jnp.

One copy of the butterfly network every XLA-engine column transform runs:
the single-chip four-step passes, the distributed local passes, the flat
small-n path and the pairwise comparison mode all compile from here, and
the four-step column networks all come from ``twiddles.col_network`` so
the spectral order cannot diverge between engines (the CUDA column pass,
ops/cuda_colpass.py, follows the same schedule).

Values are uint32 arrays shaped (rows, lanes): butterflies run along axis
0, the lane axis is pure SIMD. Twiddle tables are *tuples* of arrays (one
per table of the Reduction strategy, ops/reductions.py). Reshapes only
split or merge leading axes.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ntt_aie.ops.reductions import Reduction


def _stage_shapes(n1: int, direction: str) -> list[int]:
    logn = n1.bit_length() - 1
    if direction == "dif":
        return [n1 >> (s + 1) for s in range(logn)]
    return [1 << s for s in range(logn)]


def stage_tables(vecs, red: Reduction) -> list[tuple]:
    """Per-stage host twiddle vectors -> device table tuples of (t, 1)
    columns, the operand form run_stages broadcasts along the lanes."""
    return [tuple(jnp.asarray(np.ascontiguousarray(t.reshape(-1, 1)))
                  for t in red.prepare_table(v)) for v in vecs]


def apply_wfac_arrays(x, t1s, t2s, red: Reduction):
    """Factored four-step twiddle multiply on a (rows, cols) value whose
    ROWS are the linear exponent axis c = c1*S + c0 (twiddles.fourstep_wfac_T
    orientation): x * T1[c1] * T2[c0] as two chained broadcast constant
    multiplies. t1s: red.n_tables arrays (rows/S, cols); t2s: (S, cols)."""
    rr, cc = x.shape
    s = t2s[0].shape[0]
    xr = x.reshape(rr // s, s, cc)
    xr = red.mul_const(xr, *(t.reshape(rr // s, 1, cc) for t in t1s))
    xr = red.mul_const(xr, *(t.reshape(1, s, cc) for t in t2s))
    return xr.reshape(rr, cc)


def default_fuse(direction: str, nested: bool = False) -> int:
    """Default radix-2^K group size per butterfly direction: K=5 for the
    parts-form DIT net; for DIF K=3 on plain columns and K=1 on nested
    ones. Not yet measured on the GPU (the XLA engines pass fuse=1)."""
    if direction == "dit":
        return 5
    return 1 if nested else 3


def run_stages(x, tws: list, direction: str, red: Reduction, *,
               fuse: int | None = None, dit_net: str = "parts",
               ts: list | None = None):
    """len(tws) butterfly stages over axis 0 of a (nn, c) value, fused in
    radix-2^K groups: K stages per single full-size concat/reshape round,
    with every sub feeding a constant-multiply skipping its conditional
    correction (sub_for_mul: Shoup accepts any x < 2^32). Bit-exact with
    the sequential radix-2 loops by construction.

    tws: per-stage tuples of twiddle arrays, DIF order = largest stride
    first. fuse=None resolves per direction (default_fuse). ts: explicit
    per-stage half-block sizes — used by the nested column phases
    (twiddles.col_network), whose expanded strides don't follow the
    standard full-transform schedule; None = the standard schedule for a
    len(tws)-stage transform over nn rows (DIF: natural in, bit-reversed
    out; DIT: the converse).

    dit_net selects the DIT group network ('parts' default; canonical
    outputs identical across all three, raw lazy-domain bits may differ
    — regression-tested):
    - 'parts': the structural mirror of net_dif — leaf parts, zero
      internal concats, lazy v-subtrees.
    - 'tree': recursive build-up (two concats per internal node).
    - 'iter': level-by-level on the whole block array (one concat per
      level, no lazy domains).
    """
    nn, c = x.shape
    logn = len(tws)
    if fuse is None:
        fuse = default_fuse(direction)
    if ts is None:
        ts = _stage_shapes(nn, direction)[:logn]
    subm = red.sub_for_mul or red.sub

    def net_dif(arr, vecs, tl):
        # arr: (blocks, 2^r, tl, c); vecs[0] = largest-stride stage.
        # Returns leaf parts (blocks, 1, tl, c) in output row order.
        r = arr.shape[1]
        if r == 1:
            return [arr]
        half = r // 2
        u = arr[:, :half]
        v = arr[:, half:]
        w = tuple(wv.reshape(1, half, tl, 1) for wv in vecs[0])
        upper = red.add(u, v)
        lower = red.mul_const(subm(u, v), *w)
        return net_dif(upper, vecs[1:], tl) + net_dif(lower, vecs[1:], tl)

    def net_dit(arr, vecs, tl, lazy=False):
        # vecs[-1] = largest-stride stage (applied at this level). The
        # twiddle vector in leaf order IS wv reshaped (half, tl), so one
        # mul_const/add/sub over the concatenated halves replaces the
        # per-leaf loop.
        #
        # lazy: this node's ENTIRE output feeds the parent's mul_const
        # (it is a v-half subtree within the fused group), so the add/sub
        # conditional corrections can be skipped where the reduction
        # allows (Shoup accepts any x < 2^32; child-1 inputs stay
        # corrected, so u + wv < 2*dom < 2^32). The group's top level is
        # never lazy — group outputs stay in the travel domain. Raw
        # lazy-domain bits then differ from the fuse=1 network (values
        # stay congruent mod p and canonicalize identically).
        r = arr.shape[1]
        if r == 1:
            return [arr]
        half = r // 2
        add_ = (red.add_for_mul if lazy and red.add_for_mul else red.add)
        sub_ = (red.sub_for_mul if lazy and red.sub_for_mul else red.sub)
        u_parts = net_dit(arr[:, :half], vecs[:-1], tl)
        v_parts = net_dit(arr[:, half:], vecs[:-1], tl, lazy=True)
        u = u_parts[0] if len(u_parts) == 1 else jnp.concatenate(
            u_parts, axis=1)
        v = v_parts[0] if len(v_parts) == 1 else jnp.concatenate(
            v_parts, axis=1)
        w = tuple(wv.reshape(1, half, tl, 1) for wv in vecs[-1])
        wv_ = red.mul_const(v, *w)
        return [add_(u, wv_), sub_(u, wv_)]

    def net_dit_parts(arr, vecs, tl, lazy=False):
        # The exact structural mirror of net_dif: recurse on contiguous
        # halves, return LEAF PARTS in output row order, and let the
        # caller do the single per-group concat. The parent's twiddle
        # multiply is applied per part against the matching (tl,) slice
        # of the level's twiddle vector; lazy v-subtrees keep the tree
        # net's one-level domain trick.
        r = arr.shape[1]
        if r == 1:
            return [arr]
        half = r // 2
        add_ = (red.add_for_mul if lazy and red.add_for_mul else red.add)
        sub_ = (red.sub_for_mul if lazy and red.sub_for_mul else red.sub)
        u_parts = net_dit_parts(arr[:, :half], vecs[:-1], tl)
        v_parts = net_dit_parts(arr[:, half:], vecs[:-1], tl, lazy=True)
        ws = tuple(wv.reshape(half, tl) for wv in vecs[-1])
        outs_add, outs_sub = [], []
        for i, (u, v) in enumerate(zip(u_parts, v_parts)):
            wi = tuple(wv[i].reshape(1, 1, tl, 1) for wv in ws)
            wv_ = red.mul_const(v, *wi)
            outs_add.append(add_(u, wv_))
            outs_sub.append(sub_(u, wv_))
        return outs_add + outs_sub

    def net_dit_iter(arr, vecs, tl):
        # Iterative bottom-up DIT group. Level ell (smallest stride
        # first) pairs radix-index j with j + 2^ell inside nested
        # 2^(ell+1)-blocks, so u/v are CONTIGUOUS halves of a reshape
        # view at every level — one two-part concat per level puts
        # (u + w*v, u - w*v) back in place. Fully corrected domains.
        blocks, radix = arr.shape[0], arr.shape[1]
        x = arr
        for ell, wv in enumerate(vecs):
            half = 1 << ell
            r2 = half * 2
            x = x.reshape(blocks * radix // r2, r2, tl, c)
            u = x[:, :half]
            v = x[:, half:]
            w = tuple(t.reshape(1, half, tl, 1) for t in wv)
            wv_ = red.mul_const(v, *w)
            x = jnp.concatenate([red.add(u, wv_), red.sub(u, wv_)], axis=1)
        return [x.reshape(blocks, radix, tl, c)]

    s = 0
    while s < logn:
        k = min(fuse, logn - s)
        radix = 1 << k
        tl = ts[s + k - 1] if direction == "dif" else ts[s]
        blocks = nn // (radix * tl)
        vecs = tws[s : s + k]
        if direction == "dif":
            net = net_dif
        else:
            net = {"iter": net_dit_iter, "parts": net_dit_parts,
                   "tree": net_dit}[dit_net]
        parts = net(x.reshape(blocks, radix, tl, c), vecs, tl)
        x = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
        x = x.reshape(nn, c)
        s += k
    return x


def run_col_network(x, tws, direction: str, red: Reduction, *,
                    phases_ts, mid_vals, rs, fuse=None, dit_net="parts"):
    """The column transform's stage section on an (nn, c) value: one or
    two run_stages phases per twiddles.col_network, with the nested
    mid step between them (DIF: wmid multiply then the (R, S) -> (S, R)
    row-block transpose; DIT: the exact mirror).

    tws: per-stage table tuples for ALL phases in order; mid_vals: the
    wmid table tuple ((nn, 1) values) or None; rs: (R, S)."""
    nn, c_ = x.shape
    if fuse is None:
        fuse = default_fuse(direction, nested=mid_vals is not None)
    if mid_vals is None:
        return run_stages(x, tws, direction, red, fuse=fuse,
                          dit_net=dit_net, ts=list(phases_ts[0]))
    R, S = rs
    k0 = len(phases_ts[0])
    x = run_stages(x, tws[:k0], direction, red, fuse=fuse,
                   dit_net=dit_net, ts=list(phases_ts[0]))
    wm = tuple(w.reshape(nn, 1) for w in mid_vals)
    if direction == "dif":
        x = red.mul_const(x, *wm)
        x = x.reshape(R, S, c_).swapaxes(0, 1).reshape(nn, c_)
    else:
        x = x.reshape(S, R, c_).swapaxes(0, 1).reshape(nn, c_)
        x = red.mul_const(x, *wm)
    return run_stages(x, tws[k0:], direction, red, fuse=fuse,
                      dit_net=dit_net, ts=list(phases_ts[1]))


def make_col_transform(field, nn: int, *, direction: str,
                       inverse: bool = False, red: Reduction,
                       fuse: int | None = 1):
    """Column transform over (nn, c) arrays compiled from the
    twiddles.col_network schedule (nested for nn >= 256). Tables are
    closure constants. fuse=1 keeps compiles cheap; deeper radix-2^K
    groups are an open tuning question on the GPU."""
    from ntt_aie import twiddles as tw

    net = tw.col_network(field, nn, direction=direction, inverse=inverse)
    tws = []
    phases_ts = []
    for ph in net["phases"]:
        tws.extend(stage_tables(ph["vecs"], red))
        phases_ts.append(tuple(ph["ts"]))
    wmid_t = None
    if net["mid"] is not None:
        wmid_t = stage_tables([net["mid"]["wmid"]], red)[0]

    def run(x):
        return run_col_network(x, tws, direction, red,
                               phases_ts=phases_ts, mid_vals=wmid_t,
                               rs=(net["R"], net["S"]), fuse=fuse)

    return run


def make_flat_transform(field, n: int, *, direction: str,
                        inverse: bool = False, red: Reduction):
    """Plain radix-2 transform over axis 0 of (n, c) arrays, never nested:
    DIF natural in -> bit-reversed out, DIT the converse. The flat
    (small-n) plans and the pairwise comparison mode use it; their output
    order is plain bit reversal (twiddles.spectral_positions for n2 == 1)."""
    from ntt_aie import twiddles as tw

    gen = tw.dif_stage_twiddles if direction == "dif" else tw.dit_stage_twiddles
    tws = stage_tables(gen(field, n, inverse=inverse), red)

    def run(x):
        return run_stages(x, tws, direction, red, fuse=1)

    return run


def reference_network_stages(x, table: tuple, p: int, red: Reduction,
                             stages: int | None = None):
    """The reference oracle's network (src/test.cpp:34-60) on a flat vector,
    increasing stride, table indexed table[h+i] per stage — the bit-exact
    parity path. x: (n,) uint32; table: tuple of (n,) device tables."""
    n = x.shape[0]
    logn = n.bit_length() - 1
    for s in range(logn):
        t = 1 << s
        h = n >> (s + 1)
        xr = x.reshape(h, 2, t)
        u = xr[:, 0]
        v = xr[:, 1]
        roots = tuple(tp[h : 2 * h].reshape(h, 1) for tp in table)
        new_u = red.add(u, v)
        new_v = red.mul_const(red.sub(u, v), *roots)
        x = jnp.stack([new_u, new_v], axis=1).reshape(n)
        if stages is not None and s == stages:
            return red.canonicalize(x)
    return red.canonicalize(x)
