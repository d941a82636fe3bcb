"""Device plan for the Goldilocks field p = 2^64 - 2^32 + 1.

Lanes are 32-bit, so 64-bit field elements travel as (hi, lo) uint32
limb pairs (SURVEY.md §7 hard part 1 taken one word wider: where the 32-bit
primes emulate the reference's acc64 with 16-bit limb products, Goldilocks
stacks that into a 4-partial-product 128-bit multiply reduced with
2^64 ≡ 2^32 - 1, 2^96 ≡ -1 — ops/modops.py gl_*). The transform structure
is the same four-step decomposition as plan.py:

    fwd = flatten . colDIF_{N2} . transpose . (* W) . colDIF_{N1} . reshape

with the 1/n inverse scale (and nothing else — no Montgomery stray factors;
gl_mul is a plain modmul) folded into the inverse twiddle matrix.

Value interface: every plan callable accepts either
- a ``(hi, lo)`` tuple of uint32 arrays (device-resident form), returning a
  tuple, or
- a NumPy ``uint64`` array (host convenience), returning ``uint64``.

The limb-pair form is what jit sees; the uint64 conversion happens on host.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ntt_aie.config import NTTConfig
from ntt_aie import twiddles as tw
from ntt_aie.ops import modops as M


def _split_limbs(t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64/object array of field elements -> (hi, lo) uint32 arrays.

    Vectorized (round 4): every Goldilocks value fits uint64 exactly, and
    NumPy converts object arrays of ints in [0, 2^64) to uint64 directly —
    the old per-element Python loop was a measured plan-setup cost on top
    of the table build at n >= 2^22."""
    flat = np.asarray(t)
    if flat.dtype != np.uint64:
        flat = flat.astype(np.uint64)
    hi = (flat >> np.uint64(32)).astype(np.uint32)
    lo = (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.ascontiguousarray(hi), np.ascontiguousarray(lo)


def _dev_limbs(t: np.ndarray):
    hi, lo = _split_limbs(t)
    return jnp.asarray(hi), jnp.asarray(lo)


def gl_dif_stages(h, l, twh, twl):
    """Gentleman-Sande DIF along axis 0 on limb pairs; natural row order in,
    bit-reversed out. h, l: (n, C) uint32; twh/twl: (log2 n, n//2) packed
    stage tables (twiddles.pack_stage_twiddles layout)."""
    n, c = h.shape
    logn = n.bit_length() - 1
    for s in range(logn):
        t = n >> (s + 1)
        blocks = n // (2 * t)
        hr = h.reshape(blocks, 2, t, c)
        lr = l.reshape(blocks, 2, t, c)
        uh, ul = hr[:, 0], lr[:, 0]
        vh, vl = hr[:, 1], lr[:, 1]
        ah, al = M.gl_add(uh, ul, vh, vl)
        dh, dl = M.gl_sub(uh, ul, vh, vl)
        wh = twh[s].reshape(blocks, t, 1)
        wl = twl[s].reshape(blocks, t, 1)
        bh, bl = M.gl_mul(dh, dl, wh, wl)
        h = jnp.stack([ah, bh], axis=1).reshape(n, c)
        l = jnp.stack([al, bl], axis=1).reshape(n, c)
    return h, l


def gl_dit_stages(h, l, twh, twl):
    """Cooley-Tukey DIT along axis 0 on limb pairs; bit-reversed in,
    natural out."""
    n, c = h.shape
    logn = n.bit_length() - 1
    for s in range(logn):
        t = 1 << s
        blocks = n // (2 * t)
        hr = h.reshape(blocks, 2, t, c)
        lr = l.reshape(blocks, 2, t, c)
        uh, ul = hr[:, 0], lr[:, 0]
        vh, vl = hr[:, 1], lr[:, 1]
        wh = twh[s].reshape(blocks, t, 1)
        wl = twl[s].reshape(blocks, t, 1)
        wvh, wvl = M.gl_mul(vh, vl, wh, wl)
        ah, al = M.gl_add(uh, ul, wvh, wvl)
        bh, bl = M.gl_sub(uh, ul, wvh, wvl)
        h = jnp.stack([ah, bh], axis=1).reshape(n, c)
        l = jnp.stack([al, bl], axis=1).reshape(n, c)
    return h, l


def _pack_dev(field, n, *, direction, inverse=False):
    gen = tw.dif_stage_twiddles if direction == "dif" else tw.dit_stage_twiddles
    packed = tw.pack_stage_twiddles(gen(field, n, inverse=inverse), n)
    return _dev_limbs(packed)


def gl_col_transform(field, nn: int, *, direction: str,
                     inverse: bool = False):
    """Pure-jnp GL column transform over (h, l) limb pairs of shape
    (nn, c) — compiled from the SAME twiddles.col_network schedule as the
    32-bit engines (nested
    phases for nn >= 256 columns), so the spectral order cannot diverge
    between value widths or engines. The stage loops are the radix-2
    gl_dif/dit_stages bodies with explicit stride lists; the nested mid
    step is a gl_mul by the flat wmid limb pair plus the (R, S)
    row-block transpose (DIT runs the exact mirror)."""
    net = tw.col_network(field, nn, direction=direction, inverse=inverse)
    phases = []
    for ph in net["phases"]:
        phases.append((list(ph["ts"]),
                       [_dev_limbs(v.reshape(-1, 1)) for v in ph["vecs"]]))
    wmid_hl = (_dev_limbs(net["mid"]["wmid"].reshape(-1, 1))
               if net["mid"] is not None else None)
    R, S = net["R"], net["S"]

    def _stages(h, l, ts, vecs):
        n_, c = h.shape
        for t, (wh, wl) in zip(ts, vecs):
            blocks = n_ // (2 * t)
            hr = h.reshape(blocks, 2, t, c)
            lr = l.reshape(blocks, 2, t, c)
            uh, ul = hr[:, 0], lr[:, 0]
            vh, vl = hr[:, 1], lr[:, 1]
            w_h = wh.reshape(1, t, 1)
            w_l = wl.reshape(1, t, 1)
            if direction == "dif":
                ah, al = M.gl_add(uh, ul, vh, vl)
                dh, dl = M.gl_sub(uh, ul, vh, vl)
                bh, bl = M.gl_mul(dh, dl, w_h, w_l)
            else:
                wvh, wvl = M.gl_mul(vh, vl, w_h, w_l)
                ah, al = M.gl_add(uh, ul, wvh, wvl)
                bh, bl = M.gl_sub(uh, ul, wvh, wvl)
            h = jnp.stack([ah, bh], axis=1).reshape(n_, c)
            l = jnp.stack([al, bl], axis=1).reshape(n_, c)
        return h, l

    def run(h, l):
        c = h.shape[1]
        h, l = _stages(h, l, *phases[0])
        if wmid_hl is not None:
            if direction == "dif":
                h, l = M.gl_mul(h, l, wmid_hl[0], wmid_hl[1])
                h = h.reshape(R, S, c).swapaxes(0, 1).reshape(nn, c)
                l = l.reshape(R, S, c).swapaxes(0, 1).reshape(nn, c)
            else:
                h = h.reshape(S, R, c).swapaxes(0, 1).reshape(nn, c)
                l = l.reshape(S, R, c).swapaxes(0, 1).reshape(nn, c)
                h, l = M.gl_mul(h, l, wmid_hl[0], wmid_hl[1])
            h, l = _stages(h, l, *phases[1])
        return h, l

    return run


def build_goldilocks_plan(config: NTTConfig, *, engine: str = "auto"):
    """Goldilocks plan on the XLA engine (the gl_dif/dit_stages loops and
    gl_col_transform below). engine: 'auto' or 'xla'; there is no CUDA
    Goldilocks column pass, so 'cuda' raises."""
    from ntt_aie.plan import Plan, mat_views  # avoid import cycle at load

    if engine not in ("auto", "xla"):
        raise ValueError(f"engine {engine!r}: Goldilocks plans run on the "
                         "XLA engine only ('auto' | 'xla')")
    engine = "xla"

    field = config.field
    n = config.n
    n1, n2 = config.split
    make_batched_cores = None  # set by the flat branch

    if n2 > 1:
        tabs = tw.fourstep_tables(field, n1, n2)
        wmat, iwmat_scaled, pos = (tabs["wmat"], tabs["iwmat_scaled"],
                                   tabs["pos"])
        col1 = gl_col_transform(field, n1, direction="dif")
        col2 = gl_col_transform(field, n2, direction="dif")
        icol1 = gl_col_transform(field, n1, direction="dit",
                                 inverse=True)
        icol2 = gl_col_transform(field, n2, direction="dit",
                                 inverse=True)
        wmat_dev = _dev_limbs(wmat)
        iwmat_dev = _dev_limbs(iwmat_scaled)

        def fwd_core(h, l):
            h, l = col1(h.reshape(n1, n2), l.reshape(n1, n2))
            h, l = M.gl_mul(h, l, *wmat_dev)
            h, l = h.T, l.T
            h, l = col2(h, l)
            return h.reshape(n), l.reshape(n)

        def inv_core(h, l):
            h, l = icol2(h.reshape(n2, n1), l.reshape(n2, n1))
            h, l = h.T, l.T
            h, l = M.gl_mul(h, l, *iwmat_dev)
            h, l = icol1(h, l)
            return h.reshape(n), l.reshape(n)

    else:  # flat path (small n)
        n_inv = field.inv(n)
        pos = tw.bit_reverse_indices(n).astype(np.int32)
        tw1 = _pack_dev(field, n1, direction="dif")
        itw1 = _pack_dev(field, n1, direction="dit", inverse=True)
        sh, sl = _dev_limbs(np.full(1, n_inv, dtype=object))

        def fwd_core(h, l):
            h, l = gl_dif_stages(h.reshape(n, 1), l.reshape(n, 1), *tw1)
            return h.reshape(n), l.reshape(n)

        def inv_core(h, l):
            h, l = gl_dit_stages(h.reshape(n, 1), l.reshape(n, 1), *itw1)
            h, l = M.gl_mul(h, l, sh.reshape(1, 1), sl.reshape(1, 1))
            return h.reshape(n), l.reshape(n)

        def make_batched_cores(B):
            """Batch-to-lanes: (B, n) limb batches transpose to (n, B) so
            the batch rides the lane axis through the stage loops
            (mirrors plan.py's flat batched layout)."""

            def fwd_b(h, l):
                oh, ol = gl_dif_stages(h.reshape(B, n).T, l.reshape(B, n).T,
                                       *tw1)
                return oh.T, ol.T

            def inv_b(h, l):
                oh, ol = gl_dit_stages(h.reshape(B, n).T, l.reshape(B, n).T,
                                       *itw1)
                oh, ol = M.gl_mul(oh, ol, sh.reshape(1, 1), sl.reshape(1, 1))
                return oh.T, ol.T

            return jax.jit(fwd_b), jax.jit(inv_b)

    # _fwd/_inv bind the spectral-order callables now, before the natural-
    # ordering wrappers rebind fwd_core/inv_core below (pointwise products
    # are order-agnostic; see plan.py polymul_fn).
    def polymul_core(ah, al, bh, bl, _fwd=fwd_core, _inv=inv_core):
        fah, fal = _fwd(ah, al)
        fbh, fbl = _fwd(bh, bl)
        ch, cl = M.gl_mul(fah, fal, fbh, fbl)
        return _inv(ch, cl)

    spectral_to_natural = pos
    raw_cores = (fwd_core, inv_core)  # spectral-order, for the batched path

    if config.ordering == "natural":
        perm = jnp.asarray(pos)
        inv_perm_np = np.empty(n, dtype=np.int32)
        inv_perm_np[pos] = np.arange(n, dtype=np.int32)
        inv_perm = jnp.asarray(inv_perm_np)
        raw_fwd, raw_inv = fwd_core, inv_core

        def fwd_core(h, l):  # noqa: F811
            h, l = raw_fwd(h, l)
            return jnp.take(h, perm), jnp.take(l, perm)

        def inv_core(h, l):  # noqa: F811
            return raw_inv(jnp.take(h, inv_perm), jnp.take(l, inv_perm))

    nega_core = None
    if config.negacyclic:
        psi = _dev_limbs(tw.negacyclic_psi_powers(field, n))
        psi_inv = _dev_limbs(tw.negacyclic_psi_powers(field, n, inverse=True))

        def nega_core(ah, al, bh, bl):
            tah, tal = M.gl_mul(ah, al, *psi)
            tbh, tbl = M.gl_mul(bh, bl, *psi)
            ch, cl = polymul_core(tah, tal, tbh, tbl)
            return M.gl_mul(ch, cl, *psi_inv)

    jfwd = jax.jit(lambda hl: fwd_core(*hl))
    jinv = jax.jit(lambda hl: inv_core(*hl))
    jmul = jax.jit(lambda a, b: polymul_core(*a, *b))
    jnega = jax.jit(lambda a, b: nega_core(*a, *b)) if nega_core else None

    def _in(x):
        """Accept a (hi, lo) tuple or a uint64-convertible host array."""
        if isinstance(x, tuple):
            return x, False
        return M.gl_from_u64(np.asarray(x, dtype=np.uint64)), True

    def _out(hl, as_u64):
        return M.gl_to_u64(*hl) if as_u64 else hl

    def _wrap1(fn):
        def call(a):
            hl, u64 = _in(a)
            return _out(fn(hl), u64)

        return call

    def _wrap2(fn):
        def call(a, b):
            ahl, u64a = _in(a)
            bhl, _ = _in(b)
            return _out(fn(ahl, bhl), u64a)

        return call

    def batched_builder(B):
        if make_batched_cores is not None:  # flat split: batch-to-lanes
            bfwd, binv = make_batched_cores(B)
            jgl_mul = jax.jit(M.gl_mul)

            def bmul(ah, al, bh, bl):
                fah, fal = bfwd(ah, al)
                fbh, fbl = bfwd(bh, bl)
                return binv(*jgl_mul(fah, fal, fbh, fbl))

            bnega = None
            if nega_core is not None:
                # psi limb vectors broadcast over the batch
                def bnega(ah, al, bh, bl):
                    tah, tal = jgl_mul(ah, al, *psi)
                    tbh, tbl = jgl_mul(bh, bl, *psi)
                    return jgl_mul(*bmul(tah, tal, tbh, tbl), *psi_inv)
        else:
            # raw (spectral-order) cores: the vmap must NOT pick up the
            # natural-ordering rebinding of fwd_core/inv_core above
            bfwd = jax.jit(jax.vmap(raw_cores[0]))
            binv = jax.jit(jax.vmap(raw_cores[1]))
            bmul = jax.jit(jax.vmap(polymul_core))
            bnega = jax.jit(jax.vmap(nega_core)) if nega_core else None
        if config.ordering == "natural":
            raw_bfwd, raw_binv = bfwd, binv

            def bfwd(h, l):  # noqa: F811
                h, l = raw_bfwd(h, l)
                return jnp.take(h, perm, axis=1), jnp.take(l, perm, axis=1)

            def binv(h, l):  # noqa: F811
                return raw_binv(jnp.take(h, inv_perm, axis=1),
                                jnp.take(l, inv_perm, axis=1))

        out = {
            "fwd": _wrap1(lambda hl: bfwd(*hl)),
            "inv": _wrap1(lambda hl: binv(*hl)),
            "polymul": _wrap2(lambda a, b: bmul(*a, *b)),
        }
        if bnega is not None:
            out["negacyclic_polymul"] = _wrap2(lambda a, b: bnega(*a, *b))
        if n2 > 1:
            out.update(mat_views(out, n1, n2,
                                 spectral=config.ordering == "bitrev"))
        return out

    flat = {"fwd": _wrap1(jfwd), "inv": _wrap1(jinv),
            "polymul": _wrap2(jmul),
            "negacyclic_polymul": _wrap2(jnega) if jnega else None}
    mat_kw = (mat_views(flat, n1, n2, spectral=config.ordering == "bitrev")
              if n2 > 1 else {})
    return Plan(
        config=config,
        fwd=flat["fwd"],
        inv=flat["inv"],
        polymul=flat["polymul"],
        negacyclic_polymul=flat["negacyclic_polymul"],
        spectral_to_natural=spectral_to_natural,
        engine=engine,
        reduction="goldilocks",
        _batched_builder=batched_builder,
        **mat_kw,
    )
