"""Reduction strategies: how butterflies multiply on device.

A Reduction bundles everything the stage loops need:

- ``prepare_table(np_table) -> tuple[np.uint32 arrays]`` — device form of a
  twiddle table (1 array for Barrett/Montgomery, 2 for Harvey: w and the
  Shoup precomputation w' = floor(w * 2^32 / p)).
- ``mul_const(x, *tables)`` — x * w in the strategy's value domain.
- ``add/sub`` — modular add/sub in the value domain.
- ``canonicalize(x)`` — fold the domain to canonical [0, p).
- ``lazy`` — True when the domain is [0, 2p) (Harvey).

Strategies:

- BarrettReduction  — p < 2^14, canonical domain, 1 low mul + shifts
  (the reference's own scheme, src/aie_core.cc:27-39).
- MontgomeryReduction — odd p < 2^31, canonical domain, ~10 muls per
  product (REDC with 16-bit-limb umulhi).
- HarveyReduction  — p < 2^30, lazy [0, 2p) domain, 6 muls per product:
  Shoup's mul-by-constant [q = umulhi(t, w'); r = t*w - q*p in (0, 2p)]
  with Harvey's lazy butterflies (Harvey 2014, "Faster arithmetic for
  number-theoretic transforms"). Each uint32 high product costs four
  16-bit partial products here, so fewer muls beats fancier reductions.
- Harvey4Reduction — p < 2^29, lazy [0, 4p) domain, 5 muls per product:
  the Shoup quotient is computed from only THREE 16-bit partial products
  (hh + lh>>16 + hl>>16, the ll term dropped entirely) with the Shoup
  constant pre-split into hi/lo half tables. The dropped carries
  underestimate q by at most 2, which adds at most 2p to Shoup's [0, 2p)
  remainder — absorbed by widening the lazy domain to [0, 4p) (all
  intermediates still fit uint32 for p < 2^29: butterfly sums < 8p, and
  any x < 2^32 is legal Shoup input). One extra conditional subtract at
  canonicalization pays for ~30% fewer lane-ops on every butterfly
  multiply. Default hot path for p < 2^29 (the headline bench field).

All methods are pure jnp over uint32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import jax.numpy as jnp

from ntt_aie.ops import modops as M


@dataclasses.dataclass(frozen=True)
class Reduction:
    name: str
    p: int
    lazy: bool
    n_tables: int
    prepare_table: Callable  # np int64/object table -> tuple of np.uint32
    mul_const: Callable      # (x, *table_arrays) -> x*w in domain
    mul_data: Callable       # (x, y) canonical inputs -> canonical product
    add: Callable
    sub: Callable
    canonicalize: Callable
    # Optional cheaper a-b whose result may exceed the domain but is legal
    # as mul_const input (Harvey: [0,4p) into Shoup). None = use sub.
    sub_for_mul: Callable | None = None
    # Same for a+b (skip the conditional correction): only legal when the
    # consumer is mul_const. Used by the DIT recursion for subtree outputs
    # that feed the next level's twiddle multiply. None = use add.
    add_for_mul: Callable | None = None
    # Optional variants for FULL-MATRIX constant operands (the four-step
    # wmat/wmid tables, n1 x n2 per table): trade a couple of in-kernel
    # unpack ops for fewer HBM-resident tables. None = use the regular
    # prepare_table/mul_const/n_tables. (Stage twiddle vectors stay on the
    # regular path — they are tiny and their unpacks hoist.)
    n_tables_mat: int | None = None
    prepare_table_mat: Callable | None = None
    mul_const_mat: Callable | None = None

    @property
    def mat_tables(self) -> int:
        return self.n_tables_mat or self.n_tables

    @property
    def prep_mat(self) -> Callable:
        return self.prepare_table_mat or self.prepare_table

    @property
    def mulc_mat(self) -> Callable:
        return self.mul_const_mat or self.mul_const


def make_reduction(kind: str, field) -> Reduction:
    p = field.p

    if kind == "barrett":
        w_, u_ = field.barrett_w, field.barrett_u

        def prep(t):
            return (np.ascontiguousarray(t.astype(np.uint32)),)

        def mulc(x, tw):
            return M.barrett_mul(x, tw, p, w_, u_)

        return Reduction(
            name="barrett", p=p, lazy=False, n_tables=1,
            prepare_table=prep, mul_const=mulc, mul_data=mulc,
            add=lambda a, b: M.add_mod(a, b, p),
            sub=lambda a, b: M.sub_mod(a, b, p),
            canonicalize=lambda x: x,
        )

    if kind == "montgomery":
        neg_pinv = field.mont_neg_pinv
        r = field.mont_r_mod_p
        r2 = field.mont_r2_mod_p

        def prep(t):
            # uint64 vector math is exact here: values < p < 2^31, r < 2^31
            t64 = t.astype(np.uint64)
            return (((t64 * np.uint64(r)) % np.uint64(p)).astype(np.uint32),)

        def mulc(x, tw):
            return M.mont_mul(x, tw, p, neg_pinv)

        def muld(x, y):
            return M.mont_mul(M.mont_mul(x, y, p, neg_pinv), np.uint32(r2), p, neg_pinv)

        return Reduction(
            name="montgomery", p=p, lazy=False, n_tables=1,
            prepare_table=prep, mul_const=mulc, mul_data=muld,
            add=lambda a, b: M.add_mod(a, b, p),
            sub=lambda a, b: M.sub_mod(a, b, p),
            canonicalize=lambda x: x,
        )

    if kind == "harvey":
        if p >= (1 << 30):
            raise ValueError(f"harvey requires p < 2^30, got {p}")
        neg_pinv = field.mont_neg_pinv  # for pointwise products
        r2 = field.mont_r2_mod_p
        p2 = np.uint32(2 * p)
        pc = np.uint32(p)

        def prep(t):
            # w < p < 2^30 so (w << 32) < 2^62 fits uint64 exactly
            t64 = t.astype(np.uint64)
            w = t64.astype(np.uint32)
            w_shoup = ((t64 << np.uint64(32)) // np.uint64(p)).astype(np.uint32)
            return (np.ascontiguousarray(w), np.ascontiguousarray(w_shoup))

        def mulc(x, w, w_shoup):
            # Shoup: q = hi(x * w'); r = x*w - q*p in [0, 2p). Any x < 2^32.
            q = M.umulhi32(x, w_shoup)
            return jnp.asarray(x, jnp.uint32) * jnp.asarray(w, jnp.uint32) - q * pc

        def sub_lazy(a, b):
            # a - b as a value in [0, 4p), NO conditional correction: legal
            # whenever the consumer is mulc (Shoup accepts any x < 2^32).
            # Saves the compare+select of sub() on the butterfly's mul path.
            return jnp.asarray(a, jnp.uint32) + (p2 - b)

        def add_lazy(a, b):
            # a + b in [0, 4p) (< 2^32 for p < 2^30): legal Shoup input.
            return jnp.asarray(a, jnp.uint32) + b

        def muld(x, y):
            # canonical product of possibly-lazy inputs: REDC valid since
            # x*y < 4p^2 < p*2^32 (p < 2^30), then Montgomery-form fixup.
            return M.mont_mul(M.mont_mul(x, y, p, neg_pinv), np.uint32(r2), p, neg_pinv)

        def add(a, b):
            s = jnp.asarray(a, jnp.uint32) + b
            return jnp.where(s >= p2, s - p2, s)

        def sub(a, b):
            d = jnp.asarray(a, jnp.uint32) + (p2 - b)
            return jnp.where(d >= p2, d - p2, d)

        def canon(x):
            return jnp.where(x >= pc, x - pc, x)

        return Reduction(
            name="harvey", p=p, lazy=True, n_tables=2,
            prepare_table=prep, mul_const=mulc, mul_data=muld,
            add=add, sub=sub, canonicalize=canon, sub_for_mul=sub_lazy,
            add_for_mul=add_lazy,
        )

    if kind == "harvey4":
        if p >= (1 << 29):
            raise ValueError(f"harvey4 requires p < 2^29, got {p}")
        neg_pinv = field.mont_neg_pinv  # for pointwise products
        r2 = field.mont_r2_mod_p
        p2 = np.uint32(2 * p)
        p4 = np.uint32(4 * p)
        pc = np.uint32(p)
        mask16 = np.uint32(0xFFFF)

        def prep(t):
            # 3 tables: w and the PRE-SPLIT 16-bit halves of the Shoup
            # constant w' = floor(w * 2^32 / p). Splitting host-side makes
            # the split free even where w varies per element (the
            # four-step wmat multiply).
            t64 = t.astype(np.uint64)
            w = t64.astype(np.uint32)
            ws = (t64 << np.uint64(32)) // np.uint64(p)
            wh = (ws >> np.uint64(16)).astype(np.uint32)
            wl = (ws & np.uint64(0xFFFF)).astype(np.uint32)
            return (np.ascontiguousarray(w), np.ascontiguousarray(wh),
                    np.ascontiguousarray(wl))

        def mulc(x, w, wh, wl):
            # Approximate Shoup: q ~= hi32(x * w') from three 16-bit
            # partials (hh + lh>>16 + hl>>16; the ll product dropped).
            # q underestimates by e in {0,1,2}, so r = x*w - q*p lands in
            # [0, (2+e)p) subset [0, 4p). 5 uint32 muls total.
            x = jnp.asarray(x, jnp.uint32)
            xl = x & mask16
            xh = x >> 16
            q = xh * wh + ((xl * wh) >> 16) + ((xh * wl) >> 16)
            return x * jnp.asarray(w, jnp.uint32) - q * pc

        def sub_lazy(a, b):
            # a - b in [0, 8p) (< 2^32 for p < 2^29): legal Shoup input.
            return jnp.asarray(a, jnp.uint32) + (p4 - b)

        def add_lazy(a, b):
            # a + b in [0, 8p) (< 2^32 for p < 2^29): legal Shoup input.
            return jnp.asarray(a, jnp.uint32) + b

        def muld(x, y):
            # canonical product of possibly-lazy ([0, 4p)) inputs. ONE
            # conditional fold of ONE operand meets the REDC bound: after
            # x -> [0, 2p), x*y < 2p*4p = 8p^2 < p*2^32 for p < 2^29
            # (y stays in [0, 4p) untouched). Was 4 where/selects per
            # element (both operands fully canonicalized); now 1 — the
            # pointwise step sits on the polymul hot path at full n.
            x = jnp.asarray(x, jnp.uint32)
            x = jnp.where(x >= p2, x - p2, x)
            return M.mont_mul(M.mont_mul(x, y, p, neg_pinv), np.uint32(r2), p, neg_pinv)

        def add(a, b):
            s = jnp.asarray(a, jnp.uint32) + b
            return jnp.where(s >= p4, s - p4, s)

        def sub(a, b):
            d = jnp.asarray(a, jnp.uint32) + (p4 - b)
            return jnp.where(d >= p4, d - p4, d)

        def canon(x):
            x = jnp.asarray(x, jnp.uint32)
            x = jnp.where(x >= p2, x - p2, x)
            return jnp.where(x >= pc, x - pc, x)

        def prep_mat(t):
            # Matrix-operand form: w + the two 16-bit Shoup halves PACKED
            # into one uint32 table ((wh << 16) | wl) — 2 HBM tables
            # instead of 3 (the wmat multiply is HBM-bound: measured 72.7
            # vs 34.5 us for the wmat pass vs the plain pass at n=2^20).
            # The unpack costs 2 lane-ops per element in-kernel.
            w, wh, wl = prep(t)
            return (w, np.ascontiguousarray((wh << np.uint32(16)) | wl))

        def mulc_mat(x, w, packed):
            packed = jnp.asarray(packed, jnp.uint32)
            return mulc(x, w, packed >> 16, packed & mask16)

        return Reduction(
            name="harvey4", p=p, lazy=True, n_tables=3,
            prepare_table=prep, mul_const=mulc, mul_data=muld,
            add=add, sub=sub, canonicalize=canon, sub_for_mul=sub_lazy,
            add_for_mul=add_lazy,
            n_tables_mat=2, prepare_table_mat=prep_mat,
            mul_const_mat=mulc_mat,
        )

    raise ValueError(f"unknown reduction kind {kind!r}")


def resolve_kind(config_reduction: str, field) -> str:
    """'auto' prefers the fewest-multiply strategy the prime admits:
    harvey4 (5 muls, p < 2^29) > harvey (6 muls, p < 2^30) > montgomery.
    The ranking is not yet measured on the GPU (ROADMAP)."""
    if config_reduction != "auto":
        return config_reduction
    if field.supports_barrett32:
        return "barrett"
    if field.p < (1 << 29) and field.p % 2 == 1:
        return "harvey4"
    if field.p < (1 << 30) and field.p % 2 == 1:
        return "harvey"
    if field.supports_mont32:
        return "montgomery"
    if field.is_goldilocks:
        return "goldilocks"
    raise ValueError(f"no reduction strategy for p={field.p}")
