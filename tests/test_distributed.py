"""Distributed four-step NTT on the 8-virtual-device CPU mesh.

The reference only ever tested multi-tile behavior on real hardware
(SURVEY.md §4); here the full multi-chip path runs in CI on a virtual mesh,
bit-exact against the single-chip plan."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ntt_aie import fields as F
from ntt_aie import reference as ref
from ntt_aie.config import NTTConfig
from ntt_aie.plan import build_plan
from ntt_aie.parallel.mesh import make_mesh
from ntt_aie.parallel.fourstep import build_distributed_plan


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return make_mesh(8)


def test_distributed_matches_single_chip(mesh8, rng):
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, rows_log2=5, num_shards=8)  # (32, 128)
    a = rng.integers(0, field.p, cfg.n)
    aj = jnp.asarray(a, dtype=jnp.uint32)

    single = build_plan(cfg, engine="xla")
    dist = build_distributed_plan(cfg, mesh8)

    want = np.asarray(single.fwd(aj))
    got = np.asarray(dist.fwd(dist.shard_input(a))).reshape(-1)
    assert np.array_equal(got, want), "distributed fwd != single-chip fwd"


def test_distributed_nested_depth_matches_single_chip(mesh8, rng):
    """Executed at nested column depth (n1 = n2 = 256 rows: the R x S
    column networks): fwd bit-identical to the single-device plan,
    inverse back to the input."""
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=16, rows_log2=8, num_shards=8)
    a = rng.integers(0, field.p, cfg.n)
    dist = build_distributed_plan(cfg, mesh8)
    single = build_plan(cfg, engine="xla")
    spec = dist.fwd(dist.shard_input(a))
    assert np.array_equal(np.asarray(spec).reshape(-1),
                          np.asarray(single.fwd(jnp.asarray(a, jnp.uint32))))
    assert np.array_equal(np.asarray(dist.inv(spec)).reshape(-1), a)


def test_distributed_roundtrip_and_natural(mesh8, rng):
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=13, rows_log2=6, num_shards=8)  # (64, 128)
    a = rng.integers(0, field.p, cfg.n)
    aj = jnp.asarray(a, dtype=jnp.uint32)
    dist = build_distributed_plan(cfg, mesh8)

    n1, n2 = cfg.split
    spec = np.asarray(dist.fwd(dist.shard_input(a)))
    flat = spec.reshape(-1)
    assert np.array_equal(
        flat[dist.spectral_to_natural].astype(np.int64), ref.ntt_forward(a, field)
    )
    back = np.asarray(dist.inv(jnp.asarray(spec, dtype=jnp.uint32))).reshape(-1)
    assert np.array_equal(back, a)


def test_distributed_polymul(mesh8, rng):
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, rows_log2=5, num_shards=8)
    a = rng.integers(0, field.p, cfg.n)
    b = rng.integers(0, field.p, cfg.n)
    dist = build_distributed_plan(cfg, mesh8)
    got = np.asarray(
        dist.polymul(dist.shard_input(a), dist.shard_input(b))
    ).reshape(-1)
    want = ref.cyclic_polymul(a, b, field)
    assert np.array_equal(got.astype(np.int64), want)


def test_distributed_montgomery_field(mesh8, rng):
    field = F.P_2013265921
    cfg = NTTConfig(field=field, log_n=12, rows_log2=5, num_shards=8)
    a = rng.integers(0, field.p, cfg.n)
    aj = jnp.asarray(a, dtype=jnp.uint32)
    dist = build_distributed_plan(cfg, mesh8)
    single = build_plan(cfg, engine="xla")
    assert np.array_equal(
        np.asarray(dist.fwd(dist.shard_input(a))).reshape(-1), np.asarray(single.fwd(aj))
    )


def test_pairwise_stage_matches_butterfly(mesh8, rng):
    """The reference-style ppermute pairwise exchange (comparison mode) for
    one global stage. Two parts: a CONSTANT twiddle (37) isolating the
    exchange + butterfly mechanics, then a random full-length table sharded
    P("x") checking per-shard twiddle-SLICE routing (each device multiplies
    by its own position-dependent slice). The full multi-stage composition
    is covered by test_pairwise_full_ntt_matches_oracle."""
    from ntt_aie.parallel.fourstep import pairwise_global_stage
    from ntt_aie.ops.reductions import make_reduction
    from jax.sharding import PartitionSpec as P

    field = F.P_469762049
    red = make_reduction("harvey", field)
    D = 8
    m = 128  # elements per shard
    n = D * m
    a = rng.integers(0, field.p, n).astype(np.uint32)
    # stage 0: stride n/2 -> device d pairs with d ^ 4
    wv = np.full((m,), 37, dtype=np.int64)
    w_t = tuple(jnp.asarray(t) for t in red.prepare_table(wv))

    def body(xl, *wt):
        return red.canonicalize(
            pairwise_global_stage(xl, 0, D, "x", wt, red)
        )

    f = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh8,
            in_specs=(P("x"),) + (P(None),) * len(w_t),
            out_specs=P("x"),
        )
    )
    got = np.asarray(f(jnp.asarray(a), *w_t))
    # expected: GS butterfly with stride n/2, twiddle 37
    u = a[: n // 2].astype(np.int64)
    v = a[n // 2 :].astype(np.int64)
    want = np.concatenate([(u + v) % field.p, (u - v) % field.p * 37 % field.p])
    assert np.array_equal(got.astype(np.int64), want)

    # and with REAL per-shard twiddle-slice routing: a random full-length
    # table sharded P("x") hands each device exactly its own m-slice, so
    # upper-half outputs multiply by position-dependent twiddles
    wv_full = rng.integers(1, field.p, n).astype(np.int64)
    w_full_t = tuple(jnp.asarray(t) for t in red.prepare_table(wv_full))
    f2 = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh8,
            in_specs=(P("x"),) + (P("x"),) * len(w_full_t),
            out_specs=P("x"),
        )
    )
    got2 = np.asarray(f2(jnp.asarray(a), *w_full_t))
    want2 = np.concatenate(
        [(u + v) % field.p,
         (u - v) % field.p * wv_full[n // 2:] % field.p])
    assert np.array_equal(got2.astype(np.int64), want2)


def test_distributed_2d_mesh_dp_batch(rng):
    """2D mesh: batch sharded over 'dp', coefficients over 'x'."""
    from ntt_aie.parallel.mesh import make_mesh_2d

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = make_mesh_2d(2, 4)
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, rows_log2=5, num_shards=4)
    B = 4
    a = rng.integers(0, field.p, (B, cfg.n))
    dist = build_distributed_plan(cfg, mesh, dp_axis="dp")
    single = build_plan(cfg, engine="xla")
    out = np.asarray(dist.fwd(dist.shard_input(a)))
    for i in range(B):
        want = np.asarray(single.fwd(jnp.asarray(a[i], dtype=jnp.uint32)))
        assert np.array_equal(out[i].reshape(-1), want), f"batch row {i}"
    back = np.asarray(dist.inv(jnp.asarray(out, dtype=jnp.uint32)))
    assert np.array_equal(back.reshape(B, -1), a)


def test_goldilocks_distributed_fourstep(rng):
    """64-bit prime four-step over the virtual mesh: bit-exact vs the
    single-chip GL plan and roundtrip."""
    import jax
    from jax.sharding import Mesh

    from ntt_aie import fields as F
    from ntt_aie.api import NTTContext
    from ntt_aie.config import NTTConfig
    from ntt_aie.ops import modops as M
    from ntt_aie.parallel.fourstep import build_gl_distributed_plan

    GL = F.GOLDILOCKS
    cfg = NTTConfig(field=GL, log_n=10, rows_log2=5, num_shards=4)
    mesh = Mesh(np.array(jax.devices()[:4]), (cfg.mesh_axis,))
    plan = build_gl_distributed_plan(cfg, mesh)
    v = rng.integers(0, 1 << 63, cfg.n, dtype=np.uint64) % np.uint64(GL.p)

    hl = plan.shard_input(v)
    fh, fl = plan.fwd(hl)
    flat = M.gl_to_u64(np.asarray(fh).reshape(-1), np.asarray(fl).reshape(-1))

    single = NTTContext(NTTConfig(field=GL, log_n=10, rows_log2=5))
    want = np.asarray(single.forward(v))
    assert np.array_equal(flat, want)

    bh, bl = plan.inv((fh, fl))
    back = M.gl_to_u64(np.asarray(bh).reshape(-1), np.asarray(bl).reshape(-1))
    assert np.array_equal(back, v)

    b = rng.integers(0, 1 << 63, cfg.n, dtype=np.uint64) % np.uint64(GL.p)
    ch, cl = plan.polymul(plan.shard_input(v), plan.shard_input(b))
    got = M.gl_to_u64(np.asarray(ch).reshape(-1), np.asarray(cl).reshape(-1))
    from ntt_aie import reference as ref
    want_p = ref.schoolbook_cyclic(v.astype(object), b.astype(object), GL.p)
    assert np.array_equal(got.astype(object), want_p.astype(object))


def test_pairwise_full_ntt_matches_oracle(mesh8, rng):
    """The complete reference-topology mode: log2(D) pairwise exchange
    stages + local stages == the scalar DIF oracle, bit-exact."""
    from ntt_aie.parallel.fourstep import build_pairwise_plan

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=10, num_shards=8)
    fwd, in_sh = build_pairwise_plan(cfg, mesh8)
    a = rng.integers(0, field.p, cfg.n)
    got = np.asarray(fwd(jax.device_put(a.astype(np.uint32), in_sh)))
    want = ref.ntt_dif(a, field)
    assert np.array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("chunks", [2, 4])
def test_overlap_chunked_transpose_bit_exact(mesh8, rng, chunks):
    """overlap_chunks > 1 (chunked all_to_all riding ICI while local
    passes compute) is bit-identical to the monolithic collective, both
    directions, and to the single-chip plan."""
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=13, rows_log2=6, num_shards=8)  # (64, 128)
    a = rng.integers(0, field.p, cfg.n)
    mono = build_distributed_plan(cfg, mesh8)
    over = build_distributed_plan(cfg, mesh8,
                                  overlap_chunks=chunks)
    single = build_plan(cfg, engine="xla")

    want = np.asarray(mono.fwd(mono.shard_input(a)))
    got = np.asarray(over.fwd(over.shard_input(a)))
    assert np.array_equal(got, want), "chunked fwd != monolithic fwd"
    assert np.array_equal(
        got.reshape(-1), np.asarray(single.fwd(jnp.asarray(a, dtype=jnp.uint32)))
    )
    back = np.asarray(over.inv(jnp.asarray(got, dtype=jnp.uint32))).reshape(-1)
    assert np.array_equal(back, a), "chunked inverse roundtrip failed"

    b = rng.integers(0, field.p, cfg.n)
    got_p = np.asarray(
        over.polymul(over.shard_input(a), over.shard_input(b))
    ).reshape(-1)
    want_p = ref.cyclic_polymul(a, b, field)
    assert np.array_equal(got_p.astype(np.int64), want_p)


def test_distributed_negacyclic_polymul(mesh8, rng):
    """X^n + 1 product on the distributed plan (psi pre-scale fused into
    pass 1, psi^-1 post-scale fused into the last inverse pass) vs the
    schoolbook oracle — monolithic and chunked-overlap, plus Montgomery."""
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, rows_log2=5, num_shards=8,
                    negacyclic=True)
    a = rng.integers(0, field.p, cfg.n)
    b = rng.integers(0, field.p, cfg.n)
    want = ref.schoolbook_negacyclic(a, b, field.p)
    for C in (1, 2):
        plan = build_distributed_plan(cfg, mesh8,
                                      overlap_chunks=C)
        got = np.asarray(plan.negacyclic_polymul(
            plan.shard_input(a), plan.shard_input(b))).reshape(-1)
        assert np.array_equal(got.astype(np.int64), want), f"C={C}"
    # non-negacyclic plans expose no negacyclic_polymul
    plain = build_distributed_plan(
        NTTConfig(field=field, log_n=12, rows_log2=5, num_shards=8),
        mesh8)
    assert plain.negacyclic_polymul is None

    fm = F.P_2013265921
    cfgm = NTTConfig(field=fm, log_n=12, rows_log2=5, num_shards=8,
                     negacyclic=True)
    planm = build_distributed_plan(cfgm, mesh8)
    am = rng.integers(0, fm.p, cfgm.n)
    bm = rng.integers(0, fm.p, cfgm.n)
    gotm = np.asarray(planm.negacyclic_polymul(
        planm.shard_input(am), planm.shard_input(bm))).reshape(-1)
    assert np.array_equal(gotm.astype(np.int64),
                          ref.schoolbook_negacyclic(am, bm, fm.p))


def test_goldilocks_distributed_overlap_and_negacyclic(rng):
    """GL distributed plan: chunked-overlap transpose is bit-identical to
    monolithic, and the negacyclic product matches the schoolbook oracle
    (object-int) in both modes."""
    from jax.sharding import Mesh

    from ntt_aie.ops import modops as M
    from ntt_aie.parallel.fourstep import build_gl_distributed_plan

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    GL = F.GOLDILOCKS
    cfg = NTTConfig(field=GL, log_n=10, rows_log2=5, num_shards=4,
                    negacyclic=True)
    mesh = Mesh(np.array(jax.devices()[:4]), (cfg.mesh_axis,))
    v = rng.integers(0, 1 << 63, cfg.n, dtype=np.uint64) % np.uint64(GL.p)
    b = rng.integers(0, 1 << 63, cfg.n, dtype=np.uint64) % np.uint64(GL.p)
    mono = build_gl_distributed_plan(cfg, mesh)
    over = build_gl_distributed_plan(cfg, mesh, overlap_chunks=2)
    f1 = mono.fwd(mono.shard_input(v))
    f2 = over.fwd(over.shard_input(v))
    assert np.array_equal(np.asarray(f1[0]), np.asarray(f2[0]))
    assert np.array_equal(np.asarray(f1[1]), np.asarray(f2[1]))
    bh, bl = over.inv(f2)
    assert np.array_equal(
        M.gl_to_u64(np.asarray(bh).reshape(-1), np.asarray(bl).reshape(-1)), v)
    want = ref.schoolbook_negacyclic(v.astype(object), b.astype(object), GL.p)
    for plan in (mono, over):
        ch, cl = plan.negacyclic_polymul(plan.shard_input(v),
                                         plan.shard_input(b))
        got = M.gl_to_u64(np.asarray(ch).reshape(-1),
                          np.asarray(cl).reshape(-1))
        assert np.array_equal(got.astype(object), want.astype(object))


def test_distributed_wmat_factored_matches_full(mesh8, rng):
    """wmat_factored distributed plans (sqrt-size twiddle tables riding
    pass 2, on the far side of the transpose collective) are bit-identical
    to the full-matrix plans: fwd, inverse roundtrip, polymul — monolithic
    and chunked-overlap."""
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, rows_log2=5, num_shards=8)
    a = rng.integers(0, field.p, cfg.n)
    b = rng.integers(0, field.p, cfg.n)
    kwargs = {}
    # wmat_factored=False: the distributed default flipped to factored in
    # round 4, so the full-matrix comparison side must ask for it.
    full = build_distributed_plan(cfg, mesh8, wmat_factored=False, **kwargs)
    assert not full.wmat_factored
    # the default (None) resolves to factored for distributed plans
    assert build_distributed_plan(cfg, mesh8, **kwargs).wmat_factored
    want = np.asarray(full.fwd(full.shard_input(a)))
    for C in (1, 2):
        fac = build_distributed_plan(cfg, mesh8, wmat_factored=True,
                                     overlap_chunks=C, **kwargs)
        got = np.asarray(fac.fwd(fac.shard_input(a)))
        assert np.array_equal(got, want), f"C={C} fwd"
        back = np.asarray(
            fac.inv(jnp.asarray(got, dtype=jnp.uint32))).reshape(-1)
        assert np.array_equal(back, a), f"C={C} roundtrip"
    got_p = np.asarray(
        fac.polymul(fac.shard_input(a), fac.shard_input(b))).reshape(-1)
    assert np.array_equal(got_p.astype(np.int64),
                          ref.cyclic_polymul(a, b, field))


def test_distributed_wmat_factored_negacyclic_and_montgomery(mesh8, rng):
    """Factored mode with rank-1 psi operands (negacyclic) and in the
    Montgomery field: bit-exact vs the schoolbook oracle / full plan."""
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, rows_log2=5, num_shards=8,
                    negacyclic=True)
    a = rng.integers(0, field.p, cfg.n)
    b = rng.integers(0, field.p, cfg.n)
    want = ref.schoolbook_negacyclic(a, b, field.p)
    plan = build_distributed_plan(cfg, mesh8, wmat_factored=True)
    got = np.asarray(plan.negacyclic_polymul(
        plan.shard_input(a), plan.shard_input(b))).reshape(-1)
    assert np.array_equal(got.astype(np.int64), want)

    fm = F.P_2013265921
    cfgm = NTTConfig(field=fm, log_n=12, rows_log2=5, num_shards=8)
    am = rng.integers(0, fm.p, cfgm.n)
    bm = rng.integers(0, fm.p, cfgm.n)
    planm = build_distributed_plan(cfgm, mesh8,
                                   wmat_factored=True)
    gotm = np.asarray(planm.polymul(planm.shard_input(am),
                                    planm.shard_input(bm))).reshape(-1)
    assert np.array_equal(gotm.astype(np.int64),
                          ref.cyclic_polymul(am, bm, fm))


def test_nttcontext_distributed(mesh8, rng):
    """NTTContext(config, mesh=...) drives the distributed plan through
    the single-chip API surface: flat host vectors are placed
    automatically, sharded device arrays pass through."""
    from ntt_aie.api import NTTContext

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, rows_log2=5, num_shards=8,
                    negacyclic=True)
    ctx = NTTContext(cfg, mesh=mesh8, wmat_factored=True,
                     overlap_chunks=2)
    a = rng.integers(0, field.p, cfg.n)
    b = rng.integers(0, field.p, cfg.n)
    spec = ctx.forward(a)                      # host vector in
    got = np.asarray(spec).reshape(-1)
    assert np.array_equal(
        got[ctx.plan.spectral_to_natural].astype(np.int64),
        ref.ntt_forward(a, field))
    back = np.asarray(ctx.inverse(spec)).reshape(-1)   # sharded pass-through
    assert np.array_equal(back, a)
    back2 = np.asarray(ctx.inverse(got)).reshape(-1)   # flat host spectral
    assert np.array_equal(back2, a)
    gp = np.asarray(ctx.polymul(a, b)).reshape(-1)
    assert np.array_equal(gp.astype(np.int64), ref.cyclic_polymul(a, b, field))
    gn = np.asarray(ctx.negacyclic_polymul(a, b)).reshape(-1)
    assert np.array_equal(gn.astype(np.int64),
                          ref.schoolbook_negacyclic(a, b, field.p))
    # distributed-only kwargs without mesh are a loud error, not silently
    # ignored (single-chip knobs like wmat_factored/engine forward to
    # build_plan since round 3 — see
    # test_plan.py::test_context_single_chip_plan_kwargs)
    with pytest.raises(TypeError, match="need mesh="):
        NTTContext(cfg, overlap_chunks=2)


def test_nttcontext_distributed_ordering(mesh8, rng):
    """config.ordering must be honored by the mesh= path exactly like the
    single-chip wrappers (CLAUDE.md invariant): ordering='natural' returns
    and accepts flat natural-order vectors; the reference parity
    conventions are single-chip-only and raise loudly."""
    from ntt_aie.api import NTTContext

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, rows_log2=5, num_shards=8,
                    ordering="natural")
    ctx = NTTContext(cfg, mesh=mesh8)
    a = rng.integers(0, field.p, cfg.n)
    spec = np.asarray(ctx.forward(a))
    assert spec.shape == (cfg.n,)
    assert np.array_equal(spec.astype(np.int64), ref.ntt_forward(a, field))
    # device path must agree with the host-oracle path under the SAME config
    assert np.array_equal(spec, ctx.forward_host(a))
    back = np.asarray(ctx.inverse(spec)).reshape(-1)
    assert np.array_equal(back, a)

    with pytest.raises(NotImplementedError):
        NTTContext(NTTConfig(field=F.KYBER, log_n=11,
                             table_convention="reference"), mesh=mesh8)
    with pytest.raises(NotImplementedError):
        NTTContext(cfg, mesh=mesh8, dp_axis="dp")


def test_nttcontext_distributed_goldilocks(mesh8, rng):
    """NTTContext(mesh=) with the 64-bit Goldilocks field routes to the
    limb-pair distributed builder with the single-chip GL conventions:
    uint64 host vectors are split/placed automatically (and returned as
    uint64), device limb pairs pass through, and config.ordering is
    honored."""
    from ntt_aie.api import NTTContext

    GL = F.GOLDILOCKS
    cfg = NTTConfig(field=GL, log_n=10, rows_log2=5, num_shards=8,
                    negacyclic=True)
    ctx = NTTContext(cfg, mesh=mesh8, overlap_chunks=2)
    a = rng.integers(0, GL.p, cfg.n, dtype=np.uint64)
    b = rng.integers(0, GL.p, cfg.n, dtype=np.uint64)

    spec = ctx.forward(a)                       # uint64 in -> uint64 out
    got = np.asarray(spec).reshape(-1)
    want = ref.ntt_forward(a.astype(object), GL)
    assert np.array_equal(got[ctx.plan.spectral_to_natural].astype(object),
                          want)
    back = np.asarray(ctx.inverse(spec)).reshape(-1)   # device passthrough
    assert np.array_equal(back, a)
    gp = np.asarray(ctx.polymul(a, b)).reshape(-1)
    assert np.array_equal(gp.astype(object),
                          ref.cyclic_polymul(a.astype(object),
                                             b.astype(object), GL))
    gn = np.asarray(ctx.negacyclic_polymul(a, b)).reshape(-1)
    assert np.array_equal(gn.astype(object),
                          ref.schoolbook_negacyclic(a.astype(object),
                                                    b.astype(object), GL.p))

    # natural ordering: flat natural-order uint64 vectors both ways
    nctx = NTTContext(NTTConfig(field=GL, log_n=10, rows_log2=5,
                                num_shards=8, ordering="natural"),
                      mesh=mesh8)
    nspec = np.asarray(nctx.forward(a))
    assert nspec.shape == (cfg.n,)
    assert np.array_equal(nspec.astype(object), want)
    assert np.array_equal(np.asarray(nctx.inverse(nspec)).reshape(-1), a)

    # unsupported plan kwargs are a loud error (wmat_factored became a
    # supported GL kwarg in round 4; dp_axis stays context-unsupported)
    with pytest.raises(TypeError):
        NTTContext(cfg, mesh=mesh8, dp_axis="dp").plan


def test_goldilocks_distributed_dp_axis(rng):
    """GL 2D mesh: batch sharded over 'dp', coefficients over 'x' — the
    DP x coeff composition for the 64-bit field, bit-exact vs the
    single-chip GL plan per batch row, plus roundtrip and negacyclic."""
    import jax

    from ntt_aie.parallel.fourstep import build_gl_distributed_plan
    from ntt_aie.parallel.mesh import make_mesh_2d
    from ntt_aie.plan import build_plan

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = make_mesh_2d(2, 4)
    GL = F.GOLDILOCKS
    cfg = NTTConfig(field=GL, log_n=10, rows_log2=5, num_shards=4,
                    negacyclic=True)
    B = 4
    a = rng.integers(0, GL.p, (B, cfg.n), dtype=np.uint64)
    b = rng.integers(0, GL.p, (B, cfg.n), dtype=np.uint64)
    dist = build_gl_distributed_plan(cfg, mesh, dp_axis="dp")
    single = build_plan(cfg)
    out = dist.fwd(dist.shard_input(a))
    oh, ol = (np.asarray(x) for x in out)
    got = (oh.astype(np.uint64) << np.uint64(32)) | ol.astype(np.uint64)
    for i in range(B):
        want = np.asarray(single.fwd(a[i]))
        assert np.array_equal(got[i].reshape(-1), want), f"batch row {i}"
    back = dist.inv(out)
    bh, bl = (np.asarray(x) for x in back)
    v = (bh.astype(np.uint64) << np.uint64(32)) | bl.astype(np.uint64)
    assert np.array_equal(v.reshape(B, -1), a)
    nh, nl = dist.negacyclic_polymul(dist.shard_input(a),
                                     dist.shard_input(b))
    nv = ((np.asarray(nh).astype(np.uint64) << np.uint64(32))
          | np.asarray(nl).astype(np.uint64)).reshape(B, -1)
    for i in range(B):
        assert np.array_equal(
            nv[i].astype(object),
            ref.schoolbook_negacyclic(a[i].astype(object),
                                      b[i].astype(object), GL.p)), i


def test_hierarchical_transpose_bit_exact(rng):
    """hier_axes=(major, minor): the two-phase DCN x ICI transpose
    decomposition (send-side regroup + per-tier all_to_alls) must be
    bit-identical to the flat single-axis plan — fwd, inverse roundtrip,
    an asymmetric (4, 2) grid, and composition with overlap_chunks."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from ntt_aie.parallel.mesh import make_mesh_hier

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=13, rows_log2=6, num_shards=8)  # (64,128)
    a = rng.integers(0, field.p, cfg.n)
    flat = build_distributed_plan(cfg, make_mesh(8))
    want = np.asarray(flat.fwd(flat.shard_input(a))).reshape(-1)

    for G, L in ((2, 4), (4, 2)):
        mesh = make_mesh_hier(G, L)
        hier = build_distributed_plan(cfg, mesh,
                                      hier_axes=("dcn", "ici"))
        spec = hier.fwd(hier.shard_input(a))
        assert np.array_equal(np.asarray(spec).reshape(-1), want), (G, L)
        back = np.asarray(hier.inv(spec)).reshape(-1)
        assert np.array_equal(back, a), (G, L)

    # hier + chunked overlap compose: each chunk's collective decomposes
    mesh = make_mesh_hier(2, 4)
    hc = build_distributed_plan(cfg, mesh,
                                hier_axes=("dcn", "ici"), overlap_chunks=2)
    assert np.array_equal(np.asarray(hc.fwd(hc.shard_input(a))).reshape(-1),
                          want)
    back = np.asarray(hc.inv(hc.shard_spectral(want))).reshape(-1)
    assert np.array_equal(back, a)


def test_hierarchical_negacyclic_and_wfac(rng):
    """Hierarchical mesh with the factored-twiddle + negacyclic plan: the
    psi rank-1 operands and wfac lane shards ride the two-level specs."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from ntt_aie.parallel.mesh import make_mesh_hier

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, rows_log2=5, num_shards=8,
                    negacyclic=True)
    a = rng.integers(0, field.p, cfg.n)
    b = rng.integers(0, field.p, cfg.n)
    flat = build_distributed_plan(cfg, make_mesh(8))
    want = np.asarray(
        flat.negacyclic_polymul(flat.shard_input(a), flat.shard_input(b))
    ).reshape(-1)
    mesh = make_mesh_hier(2, 4)
    hier = build_distributed_plan(cfg, mesh,
                                  hier_axes=("dcn", "ici"),
                                  wmat_factored=True)
    got = np.asarray(
        hier.negacyclic_polymul(hier.shard_input(a), hier.shard_input(b))
    ).reshape(-1)
    assert np.array_equal(got, want)


def test_goldilocks_hierarchical(rng):
    """GL limb-pair plan over a hierarchical mesh == flat GL plan."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from ntt_aie.parallel.fourstep import build_gl_distributed_plan
    from ntt_aie.parallel.mesh import make_mesh_hier

    GL = F.GOLDILOCKS
    cfg = NTTConfig(field=GL, log_n=12, rows_log2=6, num_shards=8)
    a = rng.integers(0, GL.p, cfg.n, dtype=np.uint64)
    flat = build_gl_distributed_plan(cfg, make_mesh(8))
    fh, fl = (np.asarray(x) for x in flat.fwd(flat.shard_input(a)))
    want = (fh.astype(np.uint64) << np.uint64(32)) | fl.astype(np.uint64)
    mesh = make_mesh_hier(2, 4)
    hier = build_gl_distributed_plan(cfg, mesh, hier_axes=("dcn", "ici"),
                                     overlap_chunks=2)
    out = hier.fwd(hier.shard_input(a))
    gh, gl_ = (np.asarray(x) for x in out)
    got = (gh.astype(np.uint64) << np.uint64(32)) | gl_.astype(np.uint64)
    assert np.array_equal(got, want)
    bh, bl = (np.asarray(x) for x in hier.inv(out))
    back = (bh.astype(np.uint64) << np.uint64(32)) | bl.astype(np.uint64)
    assert np.array_equal(back.reshape(-1), a)


def test_hierarchical_with_dp_batch(rng):
    """3-axis mesh (dp x dcn x ici): data-parallel batch composed with the
    hierarchical two-phase transpose — bit-exact vs the single-chip plan
    per batch row."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:8]).reshape(2, 2, 2)
    mesh = Mesh(devs, ("dp", "dcn", "ici"))
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, rows_log2=6, num_shards=4)  # (64,64)
    B = 4
    ab = rng.integers(0, field.p, (B, cfg.n))
    dist = build_distributed_plan(cfg, mesh, dp_axis="dp",
                                  hier_axes=("dcn", "ici"))
    single = build_plan(cfg, engine="xla")
    got = np.asarray(dist.fwd(dist.shard_input(ab)))
    for i in range(B):
        want = np.asarray(single.fwd(jnp.asarray(ab[i], dtype=jnp.uint32)))
        assert np.array_equal(got[i].reshape(-1), want), f"batch row {i}"
    back = np.asarray(dist.inv(jnp.asarray(got))).reshape(B, -1)
    assert np.array_equal(back, ab)


def test_goldilocks_hier_through_nttcontext(rng):
    """NTTContext(mesh=..., hier_axes=...) must route hier to the GL
    builder too (the kwargs allowlist once rejected it)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from ntt_aie.api import NTTContext
    from ntt_aie.parallel.mesh import make_mesh_hier

    GL = F.GOLDILOCKS
    cfg = NTTConfig(field=GL, log_n=12, rows_log2=6, num_shards=8)
    ctx = NTTContext(cfg, mesh=make_mesh_hier(2, 4),
                     hier_axes=("dcn", "ici"))
    flat = NTTContext(cfg, mesh=make_mesh(8))
    v = rng.integers(0, GL.p, cfg.n, dtype=np.uint64)
    got = np.asarray(ctx.forward(v))
    want = np.asarray(flat.forward(v))
    assert np.array_equal(got, want)


def test_dp_batched_overlap_chunks(rng):
    """Chunked transpose overlap in the dp-BATCHED bodies (32-bit and
    Goldilocks): bit-identical to the monolithic batched plan, composed
    with hier on a 3-axis mesh for the 32-bit case."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from jax.sharding import Mesh

    from ntt_aie.parallel.fourstep import build_gl_distributed_plan
    from ntt_aie.parallel.mesh import make_mesh_2d

    field = F.P_469762049
    mesh = make_mesh_2d(2, 4)
    cfg = NTTConfig(field=field, log_n=12, rows_log2=6, num_shards=4)  # (64,64)
    B = 4
    ab = rng.integers(0, field.p, (B, cfg.n))
    mono = build_distributed_plan(cfg, mesh, dp_axis="dp")
    chk = build_distributed_plan(cfg, mesh, dp_axis="dp",
                                 overlap_chunks=2)
    want = np.asarray(mono.fwd(mono.shard_input(ab)))
    spec = chk.fwd(chk.shard_input(ab))
    assert np.array_equal(np.asarray(spec), want)
    back = np.asarray(chk.inv(spec)).reshape(B, -1)
    assert np.array_equal(back, ab)

    # 3-axis: dp x (dcn x ici) with chunks
    devs = np.array(jax.devices()[:8]).reshape(2, 2, 2)
    mesh3 = Mesh(devs, ("dp", "dcn", "ici"))
    h3 = build_distributed_plan(cfg, mesh3, dp_axis="dp",
                                hier_axes=("dcn", "ici"), overlap_chunks=2)
    assert np.array_equal(np.asarray(h3.fwd(h3.shard_input(ab))), want)

    # Goldilocks batched chunked
    GL = F.GOLDILOCKS
    cfgg = NTTConfig(field=GL, log_n=10, rows_log2=5, num_shards=4,
                     negacyclic=True)
    vb = rng.integers(0, GL.p, (B, cfgg.n), dtype=np.uint64)
    wb = rng.integers(0, GL.p, (B, cfgg.n), dtype=np.uint64)
    gmono = build_gl_distributed_plan(cfgg, mesh, dp_axis="dp")
    gchk = build_gl_distributed_plan(cfgg, mesh, dp_axis="dp",
                                     overlap_chunks=2)

    def _u64(pair):
        h, l = (np.asarray(x) for x in pair)
        return (h.astype(np.uint64) << np.uint64(32)) | l.astype(np.uint64)

    gw = _u64(gmono.fwd(gmono.shard_input(vb)))
    gs = gchk.fwd(gchk.shard_input(vb))
    assert np.array_equal(_u64(gs), gw)
    assert np.array_equal(_u64(gchk.inv(gs)).reshape(B, -1), vb)
    assert np.array_equal(
        _u64(gchk.negacyclic_polymul(gchk.shard_input(vb),
                                     gchk.shard_input(wb))),
        _u64(gmono.negacyclic_polymul(gmono.shard_input(vb),
                                      gmono.shard_input(wb))))


def test_compiled_collective_structure(rng):
    """Compile-level regression: the lowered HLO carries exactly the
    collectives the plan promises — 1 all_to_all per transform flat,
    C with overlap_chunks=C, 2 per transform hierarchical (one per
    network tier). Guards against a refactor silently collapsing or
    duplicating the collective schedule."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from ntt_aie.parallel.mesh import make_mesh_hier

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, rows_log2=6, num_shards=8)

    def a2a_count(plan):
        x = jax.ShapeDtypeStruct((64, 64), jnp.uint32,
                                 sharding=plan.in_sharding)
        txt = plan.fwd.lower(x).compile().as_text()
        return txt.count("all-to-all(") + txt.count("all-to-all-start(")

    flat = build_distributed_plan(cfg, make_mesh(8))
    assert a2a_count(flat) == 1
    chunked = build_distributed_plan(cfg, make_mesh(8),
                                     overlap_chunks=2)
    assert a2a_count(chunked) == 2
    hier = build_distributed_plan(cfg, make_mesh_hier(2, 4),
                                  hier_axes=("dcn", "ici"))
    assert a2a_count(hier) == 2
    hier_c = build_distributed_plan(cfg, make_mesh_hier(2, 4),
                                    hier_axes=("dcn", "ici"),
                                    overlap_chunks=2)
    assert a2a_count(hier_c) == 4


def test_gl_distributed_wmat_factored_matches_full(mesh8, rng):
    """GL distributed factored mode (round 4): sqrt-size limb tables ride
    pass 2 on the far side of the collective; default (None) resolves to
    factored; outputs bit-identical to the full-matrix plan."""
    from ntt_aie.ops import modops as M
    from ntt_aie.parallel.fourstep import build_gl_distributed_plan

    GLF = F.GOLDILOCKS
    cfg = NTTConfig(field=GLF, log_n=10, rows_log2=5, num_shards=8)
    kw = {}
    v = rng.integers(0, 1 << 63, cfg.n, dtype=np.uint64) % np.uint64(GLF.p)
    full = build_gl_distributed_plan(cfg, mesh8, wmat_factored=False, **kw)
    assert not full.wmat_factored
    fh, fl = full.fwd(full.shard_input(v))
    want = M.gl_to_u64(np.asarray(fh).reshape(-1), np.asarray(fl).reshape(-1))
    for C in (1, 2):
        fac = build_gl_distributed_plan(cfg, mesh8, overlap_chunks=C, **kw)
        assert fac.wmat_factored  # the distributed default is factored
        gh, gl_ = fac.fwd(fac.shard_input(v))
        got = M.gl_to_u64(np.asarray(gh).reshape(-1),
                          np.asarray(gl_).reshape(-1))
        assert np.array_equal(got, want), f"C={C} fwd"
        bh, bl = fac.inv((gh, gl_))
        back = M.gl_to_u64(np.asarray(bh).reshape(-1),
                           np.asarray(bl).reshape(-1))
        assert np.array_equal(back, v), f"C={C} roundtrip"


def test_gl_distributed_factored_negacyclic(mesh8, rng):
    """GL factored negacyclic: rank-1 psi limb operands vs the schoolbook
    oracle."""
    from ntt_aie.ops import modops as M
    from ntt_aie.parallel.fourstep import build_gl_distributed_plan

    GLF = F.GOLDILOCKS
    cfg = NTTConfig(field=GLF, log_n=8, rows_log2=4, num_shards=8,
                    negacyclic=True)
    a = rng.integers(0, 1 << 63, cfg.n, dtype=np.uint64) % np.uint64(GLF.p)
    b = rng.integers(0, 1 << 63, cfg.n, dtype=np.uint64) % np.uint64(GLF.p)
    want = ref.schoolbook_negacyclic(a.astype(object), b.astype(object),
                                     GLF.p)
    plan = build_gl_distributed_plan(cfg, mesh8,
                                     wmat_factored=True)
    ch, cl = plan.negacyclic_polymul(plan.shard_input(a),
                                     plan.shard_input(b))
    got = M.gl_to_u64(np.asarray(ch).reshape(-1), np.asarray(cl).reshape(-1))
    assert np.array_equal(got.astype(object), want.astype(object))
