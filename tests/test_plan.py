"""Device-plan tests (XLA path on CPU backend): bit-exact vs NumPy oracle."""

import numpy as np
import pytest
import jax.numpy as jnp

from ntt_aie import fields as F
from ntt_aie import reference as ref
from ntt_aie import twiddles as tw
from ntt_aie.config import NTTConfig
from ntt_aie.api import NTTContext


@pytest.mark.parametrize("field,red", [(F.KYBER, "barrett"), (F.P_2013265921, "montgomery")])
@pytest.mark.parametrize("log_n", [4, 8])
def test_flat_forward_matches_oracle(field, red, log_n, rng):
    if field.max_n < (1 << log_n):
        pytest.skip("n too big for field")
    cfg = NTTConfig(field=field, log_n=log_n, reduction=red, rows_log2=log_n)
    ctx = NTTContext(cfg)
    a = rng.integers(0, field.p, cfg.n)
    got = np.asarray(ctx.forward(jnp.asarray(a, dtype=jnp.uint32)))
    want = ref.ntt_dif(a, field)  # flat path spectral order == bitrev == DIF order
    assert np.array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("log_n,rows_log2", [(8, 3), (10, 5), (12, 5), (14, 7)])
def test_fourstep_forward_spectral_order(log_n, rows_log2, rng):
    field = F.P_2013265921
    cfg = NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2)
    ctx = NTTContext(cfg)
    a = rng.integers(0, field.p, cfg.n)
    flat = np.asarray(ctx.forward(jnp.asarray(a, dtype=jnp.uint32)))
    # X[k] = flat[pos[k]]
    pos = ctx.plan.spectral_to_natural
    want_natural = ref.ntt_forward(a, field)  # natural order ground truth
    assert np.array_equal(flat[pos].astype(np.int64), want_natural)


@pytest.mark.parametrize("field", [F.KYBER, F.DILITHIUM, F.P_998244353, F.P_2013265921])
def test_roundtrip_all_fields(field, rng):
    log_n = min(8, field.max_n.bit_length() - 1)
    cfg = NTTConfig(field=field, log_n=log_n)
    ctx = NTTContext(cfg)
    a = rng.integers(0, field.p, cfg.n)
    aj = jnp.asarray(a, dtype=jnp.uint32)
    back = np.asarray(ctx.inverse(ctx.forward(aj)))
    assert np.array_equal(back, a)


def test_natural_ordering_roundtrip(rng):
    field = F.P_2013265921
    cfg = NTTConfig(field=field, log_n=12, ordering="natural")
    ctx = NTTContext(cfg)
    a = rng.integers(0, field.p, cfg.n)
    aj = jnp.asarray(a, dtype=jnp.uint32)
    fwd = np.asarray(ctx.forward(aj))
    assert np.array_equal(fwd.astype(np.int64), ref.ntt_forward(a, field))
    assert np.array_equal(np.asarray(ctx.inverse(jnp.asarray(fwd))), a)


@pytest.mark.parametrize("field", [F.KYBER, F.P_2013265921])
def test_polymul_cyclic(field, rng):
    log_n = min(7, field.max_n.bit_length() - 1)
    n = 1 << log_n
    cfg = NTTConfig(field=field, log_n=log_n)
    ctx = NTTContext(cfg)
    a = rng.integers(0, field.p, n)
    b = rng.integers(0, field.p, n)
    got = np.asarray(ctx.polymul(jnp.asarray(a, dtype=jnp.uint32), jnp.asarray(b, dtype=jnp.uint32)))
    want = ref.schoolbook_cyclic(a, b, field.p)
    assert np.array_equal(got.astype(object), want)


def test_polymul_large_fourstep(rng):
    field = F.P_2013265921
    cfg = NTTConfig(field=field, log_n=12, rows_log2=5)  # force four-step
    ctx = NTTContext(cfg)
    n = cfg.n
    a = rng.integers(0, field.p, n)
    b = rng.integers(0, field.p, n)
    got = np.asarray(ctx.polymul(jnp.asarray(a, dtype=jnp.uint32), jnp.asarray(b, dtype=jnp.uint32)))
    want = ref.cyclic_polymul(a, b, field)
    assert np.array_equal(got.astype(np.int64), want)


def test_negacyclic_polymul_device(rng):
    field = F.P_2013265921
    cfg = NTTConfig(field=field, log_n=10, rows_log2=5, negacyclic=True)  # four-step
    ctx = NTTContext(cfg)
    n = cfg.n
    a = rng.integers(0, field.p, n)
    b = rng.integers(0, field.p, n)
    got = np.asarray(
        ctx.plan.negacyclic_polymul(jnp.asarray(a, dtype=jnp.uint32), jnp.asarray(b, dtype=jnp.uint32))
    )
    want = ref.negacyclic_polymul(a, b, field)
    assert np.array_equal(got.astype(np.int64), want)


def test_reference_parity_device():
    """The flagship parity test: device plan == reference device output,
    logN=11, p=3329, a[i]=i (reference src/test.cpp:141, 203-219)."""
    cfg = NTTConfig(
        field=F.KYBER, log_n=11, table_convention="reference", ordering="reference"
    )
    ctx = NTTContext(cfg)
    a = np.arange(1 << 11)
    got = np.asarray(ctx.forward(jnp.asarray(a, dtype=jnp.uint32)))
    want = ref.reference_device_output(a, F.KYBER, 1 << 11)
    assert np.array_equal(got.astype(np.int64), want)


def test_reference_parity_partial_depth():
    """test_stage hook parity at every depth (src/test.cpp:55-57)."""
    from ntt_aie.ops import colnet
    from ntt_aie.ops.reductions import make_reduction

    n = 1 << 8
    field = F.KYBER
    red = make_reduction("barrett", field)
    table_np = tw.power_table(field, n)
    table = tuple(jnp.asarray(t) for t in red.prepare_table(table_np))
    a = np.arange(n)
    for stage in range(8):
        got = np.asarray(
            colnet.reference_network_stages(
                jnp.asarray(a, dtype=jnp.uint32), table, field.p, red, stages=stage
            )
        )
        want = ref.reference_network(a, table_np, field.p, stages=stage)
        assert np.array_equal(got.astype(np.int64), want), f"stage {stage}"


def test_linearity_device(rng):
    field = F.P_998244353
    cfg = NTTConfig(field=field, log_n=11)
    ctx = NTTContext(cfg)
    p = field.p
    a = rng.integers(0, p, cfg.n)
    b = rng.integers(0, p, cfg.n)
    fa = np.asarray(ctx.forward(jnp.asarray(a, dtype=jnp.uint32))).astype(np.int64)
    fb = np.asarray(ctx.forward(jnp.asarray(b, dtype=jnp.uint32))).astype(np.int64)
    fab = np.asarray(ctx.forward(jnp.asarray((a + b) % p, dtype=jnp.uint32))).astype(np.int64)
    assert np.array_equal(fab, (fa + fb) % p)


# ---- Harvey lazy-butterfly reduction ----

def test_harvey_forward_and_roundtrip(rng):
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, reduction="harvey")
    ctx = NTTContext(cfg)
    assert ctx.plan.reduction == "harvey"
    a = rng.integers(0, field.p, cfg.n)
    aj = jnp.asarray(a, dtype=jnp.uint32)
    flat = np.asarray(ctx.forward(aj))
    assert flat.max() < field.p, "canonicalization failed"
    pos = ctx.plan.spectral_to_natural
    assert np.array_equal(flat[pos].astype(np.int64), ref.ntt_forward(a, field))
    assert np.array_equal(np.asarray(ctx.inverse(jnp.asarray(flat))), a)


def test_harvey_auto_selected():
    assert NTTContext(NTTConfig(field=F.P_998244353, log_n=10)).plan.reduction == "harvey"
    assert NTTContext(NTTConfig(field=F.P_2013265921, log_n=10)).plan.reduction == "montgomery"


def test_harvey_polymul(rng):
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=11, rows_log2=5)  # force four-step
    ctx = NTTContext(cfg)
    a = rng.integers(0, field.p, cfg.n)
    b = rng.integers(0, field.p, cfg.n)
    got = np.asarray(ctx.polymul(jnp.asarray(a, dtype=jnp.uint32), jnp.asarray(b, dtype=jnp.uint32)))
    want = ref.cyclic_polymul(a, b, field)
    assert np.array_equal(got.astype(np.int64), want)


def test_harvey4_forward_roundtrip_polymul(rng):
    """Approximate-Shoup [0,4p) lazy reduction: bit-exact vs the oracle
    on every path, and auto-selected for p < 2^29."""
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=12, reduction="harvey4")
    ctx = NTTContext(cfg)
    a = rng.integers(0, field.p, cfg.n)
    aj = jnp.asarray(a, dtype=jnp.uint32)
    flat = np.asarray(ctx.forward(aj))
    assert flat.max() < field.p, "canonicalization failed"
    pos = ctx.plan.spectral_to_natural
    assert np.array_equal(flat[pos].astype(np.int64), ref.ntt_forward(a, field))
    assert np.array_equal(np.asarray(ctx.inverse(jnp.asarray(flat))), a)
    b = rng.integers(0, field.p, cfg.n)
    got = np.asarray(ctx.polymul(aj, jnp.asarray(b, dtype=jnp.uint32)))
    assert np.array_equal(got.astype(np.int64), ref.cyclic_polymul(a, b, field))
    # auto preference: 5-mul harvey4 below 2^29, 6-mul harvey below 2^30
    assert NTTContext(NTTConfig(field=field, log_n=10)).plan.reduction == "harvey4"


def test_harvey4_mulc_domain_and_values(rng):
    """mul_const: any x < 2^32 is legal input; output in [0, 4p) and
    congruent to x*w mod p (the approximation error is bounded by 2p)."""
    from ntt_aie.ops.reductions import make_reduction

    field = F.P_469762049
    p = field.p
    red = make_reduction("harvey4", field)
    w = rng.integers(0, p, 4096).astype(np.int64)
    tabs = [jnp.asarray(t) for t in red.prepare_table(w)]
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    got = np.asarray(red.mul_const(jnp.asarray(x), *tabs)).astype(np.uint64)
    assert got.max() < 4 * p
    assert np.array_equal(got % p, (x.astype(np.uint64) * w.astype(np.uint64)) % p)
    canon = np.asarray(red.canonicalize(jnp.asarray(got.astype(np.uint32))))
    assert canon.max() < p


def test_polymul_with_natural_ordering(rng):
    """Regression: the ordering wrapper must not leak into polymul's
    internal transforms (pointwise products run in spectral order)."""
    field = F.P_2013265921
    cfg = NTTConfig(field=field, log_n=10, rows_log2=4, ordering="natural")
    ctx = NTTContext(cfg)
    a = rng.integers(0, field.p, cfg.n)
    b = rng.integers(0, field.p, cfg.n)
    got = np.asarray(ctx.polymul(jnp.asarray(a, dtype=jnp.uint32), jnp.asarray(b, dtype=jnp.uint32)))
    want = ref.cyclic_polymul(a, b, field)
    assert np.array_equal(got.astype(np.int64), want)


def test_pallas_batched_batch_one(rng):
    """Regression: make_batched(1) on a four-step plan: the (1, n) input
    keeps its batch dim through the passes."""
    from ntt_aie.plan import build_plan

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=11, rows_log2=4)
    plan_p = build_plan(cfg)
    a = rng.integers(0, field.p, cfg.n)
    batched = plan_p.make_batched(1)
    got = np.asarray(batched["fwd"](jnp.asarray(a[None], dtype=jnp.uint32)))
    assert got.shape == (1, cfg.n)
    assert np.array_equal(got[0], np.asarray(plan_p.fwd(jnp.asarray(a, dtype=jnp.uint32))))


def test_host_oracle_matches_device_default_ordering(rng):
    """Regression (review finding): forward_host/inverse_host must agree
    with the device plan's spectral order for the default 'bitrev'
    ordering with an (n1, n2) split — not plain DIF bit reversal."""
    field = F.P_2013265921
    cfg = NTTConfig(field=field, log_n=10, rows_log2=3)  # split (8, 128)
    ctx = NTTContext(cfg)
    a = rng.integers(0, field.p, cfg.n)
    dev = np.asarray(ctx.forward(jnp.asarray(a, dtype=jnp.uint32)))
    host = ctx.forward_host(a)
    assert np.array_equal(dev.astype(np.int64), host.astype(np.int64))
    assert np.array_equal(ctx.inverse_host(host), a)


def test_pallas_batched_honors_natural_ordering(rng):
    """Regression (review finding): make_batched must apply the natural-
    ordering wrapper on four-step plans, like the unbatched callables."""
    from ntt_aie.plan import build_plan

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=11, rows_log2=4, ordering="natural")
    plan = build_plan(cfg)
    a = rng.integers(0, field.p, cfg.n)
    batched = plan.make_batched(2)
    got = np.asarray(batched["fwd"](jnp.asarray(np.stack([a, a]), dtype=jnp.uint32)))
    want = np.asarray(plan.fwd(jnp.asarray(a, dtype=jnp.uint32)))
    assert np.array_equal(got[0], want)
    back = np.asarray(batched["inv"](jnp.asarray(got)))
    assert np.array_equal(back[1], a)


def test_non_primitive_generator_rejected():
    """Regression (review finding): Fermat-only validation accepted
    non-primitive generators."""
    import pytest

    with pytest.raises(ValueError, match="primitive"):
        F.PrimeField(p=17, g=4)
    F.PrimeField(p=17, g=3)  # actual primitive root: fine


def test_negacyclic_fused_pallas(rng):
    """The four-step RLWE pipeline matches the oracle, both reductions."""
    from ntt_aie.plan import build_plan

    for field in (F.P_469762049, F.P_2013265921):
        cfg = NTTConfig(field=field, log_n=10, rows_log2=3, negacyclic=True)
        plan = build_plan(cfg)
        a = rng.integers(0, field.p, cfg.n)
        b = rng.integers(0, field.p, cfg.n)
        got = np.asarray(plan.negacyclic_polymul(
            jnp.asarray(a, dtype=jnp.uint32), jnp.asarray(b, dtype=jnp.uint32)))
        want = ref.negacyclic_polymul(a, b, field)
        assert np.array_equal(got.astype(np.int64), want), field.name


def test_negacyclic_batched_pallas(rng):
    from ntt_aie.plan import build_plan

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=9, rows_log2=3, negacyclic=True)
    plan = build_plan(cfg)
    B = 2
    a = rng.integers(0, field.p, (B, cfg.n))
    b = rng.integers(0, field.p, (B, cfg.n))
    nega_b = plan.make_batched(B)["negacyclic_polymul"]
    got = np.asarray(nega_b(jnp.asarray(a, dtype=jnp.uint32),
                            jnp.asarray(b, dtype=jnp.uint32)))
    for i in range(B):
        want = ref.negacyclic_polymul(a[i], b[i], field)
        assert np.array_equal(got[i].astype(np.int64), want)


def test_pallas_batched_polymul_natural_ordering(rng):
    """Regression (2nd review): batched polymul must use the raw spectral
    forward even when the ordering wrapper rebinds fwd_b."""
    from ntt_aie.plan import build_plan

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=11, rows_log2=4, ordering="natural")
    plan = build_plan(cfg)
    a = rng.integers(0, field.p, (2, cfg.n))
    b = rng.integers(0, field.p, (2, cfg.n))
    got = np.asarray(plan.make_batched(2)["polymul"](
        jnp.asarray(a, dtype=jnp.uint32), jnp.asarray(b, dtype=jnp.uint32)))
    want = ref.cyclic_polymul(a[0], b[0], field)
    assert np.array_equal(got[0].astype(np.int64), want)


def test_xla_batched_includes_negacyclic(rng):
    from ntt_aie.plan import build_plan

    field = F.P_2013265921
    cfg = NTTConfig(field=field, log_n=8, negacyclic=True)
    plan = build_plan(cfg, engine="xla")
    a = rng.integers(0, field.p, (2, cfg.n))
    got = np.asarray(plan.make_batched(2)["negacyclic_polymul"](
        jnp.asarray(a, dtype=jnp.uint32), jnp.asarray(a, dtype=jnp.uint32)))
    want = ref.negacyclic_polymul(a[1], a[1], field)
    assert np.array_equal(got[1].astype(np.int64), want)


def test_inverse_host_reference_convention_raises():
    import pytest

    cfg = NTTConfig(field=F.KYBER, log_n=11, table_convention="reference")
    ctx = NTTContext(cfg)
    with pytest.raises(NotImplementedError):
        ctx.inverse_host(np.zeros(cfg.n, dtype=np.int64))


def test_flat_batched_lane_layout(rng):
    """Small-n batched path (batch-to-lanes): matches per-vector results,
    all ops, including the ML-DSA ring (dilithium negacyclic at n=256)."""
    field = F.DILITHIUM
    cfg = NTTConfig(field=field, log_n=8, rows_log2=8, negacyclic=True)
    ctx = NTTContext(cfg)
    B = 3
    a = rng.integers(0, field.p, (B, cfg.n))
    b = rng.integers(0, field.p, (B, cfg.n))
    aj = jnp.asarray(a, dtype=jnp.uint32)
    bj = jnp.asarray(b, dtype=jnp.uint32)
    bat = ctx.plan.make_batched(B)
    got_f = np.asarray(bat["fwd"](aj))
    for i in range(B):
        assert np.array_equal(got_f[i], np.asarray(ctx.forward(aj[i])))
    assert np.array_equal(np.asarray(bat["inv"](jnp.asarray(got_f))), a)
    got_p = np.asarray(bat["polymul"](aj, bj))
    assert np.array_equal(got_p[0].astype(np.int64),
                          ref.cyclic_polymul(a[0], b[0], field))
    got_n = np.asarray(bat["negacyclic_polymul"](aj, bj))
    want_n = ref.negacyclic_polymul(a[1], b[1], field)  # the ML-DSA ring
    assert np.array_equal(got_n[1].astype(np.int64), want_n)


def test_flat_batched_honors_natural_ordering(rng):
    """Regression (4th review): the flat batch-to-lanes path must honor
    ordering='natural' like every other make_batched variant."""
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=9, rows_log2=9, ordering="natural")
    ctx = NTTContext(cfg)
    a = rng.integers(0, field.p, (2, cfg.n))
    aj = jnp.asarray(a, dtype=jnp.uint32)
    bat = ctx.plan.make_batched(2)
    got = np.asarray(bat["fwd"](aj))
    assert np.array_equal(got[0].astype(np.int64), ref.ntt_forward(a[0], field))
    assert np.array_equal(np.asarray(bat["inv"](jnp.asarray(got))), a)


def test_default_split_flat_small_n():
    """Small single-shard configs auto-select the flat (batch-to-lanes)
    split; sharded and large configs keep the four-step split."""
    assert NTTConfig(field=F.P_469762049, log_n=10).split == (1 << 10, 1)
    assert NTTConfig(field=F.P_469762049, log_n=16).split == (1 << 16, 1)
    assert NTTConfig(field=F.P_469762049, log_n=18).split[1] > 1
    assert NTTConfig(field=F.P_469762049, log_n=12, num_shards=4).split[1] > 1


def test_default_split_flat_cutoff_field_aware():
    assert NTTConfig(field=F.GOLDILOCKS, log_n=14).split == (1 << 14, 1)
    assert NTTConfig(field=F.GOLDILOCKS, log_n=16).split[1] > 1


@pytest.mark.parametrize("direction", ["dif", "dit"])
@pytest.mark.parametrize("reduction", ["harvey", "harvey4"])
@pytest.mark.parametrize("fuse", [2, 3, 4])
def test_colpass_fuse_levels_match(direction, reduction, fuse, rng):
    """The radix-2^K fused stage groups (ops/colnet.run_stages) must
    match the sequential radix-2 network (fuse=1) for BOTH recursion
    directions. DIF raw lazy-domain bits are identical (same per-element
    op sequence regardless of K). DIT subtree outputs that feed the next
    level's multiply legally skip their conditional corrections inside a
    group (add_for_mul/sub_for_mul), so fused raw bits differ from fuse=1
    by multiples of p — canonical values must still be bit-equal. Guards
    the whole-half vectorized net_dit restructure + the lazy skip."""
    from ntt_aie.ops import colnet
    from ntt_aie.ops.reductions import make_reduction

    field = F.P_469762049
    n1, n2 = 64, 8
    red = make_reduction(reduction, field)
    x = jnp.asarray(rng.integers(0, field.p, (n1, n2)).astype(np.uint32))
    base = colnet.make_col_transform(field, n1, direction=direction, red=red,
                                     fuse=1)
    fused = colnet.make_col_transform(field, n1, direction=direction,
                                      red=red, fuse=fuse)
    got_b, got_f = np.asarray(base(x)), np.asarray(fused(x))
    if direction == "dif":
        assert np.array_equal(got_b, got_f)
    else:
        canon = lambda a: np.asarray(red.canonicalize(jnp.asarray(a)))
        assert np.array_equal(canon(got_b), canon(got_f))
        # group top levels are never lazy: raw output stays in the travel
        # domain
        dom = 4 * field.p if reduction == "harvey4" else 2 * field.p
        assert int(got_f.max()) < dom


def test_fourstep_wfac_product_matches_wmat():
    """fourstep_wfac_T factor product must equal the full wmat (and the
    scaled inverse matrix) entrywise mod p — the factored kernel path is
    only correct if the factorization is (twiddles.fourstep_wfac_T)."""
    field = F.P_469762049
    n1, n2 = 32, 128
    tabs = tw.fourstep_tables(field, n1, n2)
    for inverse, full in ((False, tabs["wmat"].T),
                          (True, tabs["iwmat_scaled"].T)):
        t1, t2 = tw.fourstep_wfac_T(
            field, n1, n2, inverse=inverse,
            scale=tabs["n_inv"] if inverse else None)
        S = n2 // t1.shape[0]
        assert t2.shape[0] == S and t1.shape[1] == t2.shape[1] == n1
        got = (t1[:, None, :].astype(object) * t2[None, :, :]
               % field.p).reshape(n2, n1)
        assert np.array_equal(got.astype(np.int64), np.asarray(full))


def test_negacyclic_psi_factors_match_matrix():
    """negacyclic_psi_factors is an exact rank-1 factorization of the psi
    power matrix: row[r] * col[c] == psi^(r*n2 + c) entrywise, forward and
    inverse (the factored negacyclic passes depend on it)."""
    field = F.P_469762049
    n1, n2 = 16, 64
    for inverse in (False, True):
        full = tw.negacyclic_psi_powers(field, n1 * n2,
                                        inverse=inverse).reshape(n1, n2)
        r, c = tw.negacyclic_psi_factors(field, n1, n2, inverse=inverse)
        got = r[:, None].astype(object) * c[None, :] % field.p
        assert np.array_equal(got.astype(np.int64), np.asarray(full))


def test_context_single_chip_plan_kwargs(rng):
    """NTTContext without mesh= forwards build_plan's own knob (engine) —
    one entry point, like the reference's single CLI surface
    (src/test.cpp:85-92). Distributed-only kwargs still raise without
    mesh=."""
    field = F.P_2013265921
    cfg = NTTConfig(field=field, log_n=10, rows_log2=5)
    a = rng.integers(0, field.p, cfg.n)
    aj = jnp.asarray(a, dtype=jnp.uint32)
    want = np.asarray(NTTContext(cfg).forward(aj))

    got = np.asarray(NTTContext(cfg, engine="xla").forward(aj))
    assert np.array_equal(got, want)

    with pytest.raises(TypeError, match="need mesh="):
        NTTContext(cfg, overlap_chunks=2)
    with pytest.raises(TypeError, match="need mesh="):
        NTTContext(cfg, dp_axis="dp")


def test_dit_nets_match_across_fuse(rng):
    """The three DIT group networks (parts default / tree / iter) and
    several fuse levels of colnet.run_stages produce identical CANONICAL
    outputs (raw lazy-domain bits may differ legally) for every lazy
    reduction."""
    from ntt_aie.ops import colnet
    from ntt_aie.ops.reductions import make_reduction

    n1 = n2 = 64
    for field, kind in ((F.P_469762049, "harvey4"), (F.P_998244353, "harvey"),
                        (F.P_2013265921, "montgomery")):
        red = make_reduction(kind, field)
        tws = colnet.stage_tables(
            tw.dit_stage_twiddles(field, n1, inverse=True), red)
        x = jnp.asarray(rng.integers(0, field.p, (n1, n2)).astype(np.uint32))
        outs = []
        for net, fuse in (("parts", None), ("parts", 3), ("parts", 6),
                          ("tree", 3), ("iter", 3), ("tree", 1)):
            y = colnet.run_stages(x, tws, "dit", red, fuse=fuse, dit_net=net)
            outs.append(np.asarray(red.canonicalize(y)))
        for o in outs[1:]:
            assert np.array_equal(o, outs[0]), (kind,)


def test_matrix_form_callables(rng):
    """Matrix-form batched callables (fwd_mat/inv_mat/polymul_mat) are
    bit-identical to the flat contract under row-major (un)flattening."""
    from ntt_aie.plan import build_plan

    field = F.P_469762049
    for B in (3, 1, 2):
        cfg = NTTConfig(field=field, log_n=10, rows_log2=5)
        plan = build_plan(cfg)
        n1, n2 = cfg.split
        bat = plan.make_batched(B)
        a = rng.integers(0, field.p, (B, cfg.n)).astype(np.uint32)
        b = rng.integers(0, field.p, (B, cfg.n)).astype(np.uint32)
        am = jnp.asarray(a.reshape(B, n1, n2))

        fm = np.asarray(bat["fwd_mat"](am))
        assert fm.shape == (B, n2, n1), B
        flat = np.asarray(bat["fwd"](jnp.asarray(a)))
        assert np.array_equal(fm.reshape(B, cfg.n), flat), B

        im = np.asarray(bat["inv_mat"](jnp.asarray(fm)))
        assert im.shape == (B, n1, n2)
        assert np.array_equal(im.reshape(B, cfg.n), a), B

        pm = np.asarray(bat["polymul_mat"](am, jnp.asarray(
            b.reshape(B, n1, n2))))
        assert pm.shape == (B, n1, n2)
        pflat = np.asarray(bat["polymul"](jnp.asarray(a), jnp.asarray(b)))
        assert np.array_equal(pm.reshape(B, cfg.n), pflat), B


def test_matrix_form_negacyclic_and_natural_gating(rng):
    """negacyclic_polymul_mat matches the flat negacyclic product; natural-
    ordering plans expose the layout-safe polymul_mat but NOT fwd_mat (a
    flat permutation has no cheap matrix-form equivalent)."""
    from ntt_aie.plan import build_plan

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=9, rows_log2=4, negacyclic=True)
    plan = build_plan(cfg)
    n1, n2 = cfg.split
    B = 2
    bat = plan.make_batched(B)
    a = rng.integers(0, field.p, (B, cfg.n)).astype(np.uint32)
    b = rng.integers(0, field.p, (B, cfg.n)).astype(np.uint32)
    gm = np.asarray(bat["negacyclic_polymul_mat"](
        jnp.asarray(a.reshape(B, n1, n2)), jnp.asarray(b.reshape(B, n1, n2))))
    gf = np.asarray(bat["negacyclic_polymul"](jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(gm.reshape(B, cfg.n), gf)

    cfgn = NTTConfig(field=field, log_n=9, rows_log2=4, ordering="natural")
    batn = build_plan(cfgn).make_batched(B)
    assert "fwd_mat" not in batn and "inv_mat" not in batn
    got = np.asarray(batn["polymul_mat"](
        jnp.asarray(a.reshape(B, n1, n2)), jnp.asarray(b.reshape(B, n1, n2))))
    want = ref.cyclic_polymul(a[0], b[0], field)
    assert np.array_equal(got[0].reshape(cfgn.n).astype(np.int64), want)


def test_unbatched_matrix_form_twins(rng):
    """Plan.fwd_mat/inv_mat/polymul_mat/negacyclic_polymul_mat: the
    unbatched views of the batched *_mat callables, bit-identical to the
    flat callables under row-major (un)flattening. Natural-ordering plans
    keep the layout-safe polymul views but drop fwd_mat/inv_mat."""
    from ntt_aie.plan import build_plan

    field = F.P_469762049
    for engine in ("auto", "xla"):
        cfg = NTTConfig(field=field, log_n=10, rows_log2=5, negacyclic=True)
        plan = build_plan(cfg, engine=engine)
        n1, n2 = cfg.split
        a = rng.integers(0, field.p, cfg.n).astype(np.uint32)
        b = rng.integers(0, field.p, cfg.n).astype(np.uint32)
        am = jnp.asarray(a.reshape(n1, n2))
        bm = jnp.asarray(b.reshape(n1, n2))

        fm = np.asarray(plan.fwd_mat(am))
        assert fm.shape == (n2, n1), engine
        flat = np.asarray(plan.fwd(jnp.asarray(a)))
        assert np.array_equal(fm.reshape(cfg.n), flat), engine

        im = np.asarray(plan.inv_mat(jnp.asarray(fm)))
        assert im.shape == (n1, n2)
        assert np.array_equal(im.reshape(cfg.n), a), engine

        pm = np.asarray(plan.polymul_mat(am, bm))
        pflat = np.asarray(plan.polymul(jnp.asarray(a), jnp.asarray(b)))
        assert np.array_equal(pm.reshape(cfg.n), pflat), engine

        gm = np.asarray(plan.negacyclic_polymul_mat(am, bm))
        gflat = np.asarray(plan.negacyclic_polymul(jnp.asarray(a),
                                                   jnp.asarray(b)))
        assert np.array_equal(gm.reshape(cfg.n), gflat), engine

    # natural ordering: polymul twins stay, fwd/inv twins are gated off
    cfgn = NTTConfig(field=field, log_n=10, rows_log2=5, ordering="natural")
    plann = build_plan(cfgn)
    assert plann.fwd_mat is None and plann.inv_mat is None
    n1, n2 = cfgn.split
    a = rng.integers(0, field.p, cfgn.n).astype(np.uint32)
    b = rng.integers(0, field.p, cfgn.n).astype(np.uint32)
    got = np.asarray(plann.polymul_mat(jnp.asarray(a.reshape(n1, n2)),
                                       jnp.asarray(b.reshape(n1, n2))))
    want = ref.cyclic_polymul(a, b, field)
    assert np.array_equal(got.reshape(cfgn.n).astype(np.int64), want)

    # flat-split plans have no matrix-form views
    flatp = build_plan(NTTConfig(field=field, log_n=8, rows_log2=8))
    assert flatp.fwd_mat is None and flatp.polymul_mat is None


def test_context_serving_surface(rng):
    """NTTContext.make_batched / forward_mat / polymul_mat: the documented
    L3 driver exposes the matrix-form layout — delegation to the plan's
    batched dict and the unbatched views, with clear errors where they
    don't exist (flat splits, plans without negacyclic tables)."""
    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=10, rows_log2=5)
    ctx = NTTContext(cfg)
    n1, n2 = cfg.split
    B = 2
    bat = ctx.make_batched(B)
    assert set(bat) >= {"fwd", "inv", "polymul", "fwd_mat", "inv_mat",
                        "polymul_mat"}
    a = rng.integers(0, field.p, (B, cfg.n)).astype(np.uint32)
    fm = np.asarray(bat["fwd_mat"](jnp.asarray(a.reshape(B, n1, n2))))
    assert np.array_equal(fm.reshape(B, cfg.n),
                          np.asarray(bat["fwd"](jnp.asarray(a))))

    am = jnp.asarray(a[0].reshape(n1, n2))
    fm1 = np.asarray(ctx.forward_mat(am))
    assert np.array_equal(fm1.reshape(cfg.n), np.asarray(ctx.forward(a[0])))
    assert np.array_equal(np.asarray(ctx.inverse_mat(jnp.asarray(fm1))),
                          np.asarray(am))
    pm = np.asarray(ctx.polymul_mat(am, am))
    assert np.array_equal(pm.reshape(cfg.n),
                          np.asarray(ctx.polymul(a[0], a[0])))

    # flat-split plans have no matrix-form views -> informative error
    ctx_flat = NTTContext(NTTConfig(field=field, log_n=8, rows_log2=8))
    with pytest.raises(NotImplementedError, match="matrix-form"):
        ctx_flat.forward_mat(am)

    # negacyclic view needs negacyclic=True planning (via plan attr)
    with pytest.raises(NotImplementedError, match="matrix-form"):
        ctx.negacyclic_polymul_mat(am, am)


def test_context_make_batched_rejects_mesh():
    import jax
    from ntt_aie.parallel.mesh import make_mesh

    mesh = make_mesh(2)
    cfg = NTTConfig(field=F.P_469762049, log_n=10, rows_log2=5, num_shards=2)
    ctx = NTTContext(cfg, mesh=mesh)
    with pytest.raises(NotImplementedError, match="dp_axis"):
        ctx.make_batched(4)
