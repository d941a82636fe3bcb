"""Goldilocks (p = 2^64 - 2^32 + 1) device plan: 64-bit field elements as
(hi, lo) uint32 limb pairs (SURVEY.md §7 hard part 1, widened to 64-bit).
Bit-exact vs the object-int NumPy oracle."""

import numpy as np
import pytest

from ntt_aie import fields as F
from ntt_aie import reference as ref
from ntt_aie.config import NTTConfig
from ntt_aie.api import NTTContext

GL = F.GOLDILOCKS


def _rand(rng, n):
    # uniform over [0, p) via two 32-bit draws, rejection-free (bias ~2^-32
    # irrelevant for exactness tests: values are reduced mod p explicitly)
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64) << np.uint64(32)
    v |= rng.integers(0, 1 << 32, n, dtype=np.uint64)
    return (v % np.uint64(GL.p)).astype(np.uint64)


def test_auto_reduction_dispatch():
    ctx = NTTContext(NTTConfig(field=GL, log_n=6))
    assert ctx.plan.reduction == "goldilocks"


def test_flat_forward_matches_oracle(rng):
    cfg = NTTConfig(field=GL, log_n=6, rows_log2=6)  # flat path
    ctx = NTTContext(cfg)
    a = _rand(rng, cfg.n)
    got = np.asarray(ctx.forward(a))
    want = ref.ntt_dif(a.astype(object), GL)
    assert np.array_equal(got.astype(object), want.astype(object))


@pytest.mark.parametrize("log_n,rows_log2", [(8, 3), (10, 5)])
def test_fourstep_forward_spectral_order(log_n, rows_log2, rng):
    cfg = NTTConfig(field=GL, log_n=log_n, rows_log2=rows_log2)
    ctx = NTTContext(cfg)
    a = _rand(rng, cfg.n)
    flat = np.asarray(ctx.forward(a))
    pos = ctx.plan.spectral_to_natural
    want_natural = ref.ntt_forward(a.astype(object), GL)
    assert np.array_equal(flat[pos].astype(object), want_natural.astype(object))


def test_roundtrip_and_natural_ordering(rng):
    cfg = NTTConfig(field=GL, log_n=9, rows_log2=4, ordering="natural")
    ctx = NTTContext(cfg)
    a = _rand(rng, cfg.n)
    fwd = np.asarray(ctx.forward(a))
    assert np.array_equal(
        fwd.astype(object), ref.ntt_forward(a.astype(object), GL).astype(object)
    )
    assert np.array_equal(np.asarray(ctx.inverse(fwd)), a)


def test_limb_tuple_interface(rng):
    """Device-resident form: (hi, lo) tuples in, tuples out."""
    import jax.numpy as jnp
    from ntt_aie.ops import modops as M

    cfg = NTTConfig(field=GL, log_n=8)
    ctx = NTTContext(cfg)
    a = _rand(rng, cfg.n)
    hi, lo = M.gl_from_u64(a)
    out = ctx.forward((hi, lo))
    assert isinstance(out, tuple) and out[0].dtype == jnp.uint32
    assert np.array_equal(M.gl_to_u64(*out), np.asarray(ctx.forward(a)))


def test_polymul_cyclic(rng):
    cfg = NTTConfig(field=GL, log_n=6)
    ctx = NTTContext(cfg)
    a = _rand(rng, cfg.n)
    b = _rand(rng, cfg.n)
    got = np.asarray(ctx.polymul(a, b))
    want = ref.schoolbook_cyclic(a.astype(object), b.astype(object), GL.p)
    assert np.array_equal(got.astype(object), want.astype(object))


def test_negacyclic_polymul(rng):
    cfg = NTTConfig(field=GL, log_n=6, negacyclic=True)
    ctx = NTTContext(cfg)
    a = _rand(rng, cfg.n)
    b = _rand(rng, cfg.n)
    got = np.asarray(ctx.plan.negacyclic_polymul(a, b))
    want = ref.schoolbook_negacyclic(a.astype(object), b.astype(object), GL.p)
    assert np.array_equal(got.astype(object), want.astype(object))


def test_batched_matches_single(rng):
    cfg = NTTConfig(field=GL, log_n=8)
    ctx = NTTContext(cfg)
    B = 3
    a = np.stack([_rand(rng, cfg.n) for _ in range(B)])
    batched = ctx.plan.make_batched(B)
    got = np.asarray(batched["fwd"](a))
    for i in range(B):
        assert np.array_equal(got[i], np.asarray(ctx.forward(a[i])))


def test_polymul_with_natural_ordering(rng):
    """Regression: same ordering-wrapper leak as plan.py (see test_plan)."""
    cfg = NTTConfig(field=GL, log_n=6, ordering="natural")
    ctx = NTTContext(cfg)
    a = _rand(rng, cfg.n)
    b = _rand(rng, cfg.n)
    got = np.asarray(ctx.polymul(a, b))
    want = ref.schoolbook_cyclic(a.astype(object), b.astype(object), GL.p)
    assert np.array_equal(got.astype(object), want.astype(object))


def test_pallas_gl_batched_matches_single(rng):
    from ntt_aie.goldilocks_plan import build_goldilocks_plan

    cfg = NTTConfig(field=GL, log_n=9, rows_log2=4)
    plan = build_goldilocks_plan(cfg)
    B = 2
    a = np.stack([_rand(rng, cfg.n) for _ in range(B)])
    got = np.asarray(plan.make_batched(B)["fwd"](a))
    for i in range(B):
        assert np.array_equal(got[i], np.asarray(plan.fwd(a[i])))
    got1 = np.asarray(plan.make_batched(1)["fwd"](a[:1]))
    assert np.array_equal(got1[0], np.asarray(plan.fwd(a[0])))


def test_gl_batched_honors_natural_ordering(rng):
    from ntt_aie.goldilocks_plan import build_goldilocks_plan

    cfg = NTTConfig(field=GL, log_n=8, ordering="natural")
    plan = build_goldilocks_plan(cfg, engine="xla")
    a = _rand(rng, cfg.n)
    got = np.asarray(plan.make_batched(1)["fwd"](a[None]))
    assert np.array_equal(got[0], np.asarray(plan.fwd(a)))


def test_gl_flat_batched_lane_layout(rng):
    """Flat (default small-n) GL batched path uses batch-to-lanes limbs and
    matches per-vector results."""
    cfg = NTTConfig(field=GL, log_n=9)  # default: flat split
    assert cfg.split == (1 << 9, 1)
    plan = NTTContext(cfg).plan
    B = 3
    a = np.stack([_rand(rng, cfg.n) for _ in range(B)])
    bat = plan.make_batched(B)
    got = np.asarray(bat["fwd"](a))
    for i in range(B):
        assert np.array_equal(got[i], np.asarray(plan.fwd(a[i])))
    back = np.asarray(bat["inv"](got))
    assert np.array_equal(back, a)


def test_gl_matrix_form_callables(rng):
    """GL matrix-form batched callables match the flat contract under
    row-major (un)flattening (plan.py layout contract)."""
    from ntt_aie.goldilocks_plan import build_goldilocks_plan

    cfg = NTTConfig(field=GL, log_n=9, rows_log2=4)
    plan = build_goldilocks_plan(cfg)
    n1, n2 = cfg.split
    B = 2
    bat = plan.make_batched(B)
    a = np.stack([_rand(rng, cfg.n) for _ in range(B)])
    b = np.stack([_rand(rng, cfg.n) for _ in range(B)])

    fm = np.asarray(bat["fwd_mat"](a.reshape(B, n1, n2)))
    assert fm.shape == (B, n2, n1)
    flat = np.asarray(bat["fwd"](a))
    assert np.array_equal(fm.reshape(B, cfg.n), flat)

    im = np.asarray(bat["inv_mat"](fm))
    assert im.shape == (B, n1, n2)
    assert np.array_equal(im.reshape(B, cfg.n), a)

    pm = np.asarray(bat["polymul_mat"](a.reshape(B, n1, n2),
                                       b.reshape(B, n1, n2)))
    assert np.array_equal(pm.reshape(B, cfg.n),
                          np.asarray(bat["polymul"](a, b)))


def test_gl_unbatched_matrix_form_twins(rng):
    """GL Plan.fwd_mat/inv_mat/polymul_mat: the unbatched matrix-form
    views over uint64 matrices (and limb pairs via the same _wrap
    conversion) match the flat callables bit-exactly."""
    from ntt_aie.goldilocks_plan import build_goldilocks_plan

    cfg = NTTConfig(field=GL, log_n=9, rows_log2=4)
    plan = build_goldilocks_plan(cfg)
    n1, n2 = cfg.split
    a = _rand(rng, cfg.n)
    b = _rand(rng, cfg.n)

    fm = np.asarray(plan.fwd_mat(a.reshape(n1, n2)))
    assert fm.shape == (n2, n1)
    assert np.array_equal(fm.reshape(cfg.n), np.asarray(plan.fwd(a)))

    im = np.asarray(plan.inv_mat(fm))
    assert im.shape == (n1, n2)
    assert np.array_equal(im.reshape(cfg.n), a)

    pm = np.asarray(plan.polymul_mat(a.reshape(n1, n2), b.reshape(n1, n2)))
    assert np.array_equal(pm.reshape(cfg.n), np.asarray(plan.polymul(a, b)))

    # flat-split plans have no matrix-form views
    assert build_goldilocks_plan(NTTConfig(field=GL, log_n=9)).fwd_mat is None


def test_gl_engine_cuda_raises():
    """There is no CUDA Goldilocks column pass: asking for it raises."""
    from ntt_aie.goldilocks_plan import build_goldilocks_plan

    cfg = NTTConfig(field=GL, log_n=9, rows_log2=4)
    with pytest.raises(ValueError, match="XLA engine only"):
        build_goldilocks_plan(cfg, engine="cuda")


def test_gl_context_matrix_form_surface(rng):
    """NTTContext's matrix-form delegates work for Goldilocks configs
    (uint64 matrices in/out through the limb conversion)."""
    from ntt_aie.api import NTTContext
    from ntt_aie.ops import modops as M

    cfg = NTTConfig(field=GL, log_n=9, rows_log2=4)
    ctx = NTTContext(cfg)
    n1, n2 = cfg.split
    a = _rand(rng, cfg.n)
    fm = np.asarray(ctx.forward_mat(a.reshape(n1, n2)))
    assert fm.shape == (n2, n1) and fm.dtype == np.uint64
    assert np.array_equal(fm.reshape(cfg.n), np.asarray(ctx.forward(a)))
    assert np.array_equal(np.asarray(ctx.inverse_mat(fm)).reshape(cfg.n), a)
    pm = np.asarray(ctx.polymul_mat(a.reshape(n1, n2), a.reshape(n1, n2)))
    assert np.array_equal(pm.reshape(cfg.n), np.asarray(ctx.polymul(a, a)))
    bat = ctx.make_batched(2)
    ab = np.stack([a, a])
    assert np.array_equal(
        np.asarray(M.gl_to_u64(*bat["fwd_mat"](
            tuple(v.reshape(2, n1, n2) for v in M.gl_from_u64(ab))))
        ).reshape(2, cfg.n),
        np.asarray(bat["fwd"](ab)))


def test_gl_batched_negacyclic(rng):
    """GL batched negacyclic: four-step (flat + matrix-form) and
    flat-split batch-to-lanes match the schoolbook."""
    from ntt_aie.goldilocks_plan import build_goldilocks_plan

    B = 2
    # four-step
    cfg = NTTConfig(field=GL, log_n=8, rows_log2=4, negacyclic=True)
    n1, n2 = cfg.split
    plan = build_goldilocks_plan(cfg)
    bat = plan.make_batched(B)
    a = np.stack([_rand(rng, cfg.n) for _ in range(B)])
    b = np.stack([_rand(rng, cfg.n) for _ in range(B)])
    got = np.asarray(bat["negacyclic_polymul"](a, b))
    for r in range(B):
        want = ref.schoolbook_negacyclic(a[r].astype(object),
                                         b[r].astype(object), GL.p)
        assert np.array_equal(got[r].astype(object), want.astype(object))
        assert np.array_equal(got[r],
                              np.asarray(plan.negacyclic_polymul(a[r], b[r])))
    gm = np.asarray(bat["negacyclic_polymul_mat"](a.reshape(B, n1, n2),
                                                  b.reshape(B, n1, n2)))
    assert np.array_equal(gm.reshape(B, cfg.n), got)
    # unbatched matrix view
    g1 = np.asarray(plan.negacyclic_polymul_mat(a[0].reshape(n1, n2),
                                                b[0].reshape(n1, n2)))
    assert np.array_equal(g1.reshape(cfg.n), got[0])

    # flat split (batch-to-lanes cores)
    cfg_f = NTTConfig(field=GL, log_n=7, negacyclic=True)
    assert cfg_f.split[1] == 1
    bat_f = build_goldilocks_plan(cfg_f).make_batched(B)
    af = np.stack([_rand(rng, cfg_f.n) for _ in range(B)])
    bf = np.stack([_rand(rng, cfg_f.n) for _ in range(B)])
    got_f = np.asarray(bat_f["negacyclic_polymul"](af, bf))
    for r in range(B):
        want = ref.schoolbook_negacyclic(af[r].astype(object),
                                         bf[r].astype(object), GL.p)
        assert np.array_equal(got_f[r].astype(object), want.astype(object))
