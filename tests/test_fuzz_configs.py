"""Seeded fuzz over the config space: every sampled (field, log_n, split,
ordering) must roundtrip and match the oracle. The reference tests
exactly one configuration on real hardware (SURVEY.md §4); this sweeps the
plan builder's whole parameter space in CI."""

import numpy as np
import pytest
import jax.numpy as jnp

from ntt_aie import fields as F
from ntt_aie import reference as ref
from ntt_aie.config import NTTConfig
from ntt_aie.plan import build_plan

FIELDS = [F.DILITHIUM, F.P_998244353, F.P_2013265921, F.P_469762049]


def _cases():
    rng = np.random.default_rng(20260816)
    for i in range(12):
        field = FIELDS[rng.integers(0, len(FIELDS))]
        log_n = int(rng.integers(4, 13))
        rows_log2 = int(rng.integers(1, log_n)) if rng.random() < 0.7 else None
        ordering = ["bitrev", "natural"][rng.integers(0, 2)]
        rng.integers(0, 2)  # keeps the case stream of earlier versions
        # explicit reduction override ~1/3 of the time (else 'auto',
        # which now resolves harvey4 for p < 2^29)
        red = "auto"
        if rng.random() < 0.33:
            opts = ["montgomery"]
            if field.p < (1 << 30) and field.p % 2 == 1:
                opts.append("harvey")
            if field.p < (1 << 29) and field.p % 2 == 1:
                opts.append("harvey4")
            red = opts[rng.integers(0, len(opts))]
        rng.random(), rng.random()  # (as above)
        yield pytest.param(field, log_n, rows_log2, ordering, red,
                           id=f"{i}-{field.name}-n{log_n}-r{rows_log2}-"
                              f"{ordering}-{red}")


@pytest.mark.parametrize(
    "field,log_n,rows_log2,ordering,red", _cases())
def test_fuzzed_config(field, log_n, rows_log2, ordering, red, rng):
    if (1 << log_n) > field.max_n:
        pytest.skip("n exceeds field")
    cfg = NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2,
                    ordering=ordering, reduction=red)
    plan = build_plan(cfg)
    a = rng.integers(0, field.p, cfg.n)
    aj = jnp.asarray(a, dtype=jnp.uint32)
    flat = np.asarray(plan.fwd(aj))
    assert flat.max() < field.p
    if ordering == "natural":
        want = ref.ntt_forward(a, field)
        assert np.array_equal(flat.astype(np.int64), want)
    else:
        pos = plan.spectral_to_natural
        assert np.array_equal(flat[pos].astype(np.int64), ref.ntt_forward(a, field))
    assert np.array_equal(np.asarray(plan.inv(jnp.asarray(flat))), a)


def test_config_json_roundtrip():
    cfg = NTTConfig(field=F.P_998244353, log_n=12, ordering="natural",
                    rows_log2=5, negacyclic=True)
    cfg2 = NTTConfig.from_json(cfg.to_json())
    assert cfg2 == cfg
    custom = NTTConfig(field=F.PrimeField(p=12289, g=11), log_n=8)
    assert NTTConfig.from_json(custom.to_json()).field.p == 12289


def _dist_cases():
    rng = np.random.default_rng(20260818)
    for i in range(6):
        field = FIELDS[rng.integers(0, len(FIELDS))]
        log_n = int(rng.integers(10, 14))
        hier = bool(rng.random() < 0.5)
        chunks = [1, 2][rng.integers(0, 2)]
        wfac = bool(rng.random() < 0.4)
        nega = bool(rng.random() < 0.4)
        yield pytest.param(field, log_n, hier, chunks, wfac, nega,
                           id=f"d{i}-{field.name}-n{log_n}"
                              f"{'-hier' if hier else ''}-c{chunks}"
                              f"{'-wfac' if wfac else ''}"
                              f"{'-nega' if nega else ''}")


@pytest.mark.parametrize("field,log_n,hier,chunks,wfac,nega", _dist_cases())
def test_fuzzed_distributed_config(field, log_n, hier, chunks, wfac, nega,
                                   rng):
    """Distributed plan space fuzz on the virtual mesh: every sampled
    (field, size, flat/hier topology, overlap chunking, twiddle mode,
    negacyclic) composition must match the single-chip plan bit-exactly."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    if (1 << log_n) > field.max_n:
        pytest.skip("n exceeds field")
    from ntt_aie.parallel.fourstep import build_distributed_plan
    from ntt_aie.parallel.mesh import make_mesh, make_mesh_hier

    D = 8
    rows_log2 = max(log_n // 2, 4)  # n1, n2 >= 16 both divide D
    if nega and (1 << (log_n + 1)) > field.max_n:
        nega = False  # negacyclic needs a primitive 2n-th root
    cfg = NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2,
                    num_shards=D, negacyclic=nega)
    if cfg.split[0] % (D * chunks):
        chunks = 1
    mesh = make_mesh_hier(2, 4) if hier else make_mesh(D)
    dist = build_distributed_plan(
        cfg, mesh, overlap_chunks=chunks,
        wmat_factored=wfac or None,
        hier_axes=("dcn", "ici") if hier else None)
    single = build_plan(cfg)
    a = rng.integers(0, field.p, cfg.n)
    aj = jnp.asarray(a, dtype=jnp.uint32)
    got = np.asarray(dist.fwd(dist.shard_input(a))).reshape(-1)
    want = np.asarray(single.fwd(aj))
    assert np.array_equal(got, want), "distributed fwd != single-chip"
    back = np.asarray(dist.inv(dist.shard_spectral(got))).reshape(-1)
    assert np.array_equal(back, a), "roundtrip"
    if nega:
        b = rng.integers(0, field.p, cfg.n)
        gn = np.asarray(dist.negacyclic_polymul(
            dist.shard_input(a), dist.shard_input(b))).reshape(-1)
        wn = np.asarray(single.negacyclic_polymul(
            aj, jnp.asarray(b, dtype=jnp.uint32)))
        assert np.array_equal(gn, wn), "negacyclic"
