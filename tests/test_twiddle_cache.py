"""fourstep_tables caching: in-process memo + opt-in on-disk persistence.

The tables are the dominant plan-setup cost (DESIGN.md §3); caching them
must never be able to serve wrong values — loads are sample-checked against
scalar modpow and corrupt files fall back to a rebuild.
"""

import numpy as np
import pytest

from ntt_aie import fields as F
from ntt_aie import twiddles as tw

FIELD = F.P_469762049


@pytest.fixture(autouse=True)
def _clear_memo():
    tw._FOURSTEP_MEMO.clear()
    yield
    tw._FOURSTEP_MEMO.clear()


def _assert_same_tables(a, b):
    assert np.array_equal(a["wmat"], b["wmat"])
    assert np.array_equal(a["iwmat_scaled"], b["iwmat_scaled"])
    assert np.array_equal(a["pos"], b["pos"])
    assert a["n_inv"] == b["n_inv"]


def test_memo_returns_identical_readonly_tables():
    t1 = tw.fourstep_tables(FIELD, 32, 16)
    t2 = tw.fourstep_tables(FIELD, 32, 16)
    assert t1 is t2
    for key in ("wmat", "iwmat_scaled", "pos"):
        assert not t1[key].flags.writeable
        with pytest.raises((ValueError, RuntimeError)):
            t1[key][0] = 0


def test_memo_eviction_bounded():
    for n2 in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024):
        tw.fourstep_tables(FIELD, 16, n2)
    assert len(tw._FOURSTEP_MEMO) <= tw._FOURSTEP_MEMO_MAX


def test_disk_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("NTT_AIE_TABLE_CACHE", str(tmp_path))
    built = tw.fourstep_tables(FIELD, 64, 32)
    files = list(tmp_path.glob("fourstep_*.npz"))
    assert len(files) == 1
    # Fresh process simulation: clear the memo, load from disk.
    tw._FOURSTEP_MEMO.clear()
    loaded = tw.fourstep_tables(FIELD, 64, 32)
    _assert_same_tables(built, loaded)
    # Uncached ground truth.
    _assert_same_tables(loaded, tw._build_fourstep_tables(FIELD, 64, 32))


def test_disk_cache_rejects_tampered_table(tmp_path, monkeypatch):
    monkeypatch.setenv("NTT_AIE_TABLE_CACHE", str(tmp_path))
    tw.fourstep_tables(FIELD, 64, 32)
    path = next(tmp_path.glob("fourstep_*.npz"))
    with np.load(path) as z:
        wmat = z["wmat"].copy()
        iwmat = z["iwmat_scaled"].copy()
    wmat += 1  # corrupt every entry so the sample check must trip
    with open(path, "wb") as f:
        np.savez(f, wmat=wmat, iwmat_scaled=iwmat)
    tw._FOURSTEP_MEMO.clear()
    tabs = tw.fourstep_tables(FIELD, 64, 32)
    _assert_same_tables(tabs, tw._build_fourstep_tables(FIELD, 64, 32))


def test_disk_cache_survives_garbage_file(tmp_path, monkeypatch):
    monkeypatch.setenv("NTT_AIE_TABLE_CACHE", str(tmp_path))
    path = tw._fourstep_cache_path(FIELD, 16, 8)
    with open(path, "wb") as f:
        f.write(b"not an npz")
    tabs = tw.fourstep_tables(FIELD, 16, 8)
    _assert_same_tables(tabs, tw._build_fourstep_tables(FIELD, 16, 8))


def test_goldilocks_disk_cache_roundtrip(tmp_path, monkeypatch):
    """GL tables cache on disk since round 4 (uint64 is exact for storage;
    only the arithmetic needs wide math)."""
    monkeypatch.setenv("NTT_AIE_TABLE_CACHE", str(tmp_path))
    assert tw._fourstep_cache_path(F.GOLDILOCKS, 32, 16) is not None
    t1 = tw.fourstep_tables(F.GOLDILOCKS, 32, 16)
    assert tw.fourstep_tables(F.GOLDILOCKS, 32, 16) is t1
    assert len(list(tmp_path.glob("*.npz"))) == 1
    tw._FOURSTEP_MEMO.clear()
    loaded = tw.fourstep_tables(F.GOLDILOCKS, 32, 16)
    _assert_same_tables(t1, loaded)
    ref = tw._build_fourstep_tables(F.GOLDILOCKS, 32, 16)
    _assert_same_tables(loaded, ref)
    assert loaded["wmat"].dtype == np.uint64


def test_gl_mulmod_vec_matches_native_oracle():
    """The vectorized host Goldilocks mulmod (the round-4 table-build
    engine) is bit-exact vs the native C++ scalar oracle, incl. edges."""
    pytest.importorskip("ctypes")
    from ntt_aie import native_oracle as native

    try:
        native.load()
    except native.NativeOracleUnavailable:
        pytest.skip("native oracle unavailable")
    p = F.GOLDILOCKS.p
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 64, 500, dtype=np.uint64) % np.uint64(p)
    b = rng.integers(0, 1 << 64, 500, dtype=np.uint64) % np.uint64(p)
    edges = np.array([0, 1, p - 1, p - 2, 1 << 32, (1 << 32) - 1,
                      (1 << 63) % p], dtype=np.uint64)
    a = np.concatenate([a, edges, edges])
    b = np.concatenate([b, edges, edges[::-1]])
    got = tw._gl_mulmod_vec(a, b)
    want = np.array([native.goldilocks_mulmod(int(x), int(y))
                     for x, y in zip(a, b)], dtype=np.uint64)
    assert np.array_equal(got, want)


def test_plans_tolerate_readonly_tables():
    """Every plan builder consumes the now-read-only cached tables; building
    fwd+inv+polymul end-to-end proves none of them mutate in place."""
    from ntt_aie.config import NTTConfig
    from ntt_aie.plan import build_plan

    cfg = NTTConfig(field=FIELD, log_n=10, rows_log2=5)
    plan = build_plan(cfg, engine="xla")
    rng = np.random.default_rng(7)
    a = rng.integers(0, FIELD.p, cfg.n).astype(np.uint32)
    b = rng.integers(0, FIELD.p, cfg.n).astype(np.uint32)
    x = np.asarray(plan.inv(plan.fwd(a)))
    assert np.array_equal(x, a)
    np.asarray(plan.polymul(a, b))  # exercises iwmat_poly derivation too
