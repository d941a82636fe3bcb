"""Twiddle-factor planning.

The reference broadcasts one full natural-order table ``table[i] = w^i`` to
every tile (reference src/test.cpp:27-32 generation; src/aie2.py:96-104
multicast FIFO) and indexes it per stage as ``table[h+i]``. That doesn't
scale to n = 2^24 (SURVEY.md §7 hard part 5), so this planner produces:

- the reference-compatible natural-order power table (for bit-exact parity),
- per-stage packed twiddle vectors for the DIF/DIT stage loops, laid out so a
  stage's multiply is a broadcast along the lane axis of the (rows, lanes)
  matrix layout (no gathers on device),
- four-step "super-twiddle" matrices w^(k1*j2) for the N = N1 x N2
  decomposition, sliced per shard,
- everything optionally premultiplied into Montgomery form so device-side
  mont_mul(standard_data, mont_twiddle) yields standard-form products.

All tables are computed in NumPy int64/object and delivered as uint32 (or
2 x uint32 limbs for Goldilocks).
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from ntt_aie.fields import PrimeField, modpow



def _tw_dtype(p: int):
    """Value-array dtype: int64 for word primes, uint64 for Goldilocks
    (every value < 2^64 is exact in uint64 — only the *arithmetic* needs
    wider math, which _gl_mulmod_vec supplies), Python bignum (object)
    for any other >= 63-bit prime."""
    if p < (1 << 62):
        return np.int64
    if p == (1 << 64) - (1 << 32) + 1:
        return np.uint64
    return object


_GL_P = np.uint64((1 << 64) - (1 << 32) + 1)


def _gl_mulmod_vec(a, b) -> np.ndarray:
    """Vectorized host mulmod for the Goldilocks prime on uint64 arrays —
    no Python-object math. 4 x 32-bit partial products assembled into a
    128-bit (hi, lo) pair with explicit carries, then reduced with
    2^64 = 2^32 - 1, 2^96 = -1: the exact algorithm of the native oracle
    (native/oracle.cc ntt_goldilocks_reduce128, cross-checked in
    tests/test_twiddle_cache.py). Replaces the object-array table builds
    that measured 3.3 s at n=2^22 (round-3 finding)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    s32 = np.uint64(32)
    ah, al = a >> s32, a & mask
    bh, bl = b >> s32, b & mask
    ll = al * bl
    hh = ah * bh
    hl = ah * bl
    mid = hl + al * bh                       # wraps; carry below
    mid_carry = (mid < hl).astype(np.uint64)  # in units of 2^96
    lo = ll + (mid << s32)                   # wraps; carry below
    lo_carry = (lo < ll).astype(np.uint64)
    hi = hh + (mid >> s32) + (mid_carry << s32) + lo_carry
    # reduce128 (oracle.cc:69-84): x = lo + n2*(2^32 - 1) - n3 (mod p)
    n3 = hi >> s32
    n2_ = hi & mask
    r = np.where(lo >= _GL_P, lo - _GL_P, lo)
    r = np.where(r < n3, r + _GL_P, r) - n3
    t1 = (n2_ << s32) - n2_
    s = r + t1
    s = np.where(s < r, s + mask, s)  # 2^64 wrap adds 2^32 - 1 back
    return np.where(s >= _GL_P, s - _GL_P, s)


def _vec_mulmod(field: PrimeField):
    """Elementwise host mulmod for this field's value arrays: plain uint64
    products for word primes (exact: p < 2^31), the limb algorithm above
    for Goldilocks, object math for anything else."""
    p = field.p
    if p < (1 << 31):
        pu = np.uint64(p)

        def mul(a, b):
            return np.asarray(a, np.uint64) * np.asarray(b, np.uint64) % pu

        return mul
    if p == int(_GL_P):
        return _gl_mulmod_vec
    return lambda a, b: (np.asarray(a, dtype=object)
                         * np.asarray(b, dtype=object)) % p


def _power_series(field: PrimeField, w: int, n: int) -> np.ndarray:
    """[w^i mod p for i in range(n)] by log-depth block doubling
    (out[m:2m] = out[:m] * w^m): contiguous vectorized mulmods, ~20x
    faster than a sequential scalar recurrence at the n=2^24 north-star
    shape. Valid for ANY w (associativity only) — including the
    reference-parity table's non-root w."""
    p = field.p
    mul = _vec_mulmod(field)
    dt = _tw_dtype(p)
    work = object if dt is object else np.uint64
    out = np.empty(n, dtype=work)
    out[0] = 1
    if n == 1:
        return out.astype(dt)
    cur = w % p  # w^m for the current block width m
    m = 1
    while m < n:
        step = min(m, n - m)
        out[m:m + step] = mul(out[:step], cur)
        m *= 2
        if m < n:
            cur = cur * cur % p
    return out if dt is object else out.astype(dt)


def power_table(field: PrimeField, n: int, *, inverse: bool = False) -> np.ndarray:
    """Natural-order table t[i] = w^i with w = g^((p-1)//n), as int64.

    This is exactly the reference's make_roots output (src/test.cpp:27-32) —
    including its *integer division* (p-1)/n: for the reference's committed
    config (p=3329, n=2048) n does not divide p-1, so w = g^1 = 3 is not a
    2048th root of unity at all. Bit-exact parity requires reproducing that
    (block doubling only needs associativity, so the quirk survives).
    Use root_of_unity()/dif_stage_twiddles() for true NTTs.
    """
    w = modpow(field.g, (field.p - 1) // n, field.p)
    if inverse:
        w = field.inv(w)
    return _power_series(field, w, n)


def bit_reverse_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation of [0, n)."""
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for _ in range(bits):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev


def dif_stage_twiddles(field: PrimeField, n: int, *, inverse: bool = False) -> list[np.ndarray]:
    """Twiddles for the Gentleman-Sande DIF NTT, natural in -> bit-reversed out.

    Stage s (s = 0..log2(n)-1) works at half-block size t = n >> (s+1); pairs
    (j, j+t) inside blocks of 2t; butterfly (u+v, (u-v)*w[jj]) with
    w[jj] = omega^(jj * 2^s) for jj in [0, t). Returns one int64 vector of
    length t per stage.
    """
    logn = n.bit_length() - 1
    w = field.root_of_unity(n)
    if inverse:
        w = field.inv(w)
    p = field.p
    stages = []
    for s in range(logn):
        t = n >> (s + 1)
        step = 1 << s
        stages.append(_power_series(field, modpow(w, step, p), t))
    return stages


def dit_stage_twiddles(field: PrimeField, n: int, *, inverse: bool = False) -> list[np.ndarray]:
    """Twiddles for the Cooley-Tukey DIT NTT, bit-reversed in -> natural out.

    Stage s works at half-block size t = 2^s; butterfly
    (u + w[jj]*v, u - w[jj]*v) with w[jj] = omega^(jj * n/(2t)).
    Returns one int64 vector of length t per stage.
    """
    logn = n.bit_length() - 1
    w = field.root_of_unity(n)
    if inverse:
        w = field.inv(w)
    p = field.p
    stages = []
    for s in range(logn):
        t = 1 << s
        step = n >> (s + 1)
        stages.append(_power_series(field, modpow(w, step, p), t))
    return stages


def pack_stage_twiddles(stages: list[np.ndarray], n: int) -> np.ndarray:
    """Pack per-stage vectors into one (logn, n//2) matrix, each stage's
    vector tiled to length n//2 so device code can slice row s without
    per-stage shapes. DIF stage s has length t = n>>(s+1): tile it
    (n//2)//t times (the tile repeats across blocks, matching broadcast
    semantics). DIT stage s has length t = 2^s: also tiles to n//2."""
    half = n // 2
    logn = n.bit_length() - 1
    out = np.zeros((logn, half), dtype=stages[0].dtype)
    for s, vec in enumerate(stages):
        reps = half // len(vec)
        out[s] = np.tile(vec, reps)
    return out


def root_powers(field: PrimeField, n: int) -> np.ndarray:
    """w^i for i in [0, n), w = field.root_of_unity(n) (_power_series:
    log-depth block doubling, ~20x faster than a sequential recurrence at
    the n=2^24 north-star shape; Goldilocks runs the vectorized limb
    mulmod instead of object math — round-4 fix for the 3.3 s GL table
    build)."""
    return _power_series(field, field.root_of_unity(n), n)


def fourstep_twiddle_matrix(
    field: PrimeField, n1: int, n2: int, *, inverse: bool = False,
    _pows: np.ndarray | None = None,
) -> np.ndarray:
    """The (n1, n2) matrix W[k1, j2] = omega_{n1*n2}^(k1*j2), int64.

    Used between the column-NTT and row-NTT passes of the four-step
    decomposition (SURVEY.md §5.7). Built as a gather from one shared
    power table: exponent (k1*j2) mod n is a mask (n is a power of two),
    and the inverse matrix is the same table at (n - e) mod n — so one
    table serves both directions (pass ``_pows=root_powers(field, n)``).
    """
    n = n1 * n2
    pows = root_powers(field, n) if _pows is None else _pows
    k1 = np.arange(n1, dtype=np.int64)
    j2 = np.arange(n2, dtype=np.int64)
    e = (k1[:, None] * j2[None, :]) & (n - 1)
    if inverse:
        e = (n - e) & (n - 1)
    return pows[e]


def nested_col_split(nn: int) -> int:
    """R for the nested R x S column decomposition (0 = plain DIF/DIT).

    SURVEY.md §7 hard part 2's prescription ("four-step even
    intra-chip"): with nn = R*S and the passthrough sub-rows merged INTO
    the stage tile, every stage's minor dims are (>= min(R, S), lanes) —
    no stage works on a stride below min(R, S). The CUDA column pass runs
    each R- or S-point sub-transform from registers.

    nn >= 256 so both factors are >= 16; below that at most two stages
    are narrow and the mid transpose + extra twiddle multiply don't pay.
    This changes the four-step plans' spectral order for nn >= 256
    columns (colperm) — a version-level change like a rows_log2 retune
    (config.py docstring caveat); spectral_positions stays the single
    source of truth.
    """
    if nn < 256:
        return 0
    return 1 << ((nn.bit_length() - 1) // 2)


def colperm(nn: int) -> np.ndarray:
    """Output row order sigma of one length-nn column transform: out row
    j holds X[sigma(j)]. Plain: bit reversal. Nested R x S: the composed
    order sigma(s*R + r) = brS(s)*R + brR(r). Both are involutions, so
    sigma doubles as natural->flat positions."""
    R = nested_col_split(nn)
    if not R:
        return bit_reverse_indices(nn)
    S = nn // R
    brR = bit_reverse_indices(R)
    brS = bit_reverse_indices(S)
    return (brS[:, None] * np.int64(R) + brR[None, :]).ravel()


def spectral_positions(n1: int, n2: int) -> np.ndarray:
    """pos such that natural[k] = flat[pos[k]] for the four-step plans'
    flat spectral output flat[c*n1 + r] = X[s2(c)*n1 + s1(r)], where
    s1/s2 are the column transforms' output orders (colperm — bit
    reversal for plain columns, the nested composite for nn >= 256).
    Flat path (n2 == 1): plain bit reversal (the flat engine never
    nests). pos is an involution (both conventions compose from
    involutions blockwise), so it converts in both directions."""
    if n2 == 1:
        return bit_reverse_indices(n1).astype(np.int32)
    s1 = colperm(n1)
    s2 = colperm(n2)
    # pos[c*n1 + r] = s2[c]*n1 + s1[r]: a broadcast, not a 16M-element
    # div/mod/gather (10x faster at the n=2^24 north-star shape).
    return (s2[:, None].astype(np.int32) * np.int32(n1)
            + s1[None, :].astype(np.int32)).ravel()


def col_network(field: PrimeField, nn: int, *, direction: str,
                inverse: bool = False) -> dict:
    """The complete stage schedule of one length-nn column transform —
    the single source every engine (XLA stage loops, the CUDA kernel)
    and both value widths compile from, so the spectral order cannot
    diverge between them.

    Plain (nested_col_split(nn) == 0): one phase of standard DIF/DIT
    stages; mid is None.

    Nested R x S: two phases whose stage twiddles are HOST-EXPANDED so
    the passthrough axis rides inside the stage tile (repeat by S in the
    R-phase, by R in the S-phase) — the expanded vector length always
    equals the network's (half * tl) reshape at its level, so the fused
    radix-2^K group machinery applies unchanged. Between the phases:
      DIF:  x *= wmid (flat (nn,) vector, rows r*S+s hold
            w_nn^(+-brR(r)*s)); then reshape(R,S,c) -> swap -> (S,R,c)
      DIT:  the functional mirror — transpose back (S,R,c)->(R,S,c),
            then x *= the SAME wmid built with the opposite exponent
            sign (the elementwise inverse).
    Unscaled like the plain stage loops: the whole colpass contributes
    an extra factor nn in the inverse direction, absorbed by the global
    1/n in iwmat exactly as before.

    Returns {"phases": [{"ts": [int, ...], "vecs": [np.ndarray, ...]}],
             "mid": None | {"wmid": (nn,) values, "kind": direction},
             "R": R, "S": S}.
    """
    R = nested_col_split(nn)
    if not R:
        gen = dif_stage_twiddles if direction == "dif" else dit_stage_twiddles
        vecs = gen(field, nn, inverse=inverse)
        logn = nn.bit_length() - 1
        ts = ([nn >> (s + 1) for s in range(logn)] if direction == "dif"
              else [1 << s for s in range(logn)])
        return {"phases": [{"ts": ts, "vecs": vecs}], "mid": None,
                "R": 0, "S": 0}
    S = nn // R
    logR, logS = R.bit_length() - 1, S.bit_length() - 1
    # wmid: w^(sgn * brR(r) * s) on the (R, S) row-major flat layout; the
    # sign follows the stage twiddles' sign (the DIT mirror of a forward
    # DIF pipeline inverts every factor, wmid included).
    w_nn = field.root_of_unity(nn)
    pows = _power_series(field, field.inv(w_nn) if inverse else w_nn, nn)
    e = (bit_reverse_indices(R)[:, None] * np.arange(S)[None, :]) & (nn - 1)
    wmid = pows[e].ravel()
    if direction == "dif":
        phases = [
            {"ts": [(R >> (s + 1)) * S for s in range(logR)],
             "vecs": [np.repeat(v, S) for v in
                      dif_stage_twiddles(field, R, inverse=inverse)]},
            {"ts": [(S >> (s + 1)) * R for s in range(logS)],
             "vecs": [np.repeat(v, R) for v in
                      dif_stage_twiddles(field, S, inverse=inverse)]},
        ]
    else:
        phases = [
            {"ts": [(1 << s) * R for s in range(logS)],
             "vecs": [np.repeat(v, R) for v in
                      dit_stage_twiddles(field, S, inverse=inverse)]},
            {"ts": [(1 << s) * S for s in range(logR)],
             "vecs": [np.repeat(v, S) for v in
                      dit_stage_twiddles(field, R, inverse=inverse)]},
        ]
    return {"phases": phases, "mid": {"wmid": wmid, "kind": direction},
            "R": R, "S": S}


def _build_fourstep_tables(field: PrimeField, n1: int, n2: int):
    n = n1 * n2
    n_inv = field.inv(n)
    # One shared power table; the pass-1 output row order (colperm: bit
    # reversal for plain columns, the nested composite for nn >= 256) is
    # folded into the exponent rows (pows[(s1(r)*j2) mod n] == W[s1(r),
    # j2]) and the inverse matrix reuses the same exponents at (n - e).
    pows = root_powers(field, n)
    k1r = colperm(n1).astype(np.int64)
    j2 = np.arange(n2, dtype=np.int64)
    e = (k1r[:, None] * j2[None, :]) & (n - 1)
    wmat = pows[e]
    iwmat = pows[(n - e) & (n - 1)]
    iwmat_scaled = _vec_mulmod(field)(iwmat, n_inv).astype(
        _tw_dtype(field.p), copy=False)
    return {
        "wmat": wmat,
        "iwmat_scaled": iwmat_scaled,
        "pos": spectral_positions(n1, n2),
        "n_inv": n_inv,
    }


# ---- fourstep_tables caching ------------------------------------------------
#
# Plan setup is dominated by this build (DESIGN.md §3: ~6 s at the n=2^24
# north-star shape even after the log-depth root_powers rebuild). The tables
# are pure functions of (p, g, n1, n2), so they cache safely at two levels:
#
#   - in-process LRU: repeated plan builds in one process (CLI verify+bench,
#     batched builders, the test suite) pay the build once per config. Cached
#     arrays are returned read-only so an accidental in-place mutation raises
#     instead of corrupting every later plan.
#   - on-disk (opt-in): NTT_AIE_TABLE_CACHE=<dir> persists the two twiddle
#     matrices across processes — a serving restart at n=2^24 then costs an
#     np.load + a sampled correctness check instead of the rebuild. Word
#     primes AND Goldilocks (since round 4: GL values are exact in uint64
#     for storage; only the arithmetic needs wide math). Loads are
#     validated by recomputing 8 deterministic sample entries with scalar
#     modpow — a corrupt or mismatched file falls back to a rebuild.
#
# The reference has no analog (its twiddle table is built at graph compile
# time and broadcast, src/aie2.py:96-104); this is serving-restart
# infrastructure for the large-n configs the reference never reaches.

_FOURSTEP_MEMO: OrderedDict = OrderedDict()
_FOURSTEP_MEMO_MAX = 8


def _freeze_tables(tabs: dict) -> dict:
    for v in tabs.values():
        if isinstance(v, np.ndarray):
            v.setflags(write=False)
    return tabs


def _fourstep_cache_path(field: PrimeField, n1: int, n2: int) -> str | None:
    # Goldilocks caches too since round 4: every value fits uint64 exactly
    # for STORAGE (only the arithmetic needs wide math). True bignum
    # primes (object dtype) would need pickle, which npz loads refuse.
    d = os.environ.get("NTT_AIE_TABLE_CACHE")
    if not d or _tw_dtype(field.p) is object:
        return None
    # _v2: round 4 changed the column order for nn >= 256 (nested columns)
    return os.path.join(d, f"fourstep_p{field.p}_g{field.g}_{n1}x{n2}_v2.npz")


def _fourstep_sample_check(field: PrimeField, n1: int, n2: int,
                           wmat: np.ndarray, iwmat_scaled: np.ndarray) -> bool:
    """Spot-check 8 deterministic entries of a loaded table pair against
    direct scalar modpow (the ground-truth definition, not the vectorized
    builder)."""
    n, p = n1 * n2, field.p
    w = field.root_of_unity(n)
    n_inv = field.inv(n)
    k1r = colperm(n1)
    rs = np.random.default_rng(n1 * 31 + n2)
    for _ in range(8):
        r, c = int(rs.integers(n1)), int(rs.integers(n2))
        e = (int(k1r[r]) * c) % n
        if int(wmat[r, c]) != modpow(w, e, p):
            return False
        if int(iwmat_scaled[r, c]) != modpow(w, (n - e) % n, p) * n_inv % p:
            return False
    return True


def fourstep_tables(field: PrimeField, n1: int, n2: int):
    """The four-step plan's host tables, shared by every plan builder
    (single-chip 32-bit, Goldilocks, distributed): returns a dict with

      wmat         — forward twiddle matrix with the pass-1 output bit
                     reversal baked into its rows (W[br1(r), j2]),
      iwmat_scaled — inverse matrix likewise, additionally folding 1/n,
      pos          — spectral_positions(n1, n2).

    Entries are int64 for word primes, Python objects for Goldilocks.
    Cached (in-process always; on disk when NTT_AIE_TABLE_CACHE is a
    directory) — returned arrays are read-only; copy before mutating.
    """
    key = (field.p, field.g, n1, n2)
    hit = _FOURSTEP_MEMO.get(key)
    if hit is not None:
        _FOURSTEP_MEMO.move_to_end(key)
        return hit

    tabs = None
    path = _fourstep_cache_path(field, n1, n2)
    if path is not None and os.path.exists(path):
        try:
            with np.load(path) as z:
                wmat = z["wmat"]
                iwmat_scaled = z["iwmat_scaled"]
            if (wmat.shape == (n1, n2) and iwmat_scaled.shape == (n1, n2)
                    and _fourstep_sample_check(field, n1, n2, wmat,
                                               iwmat_scaled)):
                tabs = {"wmat": wmat, "iwmat_scaled": iwmat_scaled,
                        "pos": spectral_positions(n1, n2),
                        "n_inv": field.inv(n1 * n2)}
        except Exception:
            tabs = None  # unreadable/corrupt file -> rebuild below

    if tabs is None:
        tabs = _build_fourstep_tables(field, n1, n2)
        if path is not None:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    np.savez(f, wmat=tabs["wmat"],
                             iwmat_scaled=tabs["iwmat_scaled"])
                os.replace(tmp, path)  # atomic: concurrent builders race safely
            except OSError:
                pass  # cache dir unwritable: serve the built tables anyway

    _FOURSTEP_MEMO[key] = _freeze_tables(tabs)
    while len(_FOURSTEP_MEMO) > _FOURSTEP_MEMO_MAX:
        _FOURSTEP_MEMO.popitem(last=False)
    return tabs


def fourstep_tables_light(field: PrimeField, n1: int, n2: int):
    """pos + n_inv only: the factored-twiddle plans (wmat_factored=True)
    apply the four-step multiply from fourstep_wfac_T's sqrt-size tables
    and never materialize the n1 x n2 matrices, so their setup skips the
    O(n) gather build and the 2 x n x 8 B host footprint (2 x 134 MB at
    the n=2^24 north-star shape)."""
    return {"pos": spectral_positions(n1, n2), "n_inv": field.inv(n1 * n2)}


def default_wfac_split(n2: int) -> int:
    """Balanced split for the factored four-step twiddle matrix:
    S ~ sqrt(n2) minimizes the summed table rows n2/S + S."""
    return 1 << ((n2.bit_length() - 1) // 2)


def fourstep_wfac_T(field: PrimeField, n1: int, n2: int, *,
                    inverse: bool = False, scale: int | None = None,
                    split: int | None = None,
                    _pows: np.ndarray | None = None):
    """Factored four-step twiddle matrix, TRANSPOSED orientation.

    The full matrix wmat.T[c, r] = W^(+-br1(r) * c) [* scale] (rows c are
    LINEAR in the exponent; the pass-1 bit reversal rides the lane axis r)
    factors over c = c1*S + c0 as T1[c1, r] * T2[c0, r] with

        T1[c1, r] = W^(+-br1(r) * S * c1)         shape (n2/S, n1)
        T2[c0, r] = W^(+-br1(r) * c0) [* scale]   shape (S, n1)

    Entrywise product mod p equals the full matrix (tested), so a kernel
    can apply the four-step twiddle multiply as TWO chained constant
    multiplies against (n2/S + S) * n1 table entries instead of n1 * n2 —
    ~sqrt(n2)/2 x less twiddle HBM traffic and host build. `scale` (e.g.
    1/n for the inverse) folds into T2. Spectral-order convention shared
    with fourstep_tables (the single source of truth, CLAUDE.md).

    The O(n) power table dominates this build; callers constructing
    several factored tables (fwd + inv + poly-inv) should build it once
    with root_powers(field, n) and pass it as ``_pows``.
    """
    n = n1 * n2
    S = split or default_wfac_split(n2)
    if n2 % S != 0:
        raise ValueError(f"split {S} must divide n2={n2}")
    pows = root_powers(field, n) if _pows is None else _pows
    k1r = colperm(n1).astype(np.int64)
    sgn = -1 if inverse else 1
    c1 = (np.arange(n2 // S, dtype=np.int64) * S)[:, None]
    c0 = np.arange(S, dtype=np.int64)[:, None]
    t1 = pows[(sgn * k1r[None, :] * c1) % n]
    t2 = pows[(sgn * k1r[None, :] * c0) % n]
    if scale is not None:
        t2 = _vec_mulmod(field)(t2, scale).astype(_tw_dtype(field.p),
                                                  copy=False)
    return np.ascontiguousarray(t1), np.ascontiguousarray(t2)


def negacyclic_psi_factors(field: PrimeField, n1: int, n2: int, *,
                           inverse: bool = False):
    """Rank-1 factorization of the negacyclic psi matrix: the (n1, n2)
    reshape of psi^i has psi^(r*n2 + c) = (psi^n2)^r * psi^c exactly, so
    it is row_factor[r] * col_factor[c] — two 1-D vectors (n1 + n2
    entries) replacing an n1*n2 matrix operand. Same psi convention as
    negacyclic_psi_powers (tested entrywise)."""
    n = n1 * n2
    psi = field.root_of_unity(2 * n)
    if inverse:
        psi = field.inv(psi)
    col = _power_series(field, psi, n2)
    row = _power_series(field, modpow(psi, n2, field.p), n1)
    return row, col


def negacyclic_psi_powers(field: PrimeField, n: int, *, inverse: bool = False) -> np.ndarray:
    """psi^i for i in [0, n) where psi is a primitive 2n-th root (psi^2 = omega).

    Pre/post-scaling vectors for negacyclic convolution (X^n + 1 quotient
    ring, RLWE-style; BASELINE.json config 3)."""
    psi = field.root_of_unity(2 * n)
    if inverse:
        psi = field.inv(psi)
    return _power_series(field, psi, n)


