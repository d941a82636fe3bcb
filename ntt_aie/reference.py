"""NumPy golden oracles.

Two families:

1. **Reference-parity oracle** — the exact butterfly network of the
   reference's CPU oracle (reference src/test.cpp:34-60): iterative
   Gentleman-Sande butterflies with *increasing* stride t = 1, 2, ..., n/2,
   parameterized by a caller-supplied table indexed ``table[h+i]`` at each
   stage. With the reference's natural-order power table this reproduces the
   reference's committed behavior bit-exactly (SURVEY.md §0 critical
   finding: it is NOT a DFT with that table — bit-exactness is defined
   against the network-with-table, and we honor that here). Includes the
   16-block output permutation ``ANS_ORDER_16`` the AIE swap network
   produces (reference src/test.cpp:69-71, 212-219).

2. **True-NTT oracles** — textbook DIF (natural->bitrev) and DIT
   (bitrev->natural) transforms, the O(n^2) DFT ground truth, inverse, and
   cyclic/negacyclic polynomial multiplication. These define the semantics
   of the real framework API.

Everything here is small-scale host code used by tests and by the plan
builder; int64 NumPy for p < 2^31, object (bignum) for Goldilocks.
"""

from __future__ import annotations

import numpy as np

from ntt_aie.fields import PrimeField, modpow
from ntt_aie import twiddles as tw

# The fixed output block order of the reference's 16-tile swap network
# (reference src/test.cpp:69-71): device block i lands at position
# ANS_ORDER_16[i] of the oracle's block order.
ANS_ORDER_16 = np.array([0, 2, 1, 3, 8, 10, 9, 11, 4, 6, 5, 7, 12, 14, 13, 15])


def _work_dtype(p: int):
    return object if p >= (1 << 31) else np.int64


# ---------------------------------------------------------------------------
# 1. Reference-parity oracle
# ---------------------------------------------------------------------------

def reference_network(a, table, p: int, stages: int | None = None) -> np.ndarray:
    """The reference oracle's butterfly network (src/test.cpp:34-60), vectorized.

    Stage s (s = 0, 1, ...): m = n >> s, h = m/2 groups, stride t = 2^s;
    group i pairs elements (2t*i + jj, 2t*i + jj + t) for jj in [0, t) and
    applies GS butterfly (u+v, (u-v)*table[h+i]) mod p.

    Args:
      a: length-n input vector.
      table: length-n twiddle table; the reference feeds natural-order
        powers w^i (make_roots), but any table is legal — the network is
        defined for arbitrary tables.
      stages: run only stages 0..stages inclusive then return (the
        reference's ``test_stage`` partial-depth verification hook,
        src/test.cpp:55-57,66-67). None = full depth.
    """
    dt = _work_dtype(p)
    a = np.asarray(a).astype(dt).copy()
    table = np.asarray(table).astype(dt)
    n = len(a)
    t, idx, m = 1, 0, n
    while m > 1:
        h = m // 2
        x = a.reshape(h, 2, t)
        u = x[:, 0, :].copy()
        v = x[:, 1, :].copy()
        roots = table[h : h + h].reshape(h, 1)
        x[:, 0, :] = (u + v) % p
        x[:, 1, :] = ((u - v) % p) * roots % p
        a = x.reshape(n)
        if stages is not None and idx == stages:
            return a
        t <<= 1
        m >>= 1
        idx += 1
    return a


def reference_network_scalar(a, table, p: int, stage: int) -> np.ndarray:
    """Direct scalar transcription of the reference oracle's loop structure
    (src/test.cpp:34-60), kept as an independent cross-check of
    reference_network. O(n log n) python loop — small n only."""
    a = [int(v) for v in a]
    table = [int(v) for v in table]
    n = len(a)
    t, idx, m = 1, 0, n
    while m > 1:
        j1, h = 0, m // 2
        for i in range(h):
            j2 = j1 + t - 1
            for j in range(j1, j2 + 1):
                root = table[h + i]
                v0, v1 = a[j], a[j + t]
                a[j] = (v0 + v1) % p
                a[j + t] = ((v0 + p - v1) % p) * root % p
            j1 += 2 * t
        if idx == stage:
            return np.array(a, dtype=object)
        t <<= 1
        m >>= 1
        idx += 1
    return np.array(a, dtype=object)


def block_permute(a: np.ndarray, order: np.ndarray = ANS_ORDER_16) -> np.ndarray:
    """Apply the reference device's output block placement: oracle block i is
    found at device position order[i] (reference src/test.cpp:212-219)."""
    nb = len(order)
    n = len(a)
    bs = n // nb
    out = np.empty_like(a)
    for i in range(nb):
        out[order[i] * bs : order[i] * bs + bs] = a[i * bs : i * bs + bs]
    return out


def reference_device_output(a, field: PrimeField, n: int) -> np.ndarray:
    """End-to-end reference parity: what the reference device produces for
    input a — natural-order table, full-depth network, block permutation.
    (Equivalent to running reference test.exe with PASS, src/test.cpp:203-219.)
    """
    table = tw.power_table(field, n)
    full = reference_network(a, table, field.p)
    return block_permute(full)


# ---------------------------------------------------------------------------
# 2. True-NTT oracles
# ---------------------------------------------------------------------------

def naive_dft(a, field: PrimeField, *, inverse: bool = False) -> np.ndarray:
    """O(n^2) ground truth: A[k] = sum_j a[j] w^(jk) mod p."""
    a = np.asarray(a)
    n = len(a)
    p = field.p
    w = field.root_of_unity(n)
    if inverse:
        w = field.inv(w)
    out = np.zeros(n, dtype=object)
    for k in range(n):
        acc = 0
        wk = modpow(w, k, p)
        cur = 1
        for j in range(n):
            acc = (acc + int(a[j]) * cur) % p
            cur = (cur * wk) % p
        out[k] = acc
    if inverse:
        ninv = field.inv(n)
        out = out * ninv % p
    return out


def ntt_dif(a, field: PrimeField, *, inverse: bool = False, stages_tw=None) -> np.ndarray:
    """Gentleman-Sande DIF NTT: natural-order in, bit-reversed out.

    Stage s: t = n >> (s+1); reshape (blocks, 2, t); butterfly
    (u+v, (u-v) * w[jj]). Matches naive_dft up to bit-reversal of output.
    """
    dt = _work_dtype(field.p)
    a = np.asarray(a).astype(dt).copy()
    n = len(a)
    p = field.p
    if stages_tw is None:
        stages_tw = tw.dif_stage_twiddles(field, n, inverse=inverse)
    logn = n.bit_length() - 1
    for s in range(logn):
        t = n >> (s + 1)
        x = a.reshape(-1, 2, t)
        u = x[:, 0, :].copy()
        v = x[:, 1, :].copy()
        wv = stages_tw[s].astype(dt).reshape(1, t)
        x[:, 0, :] = (u + v) % p
        x[:, 1, :] = ((u - v) % p) * wv % p
        a = x.reshape(n)
    return a


def ntt_dit(a, field: PrimeField, *, inverse: bool = False, scale: bool = None,
            stages_tw=None) -> np.ndarray:
    """Cooley-Tukey DIT NTT: bit-reversed in, natural-order out.

    Stage s: t = 2^s; butterfly (u + w[jj]*v, u - w[jj]*v). With
    inverse=True and scale (default: scale=inverse) also multiplies by
    n^-1, making ntt_dit(ntt_dif(a), inverse=True) == a with no explicit
    bit-reversal anywhere (the classic DIF/DIT pairing).
    """
    dt = _work_dtype(field.p)
    a = np.asarray(a).astype(dt).copy()
    n = len(a)
    p = field.p
    if scale is None:
        scale = inverse
    if stages_tw is None:
        stages_tw = tw.dit_stage_twiddles(field, n, inverse=inverse)
    logn = n.bit_length() - 1
    for s in range(logn):
        t = 1 << s
        x = a.reshape(-1, 2, t)
        u = x[:, 0, :].copy()
        v = x[:, 1, :].copy()
        wv = stages_tw[s].astype(dt).reshape(1, t)
        wvv = v * wv % p
        x[:, 0, :] = (u + wvv) % p
        x[:, 1, :] = (u - wvv) % p
        a = x.reshape(n)
    if scale:
        ninv = field.inv(n)
        a = a * ninv % p
    return a


def ntt_forward(a, field: PrimeField) -> np.ndarray:
    """Natural in -> natural out forward NTT (DIF + bit-reversal)."""
    br = tw.bit_reverse_indices(len(a))
    return ntt_dif(a, field)[br]


def ntt_inverse(a, field: PrimeField) -> np.ndarray:
    """Natural in -> natural out inverse NTT (bit-reverse + DIT + 1/n)."""
    br = tw.bit_reverse_indices(len(a))
    return ntt_dit(np.asarray(a)[br], field, inverse=True)


def cyclic_polymul(a, b, field: PrimeField) -> np.ndarray:
    """c = a * b mod (X^n - 1): NTT -> pointwise -> INTT, bitrev-free."""
    p = field.p
    fa = ntt_dif(a, field)
    fb = ntt_dif(b, field)
    fc = fa * fb % p
    return ntt_dit(fc, field, inverse=True)


def negacyclic_polymul(a, b, field: PrimeField) -> np.ndarray:
    """c = a * b mod (X^n + 1): psi-scaled NTT (RLWE-style)."""
    p = field.p
    n = len(a)
    dt = _work_dtype(p)
    psi = tw.negacyclic_psi_powers(field, n).astype(dt)
    psi_inv = tw.negacyclic_psi_powers(field, n, inverse=True).astype(dt)
    ta = np.asarray(a).astype(dt) * psi % p
    tb = np.asarray(b).astype(dt) * psi % p
    tc = cyclic_polymul(ta, tb, field)
    return tc * psi_inv % p


def schoolbook_negacyclic(a, b, p: int) -> np.ndarray:
    """O(n^2) negacyclic convolution ground truth."""
    n = len(a)
    out = np.zeros(n, dtype=object)
    for i in range(n):
        ai = int(a[i])
        for j in range(n):
            k = i + j
            term = ai * int(b[j])
            if k < n:
                out[k] = (out[k] + term) % p
            else:
                out[k - n] = (out[k - n] - term) % p
    return out % p


def schoolbook_cyclic(a, b, p: int) -> np.ndarray:
    """O(n^2) cyclic convolution ground truth."""
    n = len(a)
    out = np.zeros(n, dtype=object)
    for i in range(n):
        ai = int(a[i])
        for j in range(n):
            out[(i + j) % n] = (out[(i + j) % n] + ai * int(b[j])) % p
    return out
