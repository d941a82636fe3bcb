"""The CUDA column pass: its indexing emulated in NumPy, its host tables,
its engine selection, and (on the card only) the kernel itself.

The kernel has no interpret mode, so its tile, stage and twiddle indexing
is mirrored here line for line (_emulate_colpass follows
ops/cuda/colpass.cu: the same load map, shared-memory address function,
phase loops, stage offsets and Shoup arithmetic) and checked against the
XLA engine's column transform and the host oracle.
"""

import numpy as np
import pytest

from ntt_aie import NTTConfig, NTTContext, P_469762049, P_2013265921
from ntt_aie import twiddles as tw
from ntt_aie.ops import cuda_colpass as CC

M32 = np.uint64(0xFFFFFFFF)


def _mulc(x, pair, p):
    x = np.asarray(x, np.uint64)
    w = pair[..., 0].astype(np.uint64)
    ws = pair[..., 1].astype(np.uint64)
    q = (x * ws) >> np.uint64(32)
    r = ((x * w) - q * np.uint64(p)) & M32
    return _fold(r, p)


def _fold(x, p):
    return np.minimum(x, (x - np.uint64(p)) & M32)


def _dif(v, stw, p):
    # v: (N, ...) registers; stage s at offset N - 2t (colpass.cu dif)
    n = v.shape[0]
    for s in range(n.bit_length() - 1):
        t = n >> (s + 1)
        ts = stw[n - 2 * t:]
        for blk in range(0, n, 2 * t):
            for j in range(t):
                a, b = v[blk + j].copy(), v[blk + j + t].copy()
                v[blk + j] = _fold((a + b) & M32, p)
                v[blk + j + t] = _mulc((a - b + np.uint64(p)) & M32, ts[j], p)
    return v


def _dit(v, stw, p):
    n = v.shape[0]
    for s in range(n.bit_length() - 1):
        t = 1 << s
        ts = stw[t - 1:]
        for blk in range(0, n, 2 * t):
            for j in range(t):
                a = v[blk + j].copy()
                b = _mulc(v[blk + j + t], ts[j], p)
                v[blk + j] = _fold((a + b) & M32, p)
                v[blk + j + t] = _fold((a - b + np.uint64(p)) & M32, p)
    return v


def _phys(L, col, logs):
    r = L >> logs
    s = L & ((1 << logs) - 1)
    return ((L ^ (r & 1)) << 4) + (col ^ ((r ^ s) & 14))


def _emulate_colpass(x, field, nn, *, inverse, transpose_out=False,
                     pre=None, post=None):
    """colpass.cu's kernel, one thread block per (batch row, 16-column
    tile), with the block's threads vectorized."""
    p = field.p
    R, S = CC.split_rs(nn)
    logr, logs = R.bit_length() - 1, S.bit_length() - 1
    na, nb = (S, R) if inverse else (R, S)
    tabs = CC.colpass_tables(field, nn, inverse=inverse)
    stw, wmid = tabs[: na - 1 + nb - 1], tabs[na - 1 + nb - 1:]
    pre_p = CC.shoup_pairs(pre, p) if pre is not None else None
    post_p = CC.shoup_pairs(post, p) if post is not None else None
    bsz, rows, cols = x.shape
    assert rows == nn and cols % 16 == 0
    out = np.zeros((bsz, cols, nn) if transpose_out else x.shape, np.uint64)
    it = np.arange(nn * 16)
    cvec = np.arange(16)
    for b in range(bsz):
        for c0 in range(0, cols, 16):
            tile = np.zeros(nn * 16, np.uint64)
            row, col = it >> 4, it & 15
            v = x[b, row, c0 + col].astype(np.uint64)
            if pre_p is not None:
                v = _mulc(v, pre_p[row, c0 + col], p)
            L = (((row & (R - 1)) << logs) + (row >> logr)) if inverse else row
            tile[_phys(L, col, logs)] = v
            if not inverse:
                # phase A: per s, R-point DIF over r, then wmid
                rr = np.arange(R)[:, None, None]
                ss = np.arange(S)[None, :, None]
                Ls = rr * S + ss
                idx = _phys(Ls, cvec[None, None, :], logs)
                v = _dif(tile[idx], stw, p)
                tile[idx] = _mulc(v, wmid[Ls], p)
                # phase B: per r, S-point DIF over s
                idx = _phys(np.arange(S)[:, None, None] + S
                            * np.arange(R)[None, :, None],
                            cvec[None, None, :], logs)
                tile[idx] = _dif(tile[idx], stw[na - 1:], p)
            else:
                ss = np.arange(S)[:, None, None]
                rr = np.arange(R)[None, :, None]
                Ls = rr * S + ss
                idx = _phys(Ls, cvec[None, None, :], logs)
                v = _dit(tile[idx], stw, p)
                tile[idx] = _mulc(v, wmid[Ls], p)
                idx = _phys(np.arange(R)[:, None, None] * S
                            + np.arange(S)[None, :, None],
                            cvec[None, None, :], logs)
                tile[idx] = _dit(tile[idx], stw[na - 1:], p)
            if transpose_out:
                rest = it >> 5
                c = ((rest & 7) << 1) | ((it >> 4) & 1)
                j = ((rest >> 3) << 4) | (it & 15)
            else:
                j, c = it >> 4, it & 15
            L = j if inverse else (((j & (R - 1)) << logs) + (j >> logr))
            v = tile[_phys(L, c, logs)]
            if transpose_out:
                if post_p is not None:
                    v = _mulc(v, post_p[c0 + c, j], p)
                out[b, c0 + c, j] = v
            else:
                if post_p is not None:
                    v = _mulc(v, post_p[j, c0 + c], p)
                out[b, j, c0 + c] = v
    return out


def _xla_pass(x, field, nn, *, inverse, transpose_out=False, pre=None,
              post=None):
    import jax.numpy as jnp

    from ntt_aie.ops.colnet import make_col_transform
    from ntt_aie.ops.reductions import make_reduction, resolve_kind

    red = make_reduction(resolve_kind("auto", field), field)
    f = make_col_transform(field, nn, direction="dit" if inverse else "dif",
                           inverse=inverse, red=red)
    p = np.int64(field.p)
    outs = []
    for xb in np.asarray(x, np.int64):
        if pre is not None:
            xb = xb * pre % p
        y = np.asarray(red.canonicalize(f(jnp.asarray(xb, jnp.uint32))),
                       np.int64)
        if transpose_out:
            y = y.T
        if post is not None:
            y = y * post % p
        outs.append(y)
    return np.stack(outs)


@pytest.mark.parametrize("nn,cols", [(256, 16), (512, 32)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("transpose_out", [False, True])
def test_emulated_kernel_matches_xla_column_transform(nn, cols, inverse,
                                                      transpose_out):
    field = P_469762049
    rng = np.random.default_rng(nn + 2 * inverse + transpose_out)
    x = rng.integers(0, field.p, (2, nn, cols), dtype=np.int64)
    pre = rng.integers(0, field.p, (nn, cols), dtype=np.int64)
    oshape = (cols, nn) if transpose_out else (nn, cols)
    post = rng.integers(0, field.p, oshape, dtype=np.int64)
    got = _emulate_colpass(x, field, nn, inverse=inverse,
                           transpose_out=transpose_out, pre=pre, post=post)
    want = _xla_pass(x, field, nn, inverse=inverse,
                     transpose_out=transpose_out, pre=pre, post=post)
    assert np.array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("field", [P_469762049, P_2013265921],
                         ids=["p469762049", "p2013265921"])
def test_emulated_fourstep_matches_oracle(field):
    """The cuda engine's pass composition (plan.py) with emulated kernels:
    forward against the host oracle in the plan's spectral order, and the
    inverse back to the input."""
    n1 = n2 = 256
    cfg = NTTConfig(field=field, log_n=16, rows_log2=8)
    tabs = tw.fourstep_tables(field, n1, n2)
    rng = np.random.default_rng(7)
    a = rng.integers(0, field.p, cfg.n, dtype=np.int64)
    y = _emulate_colpass(a.reshape(1, n1, n2), field, n1, inverse=False,
                         transpose_out=True, post=tabs["wmat"].T)
    y = _emulate_colpass(y, field, n2, inverse=False)
    want = NTTContext(cfg).forward_host(a)
    assert np.array_equal(y.reshape(-1).astype(np.int64), want)
    z = _emulate_colpass(y, field, n2, inverse=True, transpose_out=True,
                         post=tabs["iwmat_scaled"])
    z = _emulate_colpass(z, field, n1, inverse=True)
    assert np.array_equal(z.reshape(-1).astype(np.int64), a)


def _warp_banks(addr_of_tid):
    """Banks touched by each warp for one access, given tid -> address."""
    tids = np.arange(256)
    banks = addr_of_tid(tids) % 32
    return banks.reshape(8, 32)


@pytest.mark.parametrize("logr,logs", [(4, 4), (4, 5), (5, 5), (5, 6)])
def test_smem_layout_bijective_and_conflict_free(logr, logs):
    R, S = 1 << logr, 1 << logs
    nn = R * S
    L = np.arange(nn)[:, None]
    col = np.arange(16)[None, :]
    addr = _phys(L, col, logs)
    assert np.array_equal(np.sort(addr.ravel()), np.arange(nn * 16))

    col_t, g0 = np.arange(256) & 15, np.arange(256) >> 4
    patterns = []
    for k in range(min(R, S)):
        # phases: rows k*S + g (consecutive) and g*S + k (stride S)
        patterns.append(lambda t, k=k: _phys(k * S + g0[t], col_t[t], logs))
        patterns.append(lambda t, k=k: _phys(g0[t] * S + k, col_t[t], logs))
    for base in range(0, nn * 16, 256 * 7):
        it = base + np.arange(256)
        j, c = it >> 4, it & 15
        jt = (((it >> 5) >> 3) << 4) | (it & 15)
        ct = (((it >> 5) & 7) << 1) | ((it >> 4) & 1)
        lmap = (((j & (R - 1)) << logs) + (j >> logr))
        lmap_t = (((jt & (R - 1)) << logs) + (jt >> logr))
        patterns += [lambda t, j=j, c=c: _phys(j[t], c[t], logs),
                     lambda t, m=lmap, c=c: _phys(m[t], c[t], logs),
                     lambda t, j=jt, c=ct: _phys(j[t], c[t], logs),
                     lambda t, m=lmap_t, c=ct: _phys(m[t], c[t], logs)]
    for pat in patterns:
        for warp in _warp_banks(pat):
            assert len(set(warp.tolist())) == 32


def test_colpass_tables_layout():
    for nn in CC.SUPPORTED_COLUMNS:
        R, S = CC.split_rs(nn)
        for inverse in (False, True):
            t = CC.colpass_tables(P_469762049, nn, inverse=inverse)
            assert t.shape == ((R - 1) + (S - 1) + nn, 2)
            assert t.dtype == np.uint32
            w = t[:, 0].astype(np.uint64)
            assert np.all(w < P_469762049.p)
            assert np.array_equal(
                t[:, 1], ((w << np.uint64(32))
                          // np.uint64(P_469762049.p)).astype(np.uint32))


def test_supports_shapes_and_primes():
    from ntt_aie import GOLDILOCKS

    assert CC.supports(P_469762049, 1024, 1024)
    assert CC.supports(P_2013265921, 256, 2048)
    assert not CC.supports(P_469762049, 128, 1024)
    assert not CC.supports(P_469762049, 4096, 4096)
    assert not CC.supports(GOLDILOCKS, 1024, 1024)


def test_cuda_engine_raises_without_gpu():
    from ntt_aie.plan import build_plan

    cfg = NTTConfig(field=P_469762049, log_n=16, rows_log2=8)
    with pytest.raises(RuntimeError, match="GPU"):
        build_plan(cfg, engine="cuda")


def test_cuda_engine_rejects_unsupported_split():
    from ntt_aie.plan import build_plan

    with pytest.raises(ValueError, match="CUDA column pass"):
        build_plan(NTTConfig(field=P_469762049, log_n=12, rows_log2=6),
                   engine="cuda")


def test_auto_engine_resolves_to_xla_on_cpu():
    from ntt_aie.plan import build_plan

    plan = build_plan(NTTConfig(field=P_469762049, log_n=16, rows_log2=8))
    assert plan.engine == "xla"


@pytest.mark.gpu
def test_cuda_engine_matches_xla_on_gpu(gpu):
    import jax.numpy as jnp

    from ntt_aie.plan import build_plan

    cfg = NTTConfig(field=P_469762049, log_n=18, rows_log2=9,
                    negacyclic=True)
    pc, px = build_plan(cfg, engine="cuda"), build_plan(cfg, engine="xla")
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.integers(0, cfg.field.p, (4, cfg.n)), jnp.uint32)
    b = jnp.asarray(rng.integers(0, cfg.field.p, (4, cfg.n)), jnp.uint32)
    bc, bx = pc.make_batched(4), px.make_batched(4)
    for key, args in (("fwd", (a,)), ("inv", (a,)), ("polymul", (a, b)),
                      ("negacyclic_polymul", (a, b))):
        assert np.array_equal(np.asarray(bc[key](*args)),
                              np.asarray(bx[key](*args))), key
