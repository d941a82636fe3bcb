"""Smoke run of the NTT system on NVIDIA GPUs, through the user entry points.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --four-gpus  # four GPUs: the sharded four-step only

Phases on one GPU, in one process:
  device   backend, device kind, JAX version, compile cache, card and
           power limit (nvidia-smi); fails unless JAX's backend is 'gpu'
  main     NTTContext at n=2^20 over p=469762049, batch 256 (1 GiB per
           operand): forward, inverse, cyclic and negacyclic polymul,
           checked against the native C++ oracle
  kernel   the CUDA column-pass engine against the XLA engine at the same
           shape: outputs bit-exact, device times from the profiler trace
  gputests the test suite's card-only tests (pytest -m gpu)
  gl       Goldilocks n=2^20, batch 16: forward rows vs the oracle, roundtrip
  pqc      ML-KEM-768 and ML-DSA-65 pipelines and serving steps vs
           schoolbook ring products
All arithmetic is exact integer arithmetic in uint32 lanes — no matrix
product and no float on any path — so every comparison is bit-exact
(tolerance 0) and TF32 does not arise. Any mismatch raises, and the run
exits non-zero. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_SEC = 3.35e12  # H100 SXM data sheet


def log(*args):
    print(*args, flush=True)


def check_device(need: int = 1):
    """Refuse anything but JAX's GPU backend with `need` devices."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU; JAX's default "
                         f"backend is {backend!r}")
    devs = jax.devices()
    if len(devs) < need:
        raise SystemExit(f"chip_smoke: needs {need} GPUs, JAX sees "
                         f"{len(devs)}")
    return devs


def phase_device(need: int) -> None:
    import jax

    devs = check_device(need)
    from ntt_aie.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] jax {jax.__version__}; devices: {devs}")
    log(f"[device] device_kind: {devs[0].device_kind}; compile cache: {cache}")
    log(f"[device] nvidia-smi name, power.limit: {smi}")


def _rand(seed: int, shape, p: int):
    """Uniform-ish values in [0, p) made on the device."""
    import jax
    import jax.numpy as jnp

    bits = jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)
    return bits % jnp.uint32(p)


def _timed(fn, *args):
    """(result, seconds) of one blocking call — the cold call compiles."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _warm_ms(fn, x, iters: int = 5, repeats: int = 3) -> float:
    from ntt_aie.utils.timing import time_device

    return time_device(fn, x, iters=iters, repeats=repeats)["us_per_iter"] / 1e3


def device_profile(fn, *args, calls: int = 3) -> dict:
    """Device busy time and kernels per call of fn(*args), read from a
    profiler trace of `calls` warm calls."""
    import jax

    from ntt_aie.profiling.trace import busy_ns, device_events, kernel_events

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(calls):
                jax.block_until_ready(fn(*args))
        ev = device_events(d)
    kev = kernel_events(ev)
    if not kev:
        raise RuntimeError("profiler trace holds no device kernel events")
    names: dict = {}
    for e in kev:
        t = names.setdefault(e["name"], [0, 0.0])
        t[0] += 1
        t[1] += e["dur_ns"]
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:8]
    return {"busy_ms": busy_ns(ev) / calls / 1e6,
            "kernels_per_call": len(kev) / calls,
            "top": [(k[:60], v[0] // calls, round(v[1] / calls / 1e6, 4))
                    for k, v in top]}


def _oracle_rows(kind: str, rows, field, n: int, b_rows=None):
    """Native C++ oracle for host rows (NumPy reference if it cannot
    build): 'fwd' natural-order forward, 'cyc'/'neg' polymul."""
    p = field.p
    try:
        from ntt_aie import native_oracle as native
        from ntt_aie import twiddles as tw

        omega = field.root_of_unity(n)
        if kind == "fwd":
            brev = tw.bit_reverse_indices(n)
            return native.ntt_dif_batch(rows.astype(np.uint64), omega,
                                        p)[:, brev]
        if kind == "cyc":
            return np.stack([native.cyclic_polymul(a, b, omega, p)
                             for a, b in zip(rows, b_rows)])
        psi = field.root_of_unity(2 * n)
        return np.stack([native.negacyclic_polymul(a, b, psi, p)
                         for a, b in zip(rows, b_rows)])
    except Exception as e:  # noqa: BLE001 — toolchain missing: fall back
        from ntt_aie import reference as ref

        log(f"  (native oracle unavailable: {e}; NumPy reference)")
        fn = {"fwd": lambda a, b: ref.ntt_forward(a, field),
              "cyc": lambda a, b: ref.cyclic_polymul(a, b, field),
              "neg": lambda a, b: ref.negacyclic_polymul(a, b, field)}[kind]
        b_rows = rows if b_rows is None else b_rows
        return np.stack([np.asarray(fn(a.astype(np.int64),
                                       b.astype(np.int64)), np.uint64)
                         for a, b in zip(rows, b_rows)])


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"MISMATCH: {what}")
    log(f"  ok: {what}")


def phase_main(B: int = 256, log_n: int = 20) -> None:
    import jax.numpy as jnp

    from ntt_aie import NTTConfig, NTTContext, P_469762049 as field

    n, p = 1 << log_n, field.p
    rng = np.random.default_rng(1)
    cfg = NTTConfig(field=field, log_n=log_n)
    ctx = NTTContext(cfg)
    ctx_n = NTTContext(NTTConfig(field=field, log_n=log_n, negacyclic=True))
    bat, batn = ctx.make_batched(B), ctx_n.make_batched(B)
    log(f"[main] n=2^{log_n} p={p} batch {B} split {cfg.split} "
        f"engine {ctx.plan.engine}")
    x, x2 = _rand(10, (B, n), p), _rand(11, (B, n), p)
    rows = np.concatenate([[0], rng.choice(np.arange(1, B), min(8, B - 1),
                                           replace=False)])
    xa, xb = np.asarray(x[rows]), np.asarray(x2[rows])

    y, cold = _timed(bat["fwd"], x)
    got = np.asarray(y[rows])[:, ctx.plan.spectral_to_natural]
    _expect(np.array_equal(got.astype(np.uint64),
                           _oracle_rows("fwd", xa, field, n)),
            f"fwd rows {rows.tolist()} == native oracle")
    log(f"  fwd: cold {cold:.3f} s, warm {_warm_ms(bat['fwd'], x):.3f} ms"
        f"/call")

    z, cold = _timed(bat["inv"], y)
    _expect(bool(jnp.array_equal(z, x)), "inv(fwd(x)) == x, whole batch")
    log(f"  inv: cold {cold:.3f} s, warm {_warm_ms(bat['inv'], y):.3f} ms"
        f"/call")
    del y, z

    for key, b, kind in (("polymul", bat, "cyc"),
                         ("negacyclic_polymul", batn, "neg")):
        c, cold = _timed(b[key], x, x2)
        k = rows[:3]
        _expect(np.array_equal(np.asarray(c[k]).astype(np.uint64),
                               _oracle_rows(kind, xa[:3], field, n,
                                            xb[:3])),
                f"{key} rows {k.tolist()} == native oracle")
        warm = _warm_ms(lambda v, f=b[key]: f(v, x2), x)
        log(f"  {key}: cold {cold:.3f} s, warm {warm:.3f} ms/call")
        del c


def phase_kernel(B: int = 256, log_n: int = 20) -> None:
    import jax.numpy as jnp

    from ntt_aie import NTTConfig, P_469762049 as field
    from ntt_aie.plan import build_plan

    n, p = 1 << log_n, field.p
    cfg = NTTConfig(field=field, log_n=log_n)
    x, x2 = _rand(20, (B, n), p), _rand(21, (B, n), p)
    bats = {e: build_plan(cfg, engine=e).make_batched(B)
            for e in ("cuda", "xla")}
    ops = {"fwd": (x,), "inv": (x,), "polymul": (x, x2)}
    log(f"[kernel] CUDA column pass vs XLA engine, n=2^{log_n} batch {B}")
    for op, args in ops.items():
        out = {e: bats[e][op](*args) for e in bats}
        _expect(bool(jnp.array_equal(out["cuda"], out["xla"])),
                f"{op}: cuda == xla, whole batch")
        del out
    floor_ms = 2 * 2 * B * n * 4 / HBM_BYTES_PER_SEC * 1e3
    summary = {}
    for op, args in ops.items():
        for e in bats:
            prof = device_profile(bats[e][op], *args)
            summary[f"{e}_{op}"] = prof
            log(f"  {e:4s} {op:7s}: device {prof['busy_ms']:.3f} ms/call, "
                f"{prof['kernels_per_call']:.0f} kernels/call")
            if op == "fwd":
                for name, cnt, ms in prof["top"]:
                    log(f"      {cnt:4d} x {ms:8.4f} ms  {name}")
    for op in ops:
        c, x_ = summary[f"cuda_{op}"]["busy_ms"], summary[f"xla_{op}"]["busy_ms"]
        log(f"  {op}: cuda {c:.3f} ms vs xla {x_:.3f} ms device time "
            f"({x_ / c:.2f}x)")
    log(f"  memory floor of a two-pass forward (4 x {B * n * 4 >> 20} MiB "
        f"at 3.35 TB/s): {floor_ms:.3f} ms")


def phase_gputests() -> None:
    import pytest

    os.environ["NTT_AIE_TEST_DEVICE"] = "gpu"
    log("[gputests] pytest -m gpu")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-o", "addopts=", os.path.join(ROOT, "tests")])
    if rc != 0:
        raise AssertionError(f"card-only tests failed (pytest rc {rc})")
    log("  ok: card-only tests pass")


def phase_gl(B: int = 16, log_n: int = 20) -> None:
    import jax.numpy as jnp

    from ntt_aie import GOLDILOCKS as field, NTTConfig, NTTContext
    from ntt_aie import twiddles as tw

    n, p = 1 << log_n, field.p
    rng = np.random.default_rng(3)
    ctx = NTTContext(NTTConfig(field=field, log_n=log_n))
    bat = ctx.make_batched(B)
    log(f"[gl] Goldilocks n=2^{log_n} batch {B} split {ctx.config.split} "
        f"engine {ctx.plan.engine}")
    v = rng.integers(0, 1 << 63, (B, n), dtype=np.uint64) % np.uint64(p)
    hl = (jnp.asarray((v >> np.uint64(32)).astype(np.uint32)),
          jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    y, cold = _timed(bat["fwd"], hl)
    rows = np.array([0, int(rng.integers(1, B))])
    got = ((np.asarray(y[0][rows]).astype(np.uint64) << np.uint64(32))
           | np.asarray(y[1][rows]).astype(np.uint64))
    got = got[:, ctx.plan.spectral_to_natural]
    try:
        from ntt_aie import native_oracle as native

        brev = tw.bit_reverse_indices(n)
        want = np.stack([native.ntt_dif(v[r], field.root_of_unity(n),
                                        p)[brev] for r in rows])
    except Exception as e:  # noqa: BLE001
        from ntt_aie import reference as ref

        log(f"  (native oracle unavailable: {e}; NumPy reference)")
        want = np.stack([np.asarray(ref.ntt_forward(v[r].astype(object),
                                                    field), np.uint64)
                         for r in rows])
    _expect(np.array_equal(got, want),
            f"GL fwd rows {rows.tolist()} == oracle")
    z, _ = _timed(bat["inv"], y)
    _expect(bool(jnp.array_equal(z[0], hl[0]) and jnp.array_equal(z[1], hl[1])),
            "GL inv(fwd(x)) == x, whole batch")
    prof = device_profile(bat["fwd"], hl)
    log(f"  GL fwd: cold {cold:.3f} s, warm {_warm_ms(bat['fwd'], hl):.3f} "
        f"ms/call, device {prof['busy_ms']:.3f} ms/call "
        f"({prof['busy_ms'] / B * 1e3:.1f} us/NTT), "
        f"{prof['kernels_per_call']:.0f} kernels/call")


def phase_pqc() -> None:
    import jax.numpy as jnp

    from ntt_aie import dilithium as DL, kyber as KY
    from ntt_aie import reference as ref

    rng = np.random.default_rng(4)
    for name, mod, q, (k, l) in (("ML-KEM-768", KY, KY.Q, (3, 3)),
                                 ("ML-DSA-65", DL, DL.Q, (6, 5))):
        pipe = mod.make_pipeline()
        B = 8192
        f = rng.integers(0, q, (B, 256)).astype(np.uint32)
        g = rng.integers(0, q, (B, 256)).astype(np.uint32)
        fh, cold = _timed(pipe["ntt"], jnp.asarray(f))
        back = np.asarray(pipe["intt"](fh))
        _expect(np.array_equal(back, f),
                f"{name}: intt(ntt(f)) == f, batch {B}")
        c, _ = _timed(pipe["polymul"], jnp.asarray(f), jnp.asarray(g))
        c = np.asarray(c)
        rows = [0, int(rng.integers(1, B))]
        _expect(all(np.array_equal(c[r].astype(np.int64),
                                   ref.schoolbook_negacyclic(f[r], g[r], q))
                    for r in rows),
                f"{name}: polymul rows {rows} == schoolbook")
        ms = _warm_ms(lambda v, fn=pipe["polymul"], gg=jnp.asarray(g):
                      fn(v, gg), jnp.asarray(f))
        log(f"  {name} ring product, batch {B}: {ms:.3f} ms/call "
            f"({B / ms * 1e3:.0f} op/s)")
        Bs = 1024
        A = rng.integers(0, q, (k, l, 256)).astype(np.uint32)
        X = rng.integers(0, q, (Bs, l, 256)).astype(np.uint32)
        step = pipe["make_serving_step"](pipe["ntt"](jnp.asarray(A)))
        out, _ = _timed(step, jnp.asarray(X))
        out = np.asarray(out)
        for r in (0, Bs - 1):
            for i in range(k):
                want = np.zeros(256, np.int64)
                for j in range(l):
                    want = (want + ref.schoolbook_negacyclic(
                        A[i, j], X[r, j], q)) % q
                if not np.array_equal(out[r, i].astype(np.int64), want):
                    raise AssertionError(f"MISMATCH: {name} serving row {r}")
        log(f"  ok: {name} serving step ({k}x{l}, batch {Bs}) rows 0, "
            f"{Bs - 1} == schoolbook")
        ms = _warm_ms(lambda v, s=step, xx=jnp.asarray(X): s(xx),
                      jnp.asarray(X))
        log(f"  {name} serving step: {ms:.3f} ms/call "
            f"({Bs / ms * 1e3:.0f} ops/s)")


def phase_four_gpus(log_n: int = 24, gl_log_n: int = 20) -> None:
    """The sharded four-step on four GPUs against the single-GPU plan."""
    import jax.numpy as jnp

    from ntt_aie import GOLDILOCKS, NTTConfig, P_469762049 as field
    from ntt_aie import native_oracle as native
    from ntt_aie import twiddles as tw
    from ntt_aie.parallel.fourstep import (build_distributed_plan,
                                           build_gl_distributed_plan)
    from ntt_aie.parallel.mesh import make_mesh
    from ntt_aie.plan import build_plan

    mesh = make_mesh(4)
    rng = np.random.default_rng(5)
    n, p = 1 << log_n, field.p
    a = rng.integers(0, p, n, dtype=np.int64).astype(np.uint32)
    b = rng.integers(0, p, n, dtype=np.int64).astype(np.uint32)
    for nega in (False, True):
        cfg = NTTConfig(field=field, log_n=log_n, rows_log2=log_n // 2,
                        num_shards=4, negacyclic=nega)
        dplan = build_distributed_plan(cfg, mesh)
        single = build_plan(NTTConfig(field=field, log_n=log_n,
                                      rows_log2=log_n // 2, negacyclic=nega))
        log(f"[four-gpus] n=2^{log_n} split {cfg.split} negacyclic={nega} "
            f"wmat_factored={dplan.wmat_factored}")
        xa, xb = dplan.shard_input(a), dplan.shard_input(b)
        if not nega:
            s, cold = _timed(dplan.fwd, xa)
            _expect(len(s.sharding.device_set) == 4,
                    f"forward output lives on {len(s.sharding.device_set)} "
                    "devices")
            ref1 = np.asarray(single.fwd(jnp.asarray(a)))
            flat = np.asarray(s).reshape(-1)
            _expect(np.array_equal(flat, ref1),
                    "sharded fwd == single-GPU fwd")
            brev = tw.bit_reverse_indices(n)
            want = native.ntt_dif(a, field.root_of_unity(n), p)[brev]
            _expect(np.array_equal(flat[dplan.spectral_to_natural]
                                   .astype(np.uint64), want),
                    "sharded fwd == native oracle")
            back = dplan.inv(s)
            _expect(np.array_equal(np.asarray(back).reshape(-1), a),
                    "sharded inv(fwd(a)) == a")
            log(f"  fwd cold {cold:.3f} s, warm "
                f"{_warm_ms(lambda v: dplan.inv(dplan.fwd(v)), xa) / 2:.3f} "
                f"ms per transform (fwd+inv chain / 2)")
            c = dplan.polymul(xa, xb)
            _expect(np.array_equal(np.asarray(c).reshape(-1),
                                   np.asarray(single.polymul(
                                       jnp.asarray(a), jnp.asarray(b)))),
                    "sharded cyclic polymul == single-GPU polymul")
        else:
            c = dplan.negacyclic_polymul(xa, xb)
            _expect(len(c.sharding.device_set) == 4,
                    "negacyclic output lives on 4 devices")
            _expect(np.array_equal(np.asarray(c).reshape(-1),
                                   np.asarray(single.negacyclic_polymul(
                                       jnp.asarray(a), jnp.asarray(b)))),
                    "sharded negacyclic polymul == single-GPU")

    gcfg = NTTConfig(field=GOLDILOCKS, log_n=gl_log_n,
                     rows_log2=gl_log_n // 2, num_shards=4)
    gplan = build_gl_distributed_plan(gcfg, mesh)
    gsingle = build_plan(NTTConfig(field=GOLDILOCKS, log_n=gl_log_n,
                                   rows_log2=gl_log_n // 2))
    log(f"[four-gpus] Goldilocks n=2^{gl_log_n} split {gcfg.split}")
    v = rng.integers(0, 1 << 63, 1 << gl_log_n, dtype=np.uint64) \
        % np.uint64(GOLDILOCKS.p)
    h, l = gplan.fwd(gplan.shard_input(v))
    _expect(len(h.sharding.device_set) == 4, "GL output lives on 4 devices")
    flat = ((np.asarray(h).reshape(-1).astype(np.uint64) << np.uint64(32))
            | np.asarray(l).reshape(-1).astype(np.uint64))
    _expect(np.array_equal(flat, gsingle.fwd(v)),
            "GL sharded fwd == single-GPU GL fwd")
    bh, bl = gplan.inv((h, l))
    back = ((np.asarray(bh).reshape(-1).astype(np.uint64) << np.uint64(32))
            | np.asarray(bl).reshape(-1).astype(np.uint64))
    _expect(np.array_equal(back, v), "GL sharded roundtrip")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded four-step on four GPUs")
    args = ap.parse_args(argv)
    need = 4 if args.four_gpus else 1
    phase_device(need)
    if args.four_gpus:
        phase_four_gpus()
    else:
        phase_main()
        phase_kernel()
        phase_gputests()
        phase_gl()
        phase_pqc()
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
