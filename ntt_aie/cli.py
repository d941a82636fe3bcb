"""Command-line driver — the L3 CLI (reference src/test.cpp:62-248 +
README usage: one binary that dispatches the kernel, times it, and verifies
against the CPU oracle with a PASS/FAIL exit code).

    python -m ntt_aie info
    python -m ntt_aie verify --field P_2013265921 --log-n 12
    python -m ntt_aie verify --parity          # reference bit-exact mode
    python -m ntt_aie bench  --field P_469762049 --log-n 20 --batch 32
    python -m ntt_aie sweep  --field P_469762049 --log-ns 12-20 \
        --batches 1,8,64 --out profile/exectime
    python -m ntt_aie trace  --field P_469762049 --log-n 20
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ntt_aie import fields as F
from ntt_aie.config import NTTConfig


def _field(name: str):
    """Accept registry names ('p2013265921') and module attribute names
    ('P_2013265921', 'GOLDILOCKS'), case-insensitively."""
    key = name.lower().replace("_", "")
    for reg_name, f in F.FIELDS.items():
        if reg_name.lower().replace("_", "") == key:
            return f
    attr = getattr(F, name.upper(), None)
    if attr is not None:
        return attr
    sys.exit(f"unknown field {name!r}; choices: {', '.join(F.FIELDS)}")


def _rand_input(rng, field, n):
    if field.p >= (1 << 32):
        v = rng.integers(0, 1 << 32, n, dtype=np.uint64) << np.uint64(32)
        v |= rng.integers(0, 1 << 32, n, dtype=np.uint64)
        return (v % np.uint64(field.p)).astype(np.uint64)
    return rng.integers(0, field.p, n)


def cmd_info(args) -> int:
    import jax

    import ntt_aie

    print(f"ntt_aie {ntt_aie.__version__}")
    print(f"backend: {jax.default_backend()}  devices: {len(jax.devices())}")
    for d in jax.devices()[:4]:
        print(f"  {d.id}: {d.device_kind} ({d.platform})")
    print("fields:")
    for name, f in F.FIELDS.items():
        print(
            f"  {name:<14} p={f.p:<22} g={f.g:<3} max_n=2^{f.max_n.bit_length() - 1}"
            f"  reduction={f.default_reduction()}"
        )
    return 0


def _check(label: str, ok: bool, failures: list) -> None:
    print(f"  [{'PASS' if ok else 'FAIL'}] {label}")
    if not ok:
        failures.append(label)


def cmd_verify(args) -> int:
    """Device-vs-oracle verification (the reference's PASS/FAIL gate,
    src/test.cpp:221-247). Exit 0 on PASS, 1 on FAIL."""
    from ntt_aie import reference as ref
    from ntt_aie.api import NTTContext

    failures: list = []
    rng = np.random.default_rng(args.seed)

    if args.parity:
        # Reference bit-exact mode: p=3329, logN=11, a[i]=i, natural-order
        # table through the butterfly network + ANS_ORDER_16 block layout.
        cfg = NTTConfig(field=F.KYBER, log_n=11, table_convention="reference",
                        ordering="reference")
        ctx = NTTContext(cfg)
        a = np.arange(1 << 11)
        got = np.asarray(ctx.forward(np.asarray(a, dtype=np.uint32)))
        want = ref.reference_device_output(a, F.KYBER, 1 << 11)
        _check("reference device parity (logN=11, p=3329)",
               np.array_equal(got.astype(np.int64), want), failures)
    else:
        field = _field(args.field)
        cfg = NTTConfig(field=field, log_n=args.log_n, ordering="natural")
        ctx = NTTContext(cfg)
        a = _rand_input(rng, field, cfg.n)
        big = field.p >= (1 << 32)

        fwd = np.asarray(ctx.forward(a if big else np.asarray(a, dtype=np.uint32)))
        want = ref.ntt_forward(a.astype(object) if big else a, field)
        _check(f"forward vs oracle (n=2^{args.log_n})",
               np.array_equal(fwd.astype(object), want.astype(object)), failures)

        back = np.asarray(ctx.inverse(fwd))
        _check("inverse roundtrip", np.array_equal(back, a), failures)

        if args.log_n <= 12:
            b = _rand_input(rng, field, cfg.n)
            got = np.asarray(ctx.polymul(
                a if big else np.asarray(a, dtype=np.uint32),
                b if big else np.asarray(b, dtype=np.uint32)))
            wantp = ref.cyclic_polymul(
                a.astype(object) if big else a,
                b.astype(object) if big else b, field)
            _check("cyclic polymul vs oracle",
                   np.array_equal(got.astype(object), wantp.astype(object)),
                   failures)
            if 2 * cfg.n <= field.max_n and not big:
                # negacyclic (X^n + 1) gate — the RLWE product path
                nctx = NTTContext(NTTConfig(field=field, log_n=args.log_n,
                                            negacyclic=True))
                ngot = np.asarray(nctx.negacyclic_polymul(
                    np.asarray(a, dtype=np.uint32),
                    np.asarray(b, dtype=np.uint32)))
                nwant = ref.schoolbook_negacyclic(a, b, field.p)
                _check("negacyclic polymul vs schoolbook",
                       np.array_equal(ngot.astype(np.int64), nwant), failures)

        if field.p == 3329:
            # ML-KEM (FIPS 203) pipeline on device, gated by the NumPy
            # schoolbook AND (with --native) the C++ schoolbook oracle
            from ntt_aie import kyber as KY

            ka = rng.integers(0, 3329, 256)
            kb = rng.integers(0, 3329, 256)
            kgot = np.asarray(KY.kyber_polymul(ka.astype(np.uint32),
                                               kb.astype(np.uint32)))
            kwant = ref.schoolbook_negacyclic(ka, kb, 3329)
            _check("ML-KEM ring product vs schoolbook",
                   np.array_equal(kgot.astype(np.int64), kwant), failures)
            if args.native:
                import tempfile

                from ntt_aie import native_oracle as native

                with tempfile.NamedTemporaryFile(suffix=".nttv") as tf:
                    native.write_vectors(
                        tf.name, "negacyclic_schoolbook", 3329, 256, 0,
                        ka.astype(np.uint64), kgot.astype(np.uint64),
                        b=kb.astype(np.uint64))
                    _check("native C++ gate (nttverify, ML-KEM ring)",
                           native.run_verify_gate(tf.name), failures)

        if field.p == 8380417:
            # ML-DSA (FIPS 204) pipeline on device: complete 8-layer NTT,
            # pointwise product, inverse — gated by the NumPy schoolbook
            # AND (with --native) the C++ schoolbook oracle
            from ntt_aie import dilithium as DL

            da = rng.integers(0, DL.Q, 256)
            db = rng.integers(0, DL.Q, 256)
            dgot = np.asarray(DL.dilithium_polymul(da.astype(np.uint32),
                                                   db.astype(np.uint32)))
            dwant = ref.schoolbook_negacyclic(da, db, DL.Q)
            _check("ML-DSA ring product vs schoolbook",
                   np.array_equal(dgot.astype(np.int64), dwant), failures)
            if args.native:
                import tempfile

                from ntt_aie import native_oracle as native

                with tempfile.NamedTemporaryFile(suffix=".nttv") as tf:
                    native.write_vectors(
                        tf.name, "negacyclic_schoolbook", DL.Q, 256, 0,
                        da.astype(np.uint64), dgot.astype(np.uint64),
                        b=db.astype(np.uint64))
                    _check("native C++ gate (nttverify, ML-DSA ring)",
                           native.run_verify_gate(tf.name), failures)

        if args.native:
            # Independent native gate: dump (input, claimed) vectors and let
            # the separately-compiled C++ oracle re-derive and compare
            # (native/verify_main.cc; the reference's src/test.cpp:203-247
            # role with the oracle outside the Python process entirely).
            import tempfile

            from ntt_aie import native_oracle as native
            from ntt_aie import twiddles as tw_mod

            claimed_bitrev = fwd[tw_mod.bit_reverse_indices(cfg.n)]
            with tempfile.NamedTemporaryFile(suffix=".nttv") as tf:
                native.write_vectors(
                    tf.name, "forward", field.p, cfg.n,
                    field.root_of_unity(cfg.n),
                    a.astype(np.uint64), claimed_bitrev.astype(np.uint64))
                _check("native C++ gate (nttverify, forward)",
                       native.run_verify_gate(tf.name), failures)

    if failures:
        print("FAIL.")
        return 1
    print("PASS!")
    return 0


def cmd_bench(args) -> int:
    import jax.numpy as jnp

    from ntt_aie.plan import build_plan
    from ntt_aie.profiling import roofline
    from ntt_aie.utils.timing import time_device

    field = _field(args.field)
    cfg = NTTConfig(field=field, log_n=args.log_n)
    plan = build_plan(cfg, engine=args.engine)
    rng = np.random.default_rng(0)
    batched = plan.make_batched(args.batch)
    big = field.p >= (1 << 32)
    vals = rng.integers(0, min(field.p, 1 << 32), (args.batch, cfg.n))
    if big:
        from ntt_aie.ops import modops as M

        a = M.gl_from_u64(vals.astype(np.uint64))
    else:
        a = jnp.asarray(vals, dtype=jnp.uint32)

    if args.op == "polymul":
        pm = batched["polymul"]
        fn = lambda x: pm(x, x)  # noqa: E731  out shape == in shape
        transforms_per_call = 3 * args.batch  # 2 fwd + 1 inv per polymul
    else:
        fn = batched[args.op]
        transforms_per_call = args.batch
    res = time_device(fn, a, iters=args.iters, repeats=args.repeats)

    # ---- correctness gate, AFTER timing (the reference driver's
    # benchmark-then-verify structure, src/test.cpp:157-247): the TIMED
    # callable's output is element-compared against the golden oracle on
    # sampled batch rows. A kernel regression that breaks correctness
    # while improving time cannot survive a bench session.
    gate_ok = _gate_bench_output(plan, cfg, args.op, fn, a, vals, rng)

    measured = vpu_bfly = None
    if args.calibrate:
        measured = roofline.measure_peak()["measured_hbm_gbps"]
        if plan.reduction in ("harvey", "harvey4"):
            vpu_bfly = roofline.measure_vpu_peak(
                reduction=plan.reduction)["butterflies_per_sec"]
    rep = roofline.efficiency_report(
        res["us_per_iter"] / transforms_per_call * 1e-6, cfg.n,
        itemsize=8 if big else 4, measured_peak_gbps=measured,
        measured_vpu_bfly=vpu_bfly)
    rep.update(engine=plan.engine, reduction=plan.reduction,
               batch=args.batch, op=args.op, verified=gate_ok)
    del rep["hbm_bytes"]
    print(json.dumps(rep))
    if not gate_ok:
        print("FAIL: benchmarked output does not match the oracle",
              file=sys.stderr)
        return 1
    return 0


def _gate_bench_output(plan, cfg, op: str, fn, a, vals, rng) -> bool:
    """Oracle gate for cmd_bench's timed callable: re-run it once and
    element-compare sampled rows against the native C++ oracle (NumPy
    reference fallback). Handles all three ops and both value widths:

      fwd     — spectral output mapped to natural vs a forward NTT
      inv     — the random input rows are *read as spectral data*; the
                expected coefficients come from the oracle's inverse
      polymul — fn squares its input; vs the cyclic-convolution oracle
    """
    from ntt_aie import twiddles as tw_mod
    from ntt_aie.ops import modops as M

    field = cfg.field
    n, p = cfg.n, field.p
    big = p >= (1 << 32)
    B = vals.shape[0]
    nrows = min(3, B)
    rows = np.concatenate([[0], rng.choice(np.arange(1, B),
                                           size=nrows - 1, replace=False)]) \
        if B > 1 else np.array([0])

    out = fn(a)
    if big:
        out = M.gl_to_u64(*out)
    got = np.asarray(out)[rows].astype(np.uint64)

    pos = plan.spectral_to_natural
    brev = tw_mod.bit_reverse_indices(n)
    omega = field.root_of_unity(n)
    rv = vals[rows].astype(np.uint64)
    try:
        from ntt_aie import native_oracle as native

        if op == "fwd":
            want = native.ntt_dif_batch(rv, omega, p)[:, brev]
            got = got[:, pos]
        elif op == "inv":
            # row read as plan-spectral s: natural spectral S = s[pos];
            # DIT consumes DIF (bitrev) order, so feed S[brev]
            oinv = field.inv(omega)
            want = np.stack([native.ntt_dit(r[pos][brev], oinv, p, scale=True)
                             for r in rv])
        else:  # polymul (fn squares)
            want = np.stack([native.cyclic_polymul(r, r, omega, p)
                             for r in rv])
    except Exception:  # native toolchain unavailable: NumPy oracle fallback
        from ntt_aie import reference as ref

        dt = object if big else np.int64
        if op == "fwd":
            want = np.stack([ref.ntt_forward(r.astype(dt), field)
                             for r in rv]).astype(object)
            got = got[:, pos]
        elif op == "inv":
            want = np.stack([ref.ntt_inverse(r[pos].astype(dt), field)
                             for r in rv]).astype(object)
        else:
            want = np.stack([ref.cyclic_polymul(r.astype(dt), r.astype(dt),
                                                field)
                             for r in rv]).astype(object)
        return bool(np.array_equal(got.astype(object), want))
    return bool(np.array_equal(got, want.astype(np.uint64)))


def cmd_sweep(args) -> int:
    from ntt_aie.profiling.sweep import run_sweep

    lo, hi = (int(x) for x in args.log_ns.split("-"))
    batches = [int(x) for x in args.batches.split(",")]
    run_sweep(_field(args.field), range(lo, hi + 1), batches,
              engine=args.engine, iters=args.iters, out_dir=args.out)
    return 0


def cmd_trace(args) -> int:
    import os

    import jax.numpy as jnp

    from ntt_aie.plan import build_plan
    from ntt_aie.profiling.trace import capture_trace, summarize_trace

    field = _field(args.field)
    cfg = NTTConfig(field=field, log_n=args.log_n)
    plan = build_plan(cfg, engine=args.engine)
    rng = np.random.default_rng(0)
    big = field.p >= (1 << 32)
    vals = rng.integers(0, min(field.p, 1 << 32), cfg.n)
    if big:
        from ntt_aie.ops import modops as M

        a = M.gl_from_u64(vals.astype(np.uint64))
    else:
        a = jnp.asarray(vals, dtype=jnp.uint32)
    op = getattr(args, "op", "fwd")
    if op == "inv":
        traced, x0 = plan.inv, plan.fwd(a)
    elif op == "polymul":
        traced, x0 = (lambda v: plan.polymul(v, v)), a
    else:
        traced, x0 = plan.fwd, a
    d = capture_trace(traced, x0, trace_dir=args.out)
    print(f"trace written to {d}")
    rows = summarize_trace(d)
    if not rows:
        print("error: the profiler trace holds no device events",
              file=sys.stderr)
        return 1
    for row in rows:
        print(f"  {row['total_us']:10.2f} us  {row['op']}")
    derived = []
    if op in ("fwd", "inv"):
        from ntt_aie.profiling.roofline import derive_trace_counters

        # Per-pass stage counts in TIME order: forward runs the n1-point
        # columns first; the inverse mirror runs n2 first. The four-step
        # twiddle matrix (2 uint32 tables) rides the first pass.
        n1_, n2_ = cfg.split
        s1, s2 = n1_.bit_length() - 1, n2_.bit_length() - 1
        derived = derive_trace_counters(
            rows, n=cfg.n, itemsize=8 if big else 4,
            stages_per_pass=(s1, s2) if op == "fwd" else (s2, s1),
            pass_table_bytes=(2 * cfg.n * 4, 0))
        for d in derived:
            print(f"  derived {d['op']}: {d['gbf_per_sec']} Gbf/s "
                  f"{d['achieved_gbps']} GB/s")
    if args.summary_out:
        import jax

        payload = {
            "op": op,
            "field": field.name,
            "log_n": args.log_n,
            "engine": plan.engine,
            "device_kind": jax.devices()[0].device_kind,
            "backend": jax.default_backend(),
            "ops": rows,
        }
        if derived:
            payload["derived"] = derived
        os.makedirs(os.path.dirname(args.summary_out) or ".", exist_ok=True)
        with open(args.summary_out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"summary written to {args.summary_out}")
    return 0


def cmd_scaling(args) -> int:
    from ntt_aie.profiling.scaling import run_scaling

    counts = [int(x) for x in args.devices.split(",")]
    if args.full_wmat:
        wfac = False
    elif args.wmat_factored:
        wfac = True
    else:
        wfac = None  # builder default (factored, since round 4)
    rows = run_scaling(_field(args.field), args.log_n, counts,
                       mode=args.mode, batch=args.batch,
                       iters=args.iters, overlap_chunks=args.overlap_chunks,
                       topology=args.topology, wmat_factored=wfac,
                       hier_groups=args.hier_groups)
    print(json.dumps(rows))
    return 0


def cmd_plot(args) -> int:
    from ntt_aie.profiling import plots

    written = plots.render_all(args.summary, args.out)
    for p in written:
        print(p)
    return 0


def main(argv=None) -> int:
    from ntt_aie.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="ntt_aie", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info").set_defaults(fn=cmd_info)

    pv = sub.add_parser("verify")
    pv.add_argument("--field", default="P_2013265921")
    pv.add_argument("--log-n", type=int, default=12)
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--parity", action="store_true",
                    help="reference bit-exact parity mode")
    pv.add_argument("--native", action="store_true",
                    help="also run the standalone C++ nttverify gate")
    pv.set_defaults(fn=cmd_verify)

    pb = sub.add_parser("bench")
    pb.add_argument("--field", default="P_469762049")
    pb.add_argument("--log-n", type=int, default=20)
    pb.add_argument("--batch", type=int, default=32)
    pb.add_argument("--iters", type=int, default=20)
    pb.add_argument("--repeats", type=int, default=5)
    pb.add_argument("--engine", default="auto")
    pb.add_argument("--op", default="fwd", choices=["fwd", "inv", "polymul"])
    pb.add_argument("--calibrate", action="store_true",
                    help="measure this device's streaming memory peak AND "
                         "(for Harvey reductions) its ideal-conditions "
                         "butterfly rate, and report efficiency against "
                         "both")
    pb.set_defaults(fn=cmd_bench)

    ps = sub.add_parser("sweep")
    ps.add_argument("--field", default="P_469762049")
    ps.add_argument("--log-ns", default="12-20")
    ps.add_argument("--batches", default="1,8,64")
    ps.add_argument("--iters", type=int, default=20)
    ps.add_argument("--engine", default="auto")
    ps.add_argument("--out", default=None)
    ps.set_defaults(fn=cmd_sweep)

    pt = sub.add_parser("trace")
    pt.add_argument("--field", default="P_469762049")
    pt.add_argument("--log-n", type=int, default=18)
    pt.add_argument("--engine", default="auto")
    pt.add_argument("--op", default="fwd", choices=["fwd", "inv", "polymul"],
                    help="which pipeline to trace (inv/polymul localize "
                         "the DIT-pass cost)")
    pt.add_argument("--out", default=None)
    pt.add_argument("--summary-out", default=None,
                    help="write the per-op summary JSON here")
    pt.set_defaults(fn=cmd_trace)

    pc = sub.add_parser("scaling")
    pc.add_argument("--field", default="P_469762049")
    pc.add_argument("--log-n", type=int, default=18)
    pc.add_argument("--devices", default="1,2,4,8")
    pc.add_argument("--mode", default="strong", choices=["strong", "weak"])
    pc.add_argument("--batch", type=int, default=4)
    pc.add_argument("--iters", type=int, default=5)
    pc.add_argument("--overlap-chunks", type=int, default=1,
                    help="chunk the four-step transpose collective to "
                         "overlap it with local compute")
    pc.add_argument("--wmat-factored", action="store_true",
                    help="factored sqrt-size four-step twiddle tables "
                         "(the distributed default; flag kept for "
                         "explicitness)")
    pc.add_argument("--full-wmat", action="store_true",
                    help="force the full n1 x n2 twiddle matrices "
                         "(A/B comparison against the factored default)")
    pc.add_argument("--topology", default="fourstep",
                    choices=["fourstep", "pairwise"],
                    help="'pairwise' times the reference's per-stage "
                         "exchange topology for comparison")
    pc.add_argument("--hier-groups", type=int, default=1,
                    help="G > 1 runs fourstep cells on a (G, D/G) "
                         "two-level mesh with the hierarchical (DCN x "
                         "ICI) transpose decomposition")
    pc.set_defaults(fn=cmd_scaling)

    pp = sub.add_parser("plot")
    pp.add_argument("--summary", default="profile/exectime/summary_p469762049.csv")
    pp.add_argument("--out", default="profile/plots")
    pp.set_defaults(fn=cmd_plot)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
