"""Benchmark sweep harness -> reference-format CSVs.

The reference's profile/exectime/ data is a grid of configs
(ntt_{cores}core_logn{7..13}.csv, 10 raw timings per file) collected by hand
from rebuilt binaries (SURVEY.md §5.6). Here the grid is a function call:
each (log_n, batch) cell builds a plan, times the batched forward transform
on device (chained-iteration methodology, utils/timing.py), and writes

- one raw-runs CSV per cell (reference file format: one µs value per line),
- one dummy_{field}.csv dispatch-overhead baseline (the reference's
  empty-kernel dummy.csv, profile/plot_exectime.py:36-41 — absent from its
  tree; here it is generated with every sweep),
- one summary_{field}.csv with derived throughput/roofline columns,
  including net-of-dispatch time and efficiency against BOTH the
  spec-sheet peak and a calibrated measured peak (roofline.measure_peak).
"""

from __future__ import annotations

import csv
import os
from typing import Iterable, Optional

import numpy as np

from ntt_aie.config import NTTConfig
from ntt_aie.profiling import roofline


def run_sweep(field, log_ns: Iterable[int], batches: Iterable[int] = (1,), *,
              engine: str = "auto", reduction: str = "auto",
              iters: int = 20, repeats: int = 5,
              out_dir: Optional[str] = None, verbose: bool = True) -> list[dict]:
    """Time the batched forward NTT over a (log_n, batch) grid.

    Returns one row dict per cell; writes CSVs when out_dir is given.
    """
    import jax
    import jax.numpy as jnp

    from ntt_aie.plan import build_plan
    from ntt_aie.utils.timing import time_device, time_host_dispatch

    rows = []
    rng = np.random.default_rng(0)

    # --- dispatch-overhead baseline (the reference's empty-kernel
    # dummy.csv, profile/plot_exectime.py:36-41): an identity-sized
    # dispatch timed with BOTH methodologies, so summary rows can separate
    # transport/dispatch from kernel time at small n. ---
    ident = jax.jit(lambda v: v + np.uint32(1))
    dummy_x = jnp.zeros((8, 128), jnp.uint32)
    dres = time_device(ident, dummy_x, iters=iters, repeats=repeats)
    dhost = time_host_dispatch(ident, dummy_x)
    dispatch_chain_us = dres["us_per_iter"]      # per-op cost inside a chain
    dispatch_e2e_us = dhost["us_trimmed_mean"]   # one dispatch, host clock
    if verbose:
        print(f"dispatch baseline: {dispatch_chain_us:.1f} us/op chained, "
              f"{dispatch_e2e_us:.1f} us host E2E")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"dummy_{field.name}.csv"), "w") as f:
            for v in dhost["runs_us"]:
                f.write(f"{v}\n")

    # Measured memory peak, the efficiency denominator beside the
    # data-sheet peak.
    try:
        peak = roofline.measure_peak(iters=iters, repeats=repeats)
        measured_gbps = peak["measured_hbm_gbps"]
        if verbose:
            print(f"measured HBM peak: {measured_gbps:.0f} GB/s "
                  f"({peak['buffer_mb']} MB streaming read+write)")
    except Exception:
        measured_gbps = None
    for log_n in log_ns:
        n = 1 << log_n
        cfg = NTTConfig(field=field, log_n=log_n, reduction=reduction)
        plan = build_plan(cfg, engine=engine)
        big = field.p >= (1 << 32)
        for batch in batches:
            fwd = plan.make_batched(batch)["fwd"]
            vals = rng.integers(0, min(field.p, 1 << 32), (batch, n))
            if big:
                # limb-tuple form: keeps the timing chain device-resident
                # (a uint64 host array would round-trip via gl_to_u64 every
                # chained step and measure transfers, not kernels)
                from ntt_aie.ops import modops as M

                a = M.gl_from_u64(vals.astype(np.uint64))
            else:
                a = jnp.asarray(vals, dtype=jnp.uint32)
            res = time_device(fwd, a, iters=iters, repeats=repeats)
            us_per_ntt = res["us_per_iter"] / batch
            # Matrix-form serving layout alongside the flat contract
            # (the headline path since round 4; chaining needs a square
            # split, true for even log_n). None where unavailable.
            n1_, n2_ = cfg.split
            mat_us_per_ntt = None
            fwd_mat = plan.make_batched(batch).get("fwd_mat") \
                if n2_ > 1 else None
            if fwd_mat is not None and n1_ == n2_:
                if big:
                    am = tuple(v.reshape(batch, n1_, n2_) for v in a)
                else:
                    am = a.reshape(batch, n1_, n2_)
                mres = time_device(fwd_mat, am, iters=iters,
                                   repeats=repeats)
                mat_us_per_ntt = round(mres["us_per_iter"] / batch, 4)
            # net of the chained dispatch baseline: kernel-only time, the
            # reference's E2E-minus-dummy subtraction done on our chain
            # methodology (meaningful at small n where dispatch dominates)
            net_us_per_ntt = max(res["us_per_iter"] - dispatch_chain_us,
                                 1e-3) / batch
            rep = roofline.efficiency_report(us_per_ntt * 1e-6, n,
                                             itemsize=8 if big else 4,
                                             measured_peak_gbps=measured_gbps)
            row = {
                "field": field.name,
                "log_n": log_n,
                "batch": batch,
                "engine": plan.engine,
                "reduction": plan.reduction,
                "us_per_ntt": round(us_per_ntt, 4),
                "mat_us_per_ntt": mat_us_per_ntt,
                "net_us_per_ntt": round(net_us_per_ntt, 4),
                "dispatch_us": round(dispatch_chain_us, 4),
                "ntts_per_sec": round(rep["transforms_per_sec"], 1),
                "butterflies_per_sec": rep["butterflies_per_sec"],
                "model_gops": round(rep["model_gops"], 2),
                "achieved_gbps": round(rep["achieved_gbps"], 2),
                "hbm_efficiency": round(rep.get("hbm_efficiency") or 0.0, 4),
                "hbm_efficiency_measured": round(
                    rep.get("hbm_efficiency_measured") or 0.0, 4),
                "runs_us": res["runs_us"],
            }
            rows.append(row)
            if verbose:
                print(
                    f"logn={log_n:2d} b={batch:<4d} {us_per_ntt:9.2f} us/NTT  "
                    f"{rep['transforms_per_sec']:10.0f} NTT/s  "
                    f"{rep['achieved_gbps']:7.1f} GB/s"
                )
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                raw = os.path.join(
                    out_dir, f"ntt_{field.name}_b{batch}_logn{log_n}.csv"
                )
                with open(raw, "w") as f:
                    for v in res["runs_us"]:
                        f.write(f"{v / batch}\n")
    if out_dir and rows:
        cols = [k for k in rows[0] if k != "runs_us"]
        # per-field summary so sweeps of different fields don't clobber
        with open(os.path.join(out_dir, f"summary_{field.name}.csv"), "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)
    return rows
