"""Device timing harness.

The reference measures two things (SURVEY.md §6): host wall-clock per
dispatch (src/test.cpp:157-175, trimmed mean of 10) and on-device kernel
time from hardware trace marker pairs (profile/plot_kerneltime.py:25-37).

``time_device`` times a *dependent dispatch chain*: ITERS dispatches where
each consumes the previous output (y = fn(y)), fenced with
``jax.block_until_ready`` and divided by ITERS. Data dependence stops XLA
from eliding work and lets consecutive dispatches queue on the device.
Device-side kernel times come from the profiler trace
(profiling/trace.py), not from here.
"""

from __future__ import annotations

import time

import jax
import numpy as np


def chain_loop(fn, iters: int):
    """x -> fn applied `iters` times, dependently, as queued dispatches."""

    def run(x):
        for _ in range(iters):
            x = fn(x)
        return x

    return run


def _trimmed(runs):
    # trimmed mean, reference-style (drop min and max; plot_exectime.py:27-29)
    s = sorted(runs)
    return float(np.mean(s[1:-1] if len(s) > 2 else s))


def time_device(fn, x, *, iters: int = 100, repeats: int = 5) -> dict:
    """Time fn on device via a dependent dispatch chain.

    Requires fn's output to be shape/dtype compatible with its input
    (true for fwd and inv NTTs on flat uint32 vectors).
    Returns dict(us_per_iter, best_us, runs_us, result).
    """
    run = chain_loop(fn, iters)
    out = jax.block_until_ready(run(x))  # compile + warm
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(x))
        runs.append((time.perf_counter() - t0) / iters * 1e6)
    return {
        "us_per_iter": _trimmed(runs),
        "best_us": min(runs),
        "runs_us": runs,
        "result": out,
    }


def time_host_dispatch(fn, x, *, runs: int = 10) -> dict:
    """The reference's host E2E metric: wall clock around one dispatch+wait,
    `runs` times, trimmed mean (src/test.cpp:157-175 + plot_exectime.py:27-29)."""
    jfn = jax.jit(fn)
    jax.block_until_ready(jfn(x))
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(jfn(x))
        ts.append((time.perf_counter() - t0) * 1e6)
    return {"us_trimmed_mean": _trimmed(ts), "runs_us": ts}
