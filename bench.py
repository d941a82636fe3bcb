"""Benchmark driver: prints ONE JSON line with the headline metric.

Metric: forward NTTs per second on one GPU at n = 2^20 over the 32-bit
prime p = 469762049, batch 256 (1 GiB per operand), through the plan's
default engine. Exits non-zero, printing no number, when JAX's default
backend is not 'gpu'.

Methodology: a dependent dispatch chain (each transform consumes the
previous output, so no work can be elided) fenced with
jax.block_until_ready and divided by the chain length; repeats are reduced
with the reference's trimmed mean (drop min and max,
profile/plot_exectime.py:27-29). Inputs live on the device; no host
transfer in the timed region. The timed callable is the matrix-form view
`fwd_mat` ((B, n1, n2) -> (B, n2, n1), a row-major reshape of the flat
forward); the flat contract's number is reported beside it.

Correctness gate: the timed pipeline's output is verified bit-exact against
the native C++ golden oracle (the reference's PASS gate,
src/test.cpp:221-247), run AFTER timing.

vs_baseline: normalized butterfly rate vs the reference's best committed
number — 16-tile AIE kernel time 14.375 us at n=2^11 (BASELINE.md §1) =
(2^11/2 * 11) / 14.375us = 0.7836 G butterflies/s. Ours =
(2^20/2 * 20) / t.
"""

import json
import sys

import numpy as np

REF_BUTTERFLIES_PER_SEC = (2**11 // 2 * 11) / 14.375e-6  # reference best
METRIC = "NTTs/sec/GPU at n=2^20 (32-bit prime), batch 256"


def main() -> int:
    import jax
    import jax.numpy as jnp

    from ntt_aie import NTTConfig, P_469762049 as field
    from ntt_aie import twiddles as tw
    from ntt_aie.plan import build_plan
    from ntt_aie.utils.compile_cache import enable_compile_cache
    from ntt_aie.utils.timing import time_device

    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU; JAX's backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    enable_compile_cache()

    log_n = 20
    n = 1 << log_n
    B = 256
    cfg = NTTConfig(field=field, log_n=log_n)
    plan = build_plan(cfg)
    n1, n2 = cfg.split
    bat = plan.make_batched(B)

    rng = np.random.default_rng(0)
    batch_in = rng.integers(0, field.p, (B, n), dtype=np.int64).astype(
        np.uint32)

    iters, repeats = 20, 5
    flat_res = time_device(bat["fwd"], jnp.asarray(batch_in),
                           iters=iters, repeats=repeats)
    # fwd_mat chains (B, n1, n2) -> (B, n2, n1): shape-stable as n1 == n2
    xs = jnp.asarray(batch_in.reshape(B, n1, n2))
    res = time_device(bat["fwd_mat"], xs, iters=iters, repeats=repeats)
    sec_per_ntt = res["us_per_iter"] * 1e-6 / B
    vs_baseline = (n // 2) * log_n / sec_per_ntt / REF_BUTTERFLIES_PER_SEC

    # ---- correctness gate (bit-exact vs golden oracle), after timing ----
    # row 0 plus 8 randomly drawn rows of the timed batch, against the
    # native batch oracle (oracle.cc ntt_dif_u64_batch) in one C call.
    gate_rows = np.concatenate(
        [[0], rng.choice(np.arange(1, B), size=8, replace=False)])
    got = np.asarray(bat["fwd_mat"](xs)).reshape(B, n)[gate_rows]
    brev = tw.bit_reverse_indices(n)
    try:
        from ntt_aie import native_oracle as native

        want = native.ntt_dif_batch(
            batch_in[gate_rows].astype(np.uint64),
            field.root_of_unity(n), field.p)[:, brev]
    except Exception:
        from ntt_aie import reference as ref

        want = np.stack([ref.ntt_forward(batch_in[r], field) for r in
                         gate_rows]).astype(np.uint64)
    if not np.array_equal(
            got[:, plan.spectral_to_natural].astype(np.uint64), want):
        print("bench.py: verification FAILED", file=sys.stderr)
        return 1

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": METRIC,
        "value": B / (res["us_per_iter"] * 1e-6),
        "unit": "NTT/s",
        "vs_baseline": vs_baseline,
        "flat_value": B / (flat_res["us_per_iter"] * 1e-6),
        "engine": plan.engine,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
