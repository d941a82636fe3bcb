"""Cost models and efficiency reporting.

The reference's efficiency pipeline (profile/plot_efficiency.py:25-46) is
``achieved = 5.5*N*log2(N) / kernel_time`` against fixed peaks (88 GOPS for
the 16-tile AIE, 4280 GFLOPS for the A100). Both models carry over:

- the *op* model ``5.5 * n * log2(n)`` (kept verbatim so efficiency numbers
  are comparable with the reference's plots), and
- a *device-memory* model: a pass-fused four-step transform streams the
  whole array through device memory once per pass, so a forward transform
  moves ~4 * n * itemsize bytes (2 passes x read+write).

Peaks are looked up by ``jax.devices()[0].device_kind`` in one table with
its source; a kind that is not in the table reports None and its
efficiency fields are omitted — nothing assumes a peak.
"""

from __future__ import annotations

import math
from typing import Optional

# (device-memory GB/s, dense bf16 TFLOP/s), keyed by the device_kind JAX
# reports. Source: NVIDIA H100 and H200 data sheets (SXM parts, at the
# full 700 W power limit). The integer path has no published peak.
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (3350.0, 989.0),
    "NVIDIA H200": (4800.0, 989.0),
}


def butterflies(n: int) -> int:
    """Total radix-2 butterflies in one size-n transform: n/2 * log2(n)."""
    return (n // 2) * int(math.log2(n))


def model_ops(n: int) -> float:
    """The reference's FLOP model (profile/plot_efficiency.py:25): 5.5 ops
    per element-stage — 5.5 * n * log2(n)."""
    return 5.5 * n * math.log2(n)


def bytes_per_transform(n: int, *, passes: int = 2, itemsize: int = 4) -> int:
    """HBM traffic model for a fused four-step transform: each pass reads and
    writes the full array once (twiddle tables add < 3% and are ignored)."""
    return passes * 2 * n * itemsize


def device_peaks(device_kind: Optional[str] = None) -> dict:
    """(hbm_gbps, bf16_tflops) for the current or named device kind."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    hbm, tflops = _DEVICE_PEAKS.get(device_kind, (None, None))
    return {"device_kind": device_kind, "hbm_gbps": hbm, "bf16_tflops": tflops}


_measured_peak_cache: Optional[dict] = None


def measure_peak(*, mb: int = 256, iters: int = 10, repeats: int = 5,
                 cache: bool = True) -> dict:
    """Calibrated device-memory peak: a streaming read+write probe on THIS
    device, timed with the same dependent-chain methodology as every other
    number (utils/timing.py) — the denominator a kernel's share is best
    read against, beside the data-sheet peak.
    Returns {"measured_hbm_gbps", "buffer_mb", "us_per_pass"}.

    The probe is x -> x + 1 on an (mb MB) uint32 array: one HBM read and
    one write per pass, no reuse, the same traffic pattern as a fused NTT
    pass. Cached per process (cache=False to re-measure)."""
    global _measured_peak_cache
    if cache and _measured_peak_cache is not None and \
            _measured_peak_cache["buffer_mb"] == mb:
        return _measured_peak_cache
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ntt_aie.utils.timing import time_device

    n = mb * 1024 * 1024 // 4
    x = jnp.zeros((n,), jnp.uint32)
    # K barrier-separated read+write passes per dispatch so the
    # per-dispatch cost amortizes inside one call. optimization_barrier stops XLA from fusing the K elementwise adds
    # into a single HBM pass; each one really streams the buffer.
    K = 8
    one = np.uint32(1)

    def step(v):
        for _ in range(K):
            v = jax.lax.optimization_barrier(v + one)
        return v

    res = time_device(jax.jit(step), x, iters=iters, repeats=repeats)
    # Residual dispatch overhead, measured with the same K-pass shape on a
    # tiny buffer (pure per-dispatch cost), subtracted for the marginal
    # figure, guarded against overcorrection.
    tiny = jnp.zeros((8, 128), jnp.uint32)
    base = time_device(jax.jit(step), tiny, iters=iters, repeats=repeats)
    net_us = max(res["us_per_iter"] - base["us_per_iter"],
                 res["us_per_iter"] * 0.2)
    out = {
        "measured_hbm_gbps": K * 2 * n * 4 / (net_us * 1e-6) / 1e9,
        "raw_gbps": K * 2 * n * 4 / (res["us_per_iter"] * 1e-6) / 1e9,
        "dispatch_us_per_op": base["us_per_iter"],
        "buffer_mb": mb,
        "us_per_pass": res["us_per_iter"] / K,
    }
    if cache:
        _measured_peak_cache = out
    return out


_measured_vpu_cache: dict = {}


def measure_vpu_peak(*, reduction: str = "harvey4", mb: int = 32,
                     r: int = 64, iters: int = 10, repeats: int = 5,
                     cache: bool = True) -> dict:
    """Calibrated butterfly peak: the EXACT butterfly arithmetic of the
    XLA engine (ops/reductions.py add / sub_for_mul / mul_const — e.g.
    harvey4's 5-mul approximate-Shoup multiply; for
    reduction='goldilocks' the gl_add/gl_sub/gl_mul limb-pair butterfly)
    chained R deep per element
    with zero network overhead: no reshapes, no concats, no per-stage
    twiddle table streaming, no transpose. What this measures is the
    achievable ideal-conditions butterfly rate of THIS device — the
    compute denominator the memory calibration (measure_peak) cannot
    provide. A gap between a pass's achieved butterfly rate and this
    number localizes overhead to the network (reshape/concat/table
    traffic), not the arithmetic.

    Methodology matches measure_peak: K barrier-separated probe passes per
    dispatch (R chained butterflies each), timed with the dependent chain
    (utils/timing.py), net of a tiny-buffer dispatch baseline. At R = 64 the arithmetic intensity is ~270 lane-ops/byte —
    far above the ridge, so HBM cannot be the bound.

    Values stay inside the strategy's lazy domain by construction
    (u, v <- add(u, v), mul_const(sub_for_mul(u, v))), so the probe is
    also a legal value stream, not just representative ops.

    Returns {"butterflies_per_sec", "lane_gops" (at the strategy's
    ops/butterfly estimate), "us_per_pass", "r", "buffer_mb"}."""
    key = (reduction, mb, r)
    if cache and key in _measured_vpu_cache:
        return _measured_vpu_cache[key]
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ntt_aie.fields import P_469762049, P_998244353
    from ntt_aie.ops.reductions import make_reduction
    from ntt_aie.utils.timing import time_device

    if reduction == "goldilocks":
        # Limb-pair butterfly ideal: the EXACT gl_add/gl_sub/gl_mul
        # arithmetic of the GL engine chained r deep on (hi, lo) uint32 planes, zero
        # network overhead, same methodology as the word-prime probe.
        from ntt_aie.fields import GOLDILOCKS
        from ntt_aie.ops import modops as M

        # ~lane-ops per GL butterfly for the Gops conversion only:
        # gl_mul ~70 (4 partials + reduce128) + add/sub ~6 each.
        ops_per_bfly = 82
        n = mb * 1024 * 1024 // 4
        q = n // 4  # four uint32 planes: uh, ul, wh, wl
        rng = np.random.default_rng(0)
        vals = (rng.integers(0, 1 << 63, 2 * q, dtype=np.uint64)
                % np.uint64(GOLDILOCKS.p))
        uh0, ul0 = M.gl_from_u64(vals[:q])
        wh0, wl0 = M.gl_from_u64(vals[q:])
        x = jnp.concatenate([jnp.asarray(v) for v in (uh0, ul0, wh0, wl0)])
        tw_v = (rng.integers(1, 1 << 63, 8, dtype=np.uint64)
                % np.uint64(GOLDILOCKS.p))
        twh, twl = (jnp.asarray(v.reshape(8, 1))
                    for v in M.gl_from_u64(tw_v))
        K = 4

        def step(v):
            qq = v.shape[0] // 4  # static per trace
            uh = v[:qq].reshape(8, -1)
            ul = v[qq:2 * qq].reshape(8, -1)
            wh = v[2 * qq:3 * qq].reshape(8, -1)
            wl = v[3 * qq:].reshape(8, -1)
            for _ in range(K):
                for _ in range(r):
                    sh, sl = M.gl_add(uh, ul, wh, wl)
                    dh, dl = M.gl_sub(uh, ul, wh, wl)
                    mh, ml = M.gl_mul(dh, dl, twh, twl)
                    uh, ul, wh, wl = sh, sl, mh, ml
                uh, ul, wh, wl = jax.lax.optimization_barrier(
                    (uh, ul, wh, wl))
            return jnp.concatenate([z.reshape(-1)
                                    for z in (uh, ul, wh, wl)])

        res = time_device(jax.jit(step), x, iters=iters, repeats=repeats)
        tiny = jnp.concatenate([jnp.asarray(v) for v in
                                M.gl_from_u64(vals[:1024])]
                               + [jnp.asarray(v) for v in
                                  M.gl_from_u64(vals[1024:2048])])
        base = time_device(jax.jit(step), tiny, iters=iters,
                           repeats=repeats)
        net_us = max(res["us_per_iter"] - base["us_per_iter"],
                     res["us_per_iter"] * 0.2)
        bfly_per_dispatch = K * r * q
        out = {
            "butterflies_per_sec": bfly_per_dispatch / (net_us * 1e-6),
            "raw_butterflies_per_sec": bfly_per_dispatch
            / (res["us_per_iter"] * 1e-6),
            "lane_gops": bfly_per_dispatch * ops_per_bfly
            / (net_us * 1e-6) / 1e9,
            "dispatch_us_per_op": base["us_per_iter"],
            "us_per_pass": res["us_per_iter"] / K,
            "reduction": reduction,
            "r": r,
            "buffer_mb": mb,
        }
        if cache:
            _measured_vpu_cache[key] = out
        return out

    field = P_469762049 if reduction == "harvey4" else P_998244353
    red = make_reduction(reduction, field)
    # ~lane-ops per butterfly, for the Gops conversion only (the
    # butterfly rate itself is measured, not modeled): harvey4 = 5 muls
    # + ~12 shifts/adds/selects, harvey ~= 6 + 10.
    ops_per_bfly = {"harvey4": 17, "harvey": 16}.get(reduction, 17)

    n = mb * 1024 * 1024 // 4
    half = n // 2
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, field.p, n, dtype=np.int64)
                    .astype(np.uint32))
    # One twiddle vector, shaped to broadcast along the data exactly like
    # a stage's per-stage vector operand.
    tw = red.prepare_table(
        np.asarray(rng.integers(1, field.p, 8, dtype=np.int64)))
    tw_dev = tuple(jnp.asarray(t.reshape(8, 1)) for t in tw)

    K = 4

    def step(v):
        h = v.shape[0] // 2  # static per trace (big probe vs tiny baseline)
        u, w = v[:h].reshape(8, -1), v[h:].reshape(8, -1)
        for _ in range(K):
            for _ in range(r):
                s = red.add(u, w)
                d = red.sub_for_mul(u, w) if red.sub_for_mul else red.sub(u, w)
                m = red.mul_const(d, *tw_dev)
                u, w = s, m
            u, w = jax.lax.optimization_barrier((u, w))
        return jnp.concatenate([u.reshape(-1), w.reshape(-1)])

    res = time_device(jax.jit(step), x, iters=iters, repeats=repeats)
    tiny = jnp.asarray(rng.integers(0, field.p, 2048, dtype=np.int64)
                       .astype(np.uint32))
    base = time_device(jax.jit(step), tiny, iters=iters, repeats=repeats)
    net_us = max(res["us_per_iter"] - base["us_per_iter"],
                 res["us_per_iter"] * 0.2)
    bfly_per_dispatch = K * r * half
    out = {
        "butterflies_per_sec": bfly_per_dispatch / (net_us * 1e-6),
        "raw_butterflies_per_sec": bfly_per_dispatch
        / (res["us_per_iter"] * 1e-6),
        "lane_gops": bfly_per_dispatch * ops_per_bfly / (net_us * 1e-6) / 1e9,
        "dispatch_us_per_op": base["us_per_iter"],
        "us_per_pass": res["us_per_iter"] / K,
        "reduction": reduction,
        "r": r,
        "buffer_mb": mb,
    }
    if cache:
        _measured_vpu_cache[key] = out
    return out


_MOVEMENT_PREFIXES = (
    "copy", "reshape", "slice", "convert", "transpose", "broadcast",
    "concatenate", "dynamic", "bitcast", "tuple", "all-", "collective",
)


def derive_trace_counters(rows: list[dict], *, n: int, batch: int = 1,
                          itemsize: int = 4,
                          stages_per_pass=None,
                          pass_table_bytes: tuple = (0, 0),
                          hbm_gbps: Optional[float] = None,
                          vpu_bfly: Optional[float] = None) -> list[dict]:
    """Derived utilization planes for a fwd/inv trace summary — the
    analog of the reference decoder's per-event labels
    (reference scripts/parse_trace.py:755-783: VectorInstr, PortRunning,
    stall classes). The profiler exposes op-level device times, not
    intra-kernel events, so the derived planes are per PASS: achieved
    butterfly rate vs a measured ideal-conditions butterfly rate and
    achieved bandwidth vs a measured streaming peak.

    rows: summarize_trace output. The two fused column passes are the two
    largest single-count device ops that are neither the jit wrapper nor
    data movement. Returns [] when no two pass ops are found (e.g. a
    marker-pair fallback summary).

    pass_table_bytes: extra HBM bytes per pass beyond the 2*n*itemsize
    read+write (twiddle-matrix operands), in TIME order (pass 1, pass 2).
    stages_per_pass: butterfly stages per pass, in TIME order — an
    (s1, s2) tuple, or an int applied to both. None defaults to the
    even forward split (log2(n)//2, log2(n) - log2(n)//2); callers with
    an uneven n1/n2 split or an inverse trace (pass order swaps) should
    pass the real per-pass stage counts (cli.py does).
    Denominators are probes measured in the same process
    (measure_peak / measure_vpu_peak); a plane whose denominator is None
    or 0 is omitted."""
    cand = [
        r for r in rows
        if r.get("count") == 1
        and not r["op"].startswith("jit_")
        and not r["op"].startswith(_MOVEMENT_PREFIXES)
        and "fusion" not in r["op"]
    ]
    cand = sorted(cand, key=lambda r: -r["total_us"])[:2]
    if len(cand) < 2:
        return []

    # Earlier-numbered XLA op suffix = earlier in the program = pass 1.
    # Sort by the NUMERIC trailing suffix ('fwd_fn.9' before 'fwd_fn.10'
    # — a raw string sort swaps them across digit boundaries).
    def _op_key(r):
        stem, _, suf = r["op"].rpartition(".")
        return (stem, int(suf)) if suf.isdigit() else (r["op"], -1)

    cand.sort(key=_op_key)
    hbm, vpu = hbm_gbps, vpu_bfly
    logn = int(math.log2(n))
    if stages_per_pass is None:
        stages = (logn // 2, logn - logn // 2)
    elif isinstance(stages_per_pass, int):
        stages = (stages_per_pass, stages_per_pass)
    else:
        stages = tuple(stages_per_pass)
    out = []
    for i, r in enumerate(cand):
        t = r["total_us"] * 1e-6
        bfly_pass = batch * (n // 2) * stages[i]
        data_bytes = batch * 2 * n * itemsize + pass_table_bytes[i]
        gbf = bfly_pass / t / 1e9
        gbps = data_bytes / t / 1e9
        d = {
            "op": r["op"],
            "us": r["total_us"],
            "butterflies": bfly_pass,
            "gbf_per_sec": round(gbf, 2),
            "hbm_bytes": data_bytes,
            "achieved_gbps": round(gbps, 2),
        }
        if hbm:
            d["hbm_utilization"] = round(gbps / hbm, 4)
        if vpu:
            d["vpu_utilization"] = round(gbf * 1e9 / vpu, 4)
        if hbm and vpu:
            d["bound"] = ("compute" if gbf * 1e9 / vpu >= gbps / hbm
                          else "memory")
        out.append(d)
    return out


def efficiency_report(seconds_per_transform: float, n: int, *,
                      device_kind: Optional[str] = None,
                      passes: int = 2, itemsize: int = 4,
                      measured_peak_gbps: Optional[float] = None,
                      measured_vpu_bfly: Optional[float] = None) -> dict:
    """Everything the reference's three plots derive, as one dict:
    throughput, butterfly rate, model GOPS (the 5.5 model), achieved HBM
    bandwidth, and efficiency vs the HBM roofline when the peak is known.

    Three efficiency denominators are reported when available:
    ``hbm_efficiency`` vs the data-sheet peak (comparable across
    machines), ``hbm_efficiency_measured`` vs a calibrated
    measure_peak() number, and ``vpu_efficiency_measured`` vs a
    measure_vpu_peak() ideal-conditions butterfly rate."""
    t = seconds_per_transform
    rep = {
        "n": n,
        "us_per_transform": t * 1e6,
        "transforms_per_sec": 1.0 / t,
        "butterflies_per_sec": butterflies(n) / t,
        "model_gops": model_ops(n) / t / 1e9,
        "hbm_bytes": bytes_per_transform(n, passes=passes, itemsize=itemsize),
        "achieved_gbps": bytes_per_transform(n, passes=passes, itemsize=itemsize) / t / 1e9,
    }
    peaks = device_peaks(device_kind)
    rep.update(peaks)
    if peaks["hbm_gbps"]:
        rep["hbm_efficiency"] = rep["achieved_gbps"] / peaks["hbm_gbps"]
    if measured_peak_gbps:
        rep["measured_hbm_gbps"] = measured_peak_gbps
        rep["hbm_efficiency_measured"] = rep["achieved_gbps"] / measured_peak_gbps
    if measured_vpu_bfly:
        rep["measured_vpu_bfly_per_sec"] = measured_vpu_bfly
        rep["vpu_efficiency_measured"] = (rep["butterflies_per_sec"]
                                          / measured_vpu_bfly)
    return rep
