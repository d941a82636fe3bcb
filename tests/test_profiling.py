"""Observability layer: roofline models, sweep CSVs, trace decode, plots,
CLI drivers (SURVEY.md §5.1/§5.5 equivalents)."""

import csv
import glob
import json
import os

import numpy as np
import pytest
import jax.numpy as jnp

from ntt_aie import fields as F
from ntt_aie.config import NTTConfig
from ntt_aie.profiling import roofline


def test_butterfly_and_op_models():
    assert roofline.butterflies(2048) == 1024 * 11
    # the reference's model (profile/plot_efficiency.py:25): 5.5*N*log2N
    assert roofline.model_ops(2048) == 5.5 * 2048 * 11
    assert roofline.bytes_per_transform(1 << 20) == 2 * 2 * (1 << 20) * 4


def test_efficiency_report_known_device():
    rep = roofline.efficiency_report(10e-6, 1 << 16,
                                     device_kind="NVIDIA H100 80GB HBM3")
    assert rep["transforms_per_sec"] == pytest.approx(1e5)
    assert rep["hbm_gbps"] == 3350.0
    assert rep["hbm_efficiency"] == pytest.approx(
        rep["achieved_gbps"] / 3350.0
    )


def test_efficiency_report_unknown_device():
    rep = roofline.efficiency_report(10e-6, 1 << 16, device_kind="Abacus")
    assert rep["hbm_gbps"] is None
    assert "hbm_efficiency" not in rep


def test_sweep_writes_reference_format_csvs(tmp_path):
    from ntt_aie.profiling.sweep import run_sweep

    rows = run_sweep(F.P_469762049, [8, 9], [1, 2], iters=2, repeats=3,
                     out_dir=str(tmp_path), verbose=False)
    assert len(rows) == 4
    raw = sorted(glob.glob(str(tmp_path / "ntt_*_logn*.csv")))
    assert len(raw) == 4  # one raw-runs file per cell (reference format)
    with open(raw[0]) as f:
        vals = [float(line) for line in f]
    assert len(vals) == 3  # one µs value per line, like profile/exectime/
    with open(tmp_path / "summary_p469762049.csv") as f:
        got = list(csv.DictReader(f))
    assert len(got) == 4 and "hbm_efficiency" in got[0]


def test_plots_render(tmp_path):
    from ntt_aie.profiling import plots
    from ntt_aie.profiling.sweep import run_sweep

    run_sweep(F.P_469762049, [8, 9], [1, 2], iters=2, repeats=3,
              out_dir=str(tmp_path), verbose=False)
    out = plots.render_all(str(tmp_path / "summary_p469762049.csv"), str(tmp_path / "plots"))
    assert [os.path.basename(p) for p in out] == [
        "exectime.png", "throughput.png", "comparison.png", "efficiency.png"
    ]
    for p in out:
        assert os.path.getsize(p) > 1000


def test_trace_capture_and_decode(tmp_path):
    """capture_trace + summarize_trace roundtrip (parse_trace.py analog).
    On the CPU test backend there may be no /device process; the decode
    must still parse the trace without error."""
    import jax.numpy as jnp

    from ntt_aie.profiling.trace import (
        capture_trace, find_chrome_trace, summarize_trace,
    )

    fn = lambda x: jnp.dot(x, x)  # noqa: E731
    d = capture_trace(fn, jnp.ones((64, 64), jnp.float32),
                      trace_dir=str(tmp_path))
    assert find_chrome_trace(d) is not None
    rows = summarize_trace(d)
    assert isinstance(rows, list)
    for r in rows:
        assert set(r) == {"op", "total_us", "count"}


def test_kernel_markers_context():
    import jax
    import jax.numpy as jnp

    from ntt_aie.profiling.trace import kernel_markers

    @jax.jit
    def f(x):
        with kernel_markers("ntt_iteration"):
            return x + 1

    assert int(f(jnp.uint32(1))) == 2


# ---- CLI (the reference's test.exe role) ----

def test_cli_verify_pass(capsys):
    from ntt_aie.cli import main

    assert main(["verify", "--field", "p469762049", "--log-n", "8"]) == 0
    out = capsys.readouterr().out
    assert "PASS!" in out


def test_cli_verify_dilithium_gate(capsys):
    """The ML-DSA (FIPS 204) ring-product gate fires for p=8380417."""
    from ntt_aie.cli import main

    assert main(["verify", "--field", "DILITHIUM", "--log-n", "10"]) == 0
    out = capsys.readouterr().out
    assert "ML-DSA ring product vs schoolbook" in out
    assert "PASS!" in out


def test_cli_verify_parity(capsys):
    from ntt_aie.cli import main

    assert main(["verify", "--parity"]) == 0
    assert "reference device parity" in capsys.readouterr().out


def test_cli_bench_json(capsys):
    from ntt_aie.cli import main

    assert main(["bench", "--field", "p469762049", "--log-n", "10",
                 "--batch", "2", "--iters", "2", "--repeats", "3"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["n"] == 1024 and rep["transforms_per_sec"] > 0
    assert rep["verified"] is True


def test_cli_bench_gates_all_ops(capsys):
    """`bench` oracle-checks the TIMED callable for every --op mode (the
    reference driver's benchmark-then-verify structure) and the gate
    actually bites: a corrupted output flips it."""
    from ntt_aie.cli import main, _gate_bench_output
    from ntt_aie.plan import build_plan

    for op in ("inv", "polymul"):
        assert main(["bench", "--field", "p469762049", "--log-n", "10",
                     "--batch", "2", "--iters", "1", "--repeats", "1",
                     "--op", op]) == 0
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rep["verified"] is True, op

    # negative path: a callable returning wrong values must fail the gate
    cfg = NTTConfig(field=F.P_469762049, log_n=8)
    plan = build_plan(cfg, engine="xla")
    rng = np.random.default_rng(0)
    vals = rng.integers(0, F.P_469762049.p, (2, cfg.n))
    a = jnp.asarray(vals, dtype=jnp.uint32)
    good = plan.make_batched(2)["fwd"]
    assert _gate_bench_output(plan, cfg, "fwd", good, a, vals, rng)
    bad = lambda x: good(x) ^ jnp.uint32(1)  # noqa: E731
    assert not _gate_bench_output(plan, cfg, "fwd", bad, a, vals, rng)


def test_measure_vpu_peak_structure():
    """measure_vpu_peak runs the real butterfly arithmetic and returns a
    positive ideal-conditions rate (absolute value only meaningful on the
    real chip; this checks the probe's structure + legality on CPU)."""
    out = roofline.measure_vpu_peak(mb=1, r=2, iters=1, repeats=1,
                                    cache=False)
    assert out["butterflies_per_sec"] > 0
    assert out["lane_gops"] > 0
    assert out["reduction"] == "harvey4"


def test_efficiency_report_vpu_denominator():
    rep = roofline.efficiency_report(1e-4, 1 << 20,
                                     device_kind="NVIDIA H100 80GB HBM3",
                                     measured_vpu_bfly=1e11)
    assert rep["measured_vpu_bfly_per_sec"] == 1e11
    assert rep["vpu_efficiency_measured"] == pytest.approx(
        rep["butterflies_per_sec"] / 1e11)


def test_cli_field_aliases():
    from ntt_aie.cli import _field

    assert _field("P_2013265921").p == 2013265921
    assert _field("p2013265921").p == 2013265921
    assert _field("GOLDILOCKS").p == F.GOLDILOCKS.p


def test_scaling_harness_virtual_mesh():
    """Scaling rows over the 8-virtual-device CPU mesh (structure check;
    absolute numbers only meaningful on a real slice)."""
    from ntt_aie.profiling.scaling import run_scaling

    rows = run_scaling(F.P_469762049, 10, (1, 2, 4), batch=2, iters=2,
                       repeats=2, verbose=False)
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["ntts_per_sec"] > 0 for r in rows)

    # hierarchical cells: D=2 stays flat (D == G), D=4 runs on a (2, 2)
    # two-level mesh and records its shape
    rows = run_scaling(F.P_469762049, 10, (2, 4), batch=2, iters=2,
                       repeats=2, verbose=False, hier_groups=2)
    assert rows[0]["hier"] is None and rows[1]["hier"] == [2, 2]
    assert all(r["ntts_per_sec"] > 0 for r in rows)


def test_stream_transform_pipeline(rng):
    """Streaming pipeline yields the same results as direct calls, in order
    (the reference's depth-2 ObjectFIFO overlap at the host boundary)."""
    import jax.numpy as jnp

    from ntt_aie.api import NTTContext
    from ntt_aie.config import NTTConfig
    from ntt_aie.utils.streaming import stream_transform

    field = F.P_469762049
    cfg = NTTConfig(field=field, log_n=9)
    ctx = NTTContext(cfg)
    B = 2
    fwd = ctx.plan.make_batched(B)["fwd"]
    batches = [rng.integers(0, field.p, (B, cfg.n)).astype(np.uint32)
               for _ in range(5)]
    got = list(stream_transform(fwd, batches, prefetch=2))
    assert len(got) == 5
    for x, y in zip(batches, got):
        assert np.array_equal(y, np.asarray(fwd(jnp.asarray(x))))


def test_derive_trace_counters():
    """Derived utilization planes from a trace summary: pass-op selection
    (skip the jit wrapper and data movement), program-order assignment of
    per-pass table bytes, and planes only against denominators passed
    in (probes measured in the same process)."""
    from ntt_aie.profiling.roofline import derive_trace_counters

    n = 1 << 20
    rows = [
        {"op": "jit_fwd_fn(123)", "total_us": 70.0, "count": 1},
        {"op": "fwd_fn.3", "total_us": 30.0, "count": 1},
        {"op": "fwd_fn.2", "total_us": 20.0, "count": 1},
        {"op": "copy", "total_us": 8.0, "count": 1},
        {"op": "reshape.2", "total_us": 6.0, "count": 1},
    ]
    d = derive_trace_counters(rows, n=n, pass_table_bytes=(0, 2 * n * 4),
                              hbm_gbps=3000.0, vpu_bfly=2e11)
    assert [r["op"] for r in d] == ["fwd_fn.2", "fwd_fn.3"]  # program order
    stages = 10  # log2(n) // 2 per four-step pass
    bf = (n // 2) * stages
    assert d[0]["butterflies"] == bf
    assert d[0]["hbm_bytes"] == 2 * n * 4            # read+write only
    assert d[1]["hbm_bytes"] == 2 * n * 4 + 2 * n * 4  # + wmat tables
    got = d[0]["gbf_per_sec"]
    want = bf / 20e-6 / 1e9
    assert abs(got - want) / want < 1e-3
    assert abs(d[0]["vpu_utilization"] - got * 1e9 / 2e11) < 1e-3
    assert abs(d[0]["hbm_utilization"]
               - d[0]["achieved_gbps"] / 3000.0) < 1e-3
    assert d[0]["bound"] in ("compute", "memory")

    # no denominators: achieved rates only, no planes and no assumed peak
    d = derive_trace_counters(rows, n=n, itemsize=8)
    assert not {"vpu_utilization", "hbm_utilization", "bound"} & set(d[0])
    assert d[0]["hbm_bytes"] == 2 * n * 8

    # no two pass ops -> no derived planes
    assert derive_trace_counters(
        [{"op": "forward_ntt", "total_us": 10.0, "count": 20}], n=n) == []

    # numeric-suffix program order: 'fwd_fn.9' is pass 1 even though it
    # sorts after 'fwd_fn.10' lexicographically (ADVICE r4)
    rows_digit = [
        {"op": "fwd_fn.10", "total_us": 30.0, "count": 1},
        {"op": "fwd_fn.9", "total_us": 20.0, "count": 1},
    ]
    d = derive_trace_counters(rows_digit, n=n,
                              pass_table_bytes=(0, 2 * n * 4))
    assert [r["op"] for r in d] == ["fwd_fn.9", "fwd_fn.10"]
    assert d[0]["hbm_bytes"] == 2 * n * 4  # table bytes land on pass 2

    # per-pass stages for uneven splits: odd log_n gives (s, s+1)
    n_odd = 1 << 21
    d = derive_trace_counters(rows_digit, n=n_odd)
    assert d[0]["butterflies"] == (n_odd // 2) * 10
    assert d[1]["butterflies"] == (n_odd // 2) * 11
    d = derive_trace_counters(rows_digit, n=n_odd, stages_per_pass=(11, 10))
    assert d[0]["butterflies"] == (n_odd // 2) * 11
    d = derive_trace_counters(rows_digit, n=n_odd, stages_per_pass=7)
    assert d[0]["butterflies"] == d[1]["butterflies"] == (n_odd // 2) * 7
