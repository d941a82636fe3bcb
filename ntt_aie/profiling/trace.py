"""Trace capture — the analog of the reference's hardware trace path.

Reference pipeline: event0/event1 markers in the kernel
(src/aie_core.cc:129-131), packet-switched trace routing (src/aie2.py:156-158),
host dump (src/test.cpp:193-198), offline decode to Chrome JSON
(scripts/parse_trace.py). The JAX profiler already records an op- and
kernel-level device trace, so the rebuild is thin:

- ``kernel_markers`` — jax.named_scope context, the event0/event1 analog:
  brackets a region so its ops group under one label in the trace viewer.
- ``capture_trace`` — run a callable under jax.profiler.trace and return the
  artifact directory (TensorBoard xplane; open with xprof/tensorboard).
- ``summarize_trace`` — offline decode (the parse_trace.py analog): read
  the captured Chrome-JSON trace back and reduce to per-op device-time
  totals.
- ``device_events`` / ``busy_ns`` — the device planes of the captured
  xplane (jax.profiler.ProfileData): every event with its line, and the
  union of the kernel intervals (device busy time).
"""

from __future__ import annotations

import contextlib
import glob
import os
import tempfile
from typing import Callable, Optional


@contextlib.contextmanager
def kernel_markers(label: str):
    """Named-scope marker pair bracketing a traced region (event0/event1
    analog; reference src/aie2.py:168,316)."""
    import jax

    with jax.named_scope(label):
        yield


def capture_trace(fn: Callable, *args, trace_dir: Optional[str] = None,
                  warmup: bool = True) -> str:
    """Run ``fn(*args)`` under the JAX profiler; return the trace directory.

    The result is blocked on inside the traced region so device execution is
    captured, not just dispatch.
    """
    import jax

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="ntt_trace_")
    if warmup:
        _block(fn(*args))
    with jax.profiler.trace(trace_dir):
        _block(fn(*args))
    return trace_dir


def _block(out):
    import jax

    for leaf in jax.tree_util.tree_leaves(out):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()
    return out


def find_chrome_trace(trace_dir: str) -> Optional[str]:
    hits = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True)
    )
    return hits[-1] if hits else None


def device_events(trace_dir: str) -> list[dict]:
    """Every event on the device planes ('/device:...') of the newest
    xplane under trace_dir: [{"line", "name", "start_ns", "dur_ns"}]."""
    import jax

    hits = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))
    if not hits:
        return []
    pd = jax.profiler.ProfileData.from_file(hits[-1])
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for e in line.events:
                out.append({"line": line.name, "name": e.name,
                            "start_ns": e.start_ns, "dur_ns": e.duration_ns})
    return out


# Lines whose events span whole modules or steps (gaps included) or
# repeat the kernels' HLO ops; busy time reads the kernel lines only.
_AGGREGATE_LINES = ("XLA Modules", "XLA Ops", "Steps", "Source", "TraceMe")


def kernel_events(events: list[dict]) -> list[dict]:
    return [e for e in events
            if not any(k in e["line"] for k in _AGGREGATE_LINES)]


def busy_ns(events: list[dict]) -> float:
    """Union of the kernel intervals: device busy time in the window."""
    iv = sorted((e["start_ns"], e["start_ns"] + e["dur_ns"])
                for e in kernel_events(events))
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize_trace(trace_dir: str, top: int = 20) -> list[dict]:
    """Per-op device-time summary from a captured trace — the offline-decode
    step (scripts/parse_trace.py reduces raw HW packets to Chrome JSON; the
    JAX profiler already emits Chrome JSON, so the decode reduces it to
    per-op totals on the device process only). Returns [] if no trace."""
    import gzip
    import json

    path = find_chrome_trace(trace_dir)
    if path is None:
        return []
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    device_pids = {
        e["pid"]
        for e in events
        if e.get("ph") == "M"
        and e.get("name") == "process_name"
        and "/device" in e.get("args", {}).get("name", "")
    }
    totals: dict[str, list] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in device_pids:
            rec = totals.setdefault(e["name"], [0.0, 0])
            rec[0] += e.get("dur", 0.0)
            rec[1] += 1
    out = [
        {"op": k, "total_us": v[0], "count": v[1]}
        for k, v in sorted(totals.items(), key=lambda kv: -kv[1][0])
    ]
    return out[:top]
