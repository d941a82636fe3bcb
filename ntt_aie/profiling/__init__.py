"""Observability layer (SURVEY.md §5.1/§5.5, L4).

The reference's stack: hardware trace events decoded to Chrome JSON
(scripts/parse_trace.py), host-timing CSVs + three plot scripts
(profile/plot_{exectime,kerneltime,efficiency}.py). Here:

- roofline  — cost/efficiency models (the reference's 5.5·N·log2N FLOP model
  plus a device-memory roofline),
- trace     — jax.profiler capture + named_scope markers (the event0/event1
  analog) + optional xplane->per-op summary,
- sweep     — benchmark grids to reference-format CSVs,
- plots     — the three plot equivalents over those CSVs.
"""

from ntt_aie.profiling.roofline import (
    butterflies,
    model_ops,
    bytes_per_transform,
    device_peaks,
    efficiency_report,
)
from ntt_aie.profiling.trace import capture_trace, kernel_markers

__all__ = [
    "butterflies",
    "model_ops",
    "bytes_per_transform",
    "device_peaks",
    "efficiency_report",
    "capture_trace",
    "kernel_markers",
]
