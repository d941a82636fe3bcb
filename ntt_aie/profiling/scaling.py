"""Scaling-efficiency harness: NTT/s at 1 -> D devices.

The BASELINE north star asks for NTT/s scaling efficiency reported at
1 chip / 1 host / N hosts (>= 80% target). The reference has no multi-device
story at all (SURVEY.md §5.7 "No multi-device story") — its scaling data is
the 1/2/4/8/16-*tile* grid (profile/exectime/ntt_{cores}core_*.csv), which
this harness generalizes: the mesh axis plays the tile grid's part.

Weak scaling: each device holds a fixed (n1, n2/D) column shard, so the
problem grows with D and ideal throughput is linear in D. Efficiency =
(NTT/s at D) / (D * NTT/s at 1). Strong scaling: fixed total n; efficiency
= time(1) / (D * time(D)).

On a machine with one real chip this runs on virtual CPU devices
(XLA_FORCE_HOST_PLATFORM_DEVICE_COUNT) — structurally identical XLA
collectives over a smaller mesh; absolute numbers are only meaningful on a
real slice, relative efficiency trends are meaningful everywhere.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from ntt_aie.config import NTTConfig


def run_scaling(field, log_n: int, device_counts: Iterable[int] = (1, 2, 4, 8), *,
                mode: str = "strong", batch: int = 4,
                iters: int = 5, repeats: int = 3, verbose: bool = True,
                overlap_chunks: int = 1,
                topology: str = "fourstep",
                wmat_factored: bool | None = None,
                hier_groups: int = 1) -> list[dict]:
    """Time the distributed forward NTT over meshes of increasing size.

    mode='strong': fixed total n = 2^log_n, sharded over D devices.
    mode='weak':   per-device shard fixed at 2^log_n columns worth of work;
                   total problem size is D * 2^log_n / ... (n2 scales by D).
    overlap_chunks > 1 chunks the four-step transpose collective so it
    overlaps local compute (fourstep.build_distributed_plan).
    topology='pairwise' times the reference's scaling topology instead
    (log2(D) ppermute exchange stages, forward only) for the
    fourstep-vs-pairwise comparison (DESIGN.md §4).
    hier_groups=G > 1 runs each fourstep cell on a (G, D/G) two-level
    mesh with the hierarchical transpose decomposition (hier_axes) —
    the DCN x ICI shape — for device counts divisible by G.
    Returns one row per mesh size with ntts_per_sec and efficiency.
    """
    import jax
    from jax.sharding import Mesh

    from ntt_aie.parallel.fourstep import (
        build_distributed_plan, build_pairwise_plan,
    )
    from ntt_aie.utils.timing import time_device

    devices = jax.devices()
    rows = []
    base_rate: Optional[float] = None
    rng = np.random.default_rng(0)
    for D in device_counts:
        if D > len(devices):
            if verbose:
                print(f"D={D}: skipped (only {len(devices)} devices)")
            continue
        ln = log_n if mode == "strong" else log_n + (D.bit_length() - 1)
        # Square-ish split: both n1 (transpose) and n2 (columns) must divide
        # by D, which the throughput-biased default split can violate at
        # small n.
        cfg = NTTConfig(field=field, log_n=ln, num_shards=D,
                        rows_log2=ln // 2)
        hier_axes = None
        if (hier_groups > 1 and topology == "fourstep"
                and D % hier_groups == 0 and D > hier_groups):
            hier_axes = ("dcn", "ici")
            mesh = Mesh(np.array(devices[:D]).reshape(hier_groups,
                                                      D // hier_groups),
                        hier_axes)
        else:
            mesh = Mesh(np.array(devices[:D]), (cfg.mesh_axis,))
        n1, n2 = cfg.split
        a = rng.integers(0, min(field.p, 1 << 32), (batch, n1, n2))
        if topology == "pairwise":
            pw_fwd, in_sh = build_pairwise_plan(cfg, mesh)
            xs = [jax.device_put(a[i].reshape(-1).astype(np.uint32), in_sh)
                  for i in range(batch)]

            def step(ys):
                # forward-only chain (the pairwise mode has no inverse);
                # each iteration = batch transforms
                return [pw_fwd(y) for y in ys]

            per_iter_transforms = batch
        else:
            chunks = overlap_chunks if n1 % (D * overlap_chunks) == 0 else 1
            plan = build_distributed_plan(cfg, mesh,
                                          overlap_chunks=chunks,
                                          wmat_factored=wmat_factored,
                                          hier_axes=hier_axes)
            xs = [plan.shard_input(a[i].reshape(-1)) for i in range(batch)]

            # fwd+inv roundtrip keeps the chained shape (n1, n2) stable for
            # any split; each iteration = 2*batch transforms.
            def step(ys):
                return [plan.inv(plan.fwd(y)) for y in ys]

            per_iter_transforms = 2 * batch

        res = time_device(step, xs, iters=iters, repeats=repeats)
        us_per_ntt = res["us_per_iter"] / per_iter_transforms
        rate = 1e6 / us_per_ntt
        if base_rate is None:
            base_rate = rate
            base_d = D
            eff = 1.0
        elif mode == "strong":
            # relative to the FIRST measured device count (need not be 1)
            eff = rate / (base_rate * (D / base_d))
        else:  # weak: same per-device work, rate should stay ~flat per shard
            eff = rate / base_rate
        row = {
            "devices": D,
            "log_n": ln,
            "split": cfg.split,
            "us_per_ntt": round(us_per_ntt, 2),
            "ntts_per_sec": round(rate, 2),
            "efficiency": round(eff, 4),
            "mode": mode,
            "topology": topology,
            "overlap_chunks": overlap_chunks if topology == "fourstep" else None,
            # report the EFFECTIVE mode (None resolves to the builder's
            # factored default for distributed plans)
            "wmat_factored": ((True if wmat_factored is None
                               else bool(wmat_factored))
                              if topology == "fourstep" else None),
            "hier": list(mesh.shape.values()) if hier_axes else None,
        }
        rows.append(row)
        if verbose:
            print(f"D={D}  n=2^{ln}  {us_per_ntt:10.1f} us/NTT  "
                  f"{rate:10.1f} NTT/s  eff={eff:6.1%}")
    return rows
