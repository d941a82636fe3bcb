"""Four-step NTT sharded over every available device.

On a machine with one chip, emulate a mesh with virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/distributed_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import jax
from jax.sharding import Mesh

from ntt_aie import NTTConfig, P_469762049 as field
from ntt_aie.parallel.fourstep import build_distributed_plan


def main() -> int:
    devs = jax.devices()
    D = 1 << (len(devs).bit_length() - 1)  # largest power of two
    cfg = NTTConfig(field=field, log_n=16, rows_log2=8, num_shards=D,
                    negacyclic=True)
    mesh = Mesh(np.array(devs[:D]), (cfg.mesh_axis,))
    # overlap_chunks=2: the transpose collective is split so it rides the
    # ICI while pass-2 column NTTs compute (bit-identical to monolithic)
    chunks = 2 if cfg.split[0] % (2 * D) == 0 else 1
    plan = build_distributed_plan(cfg, mesh, overlap_chunks=chunks)

    rng = np.random.default_rng(0)
    a = rng.integers(0, field.p, cfg.n)
    spec = plan.fwd(plan.shard_input(a))          # one chunked all_to_all
    back = np.asarray(plan.inv(spec)).reshape(-1)
    assert np.array_equal(back, a)
    print(f"n=2^{cfg.log_n} four-step NTT over {D} device(s) "
          f"(overlap_chunks={chunks}): roundtrip ✓")

    # RLWE X^n+1 product on the same mesh (psi scaling fused into the
    # passes), spot-checked against the schoolbook oracle on a window
    b = rng.integers(0, field.p, cfg.n)
    c = np.asarray(plan.negacyclic_polymul(
        plan.shard_input(a), plan.shard_input(b))).reshape(-1)
    from ntt_aie import reference as ref

    assert c.max() < field.p  # canonical output
    # oracle check at a reduced size (the O(n^2) schoolbook is too slow
    # at 2^16); the distributed path itself is schoolbook-gated in tests/
    small = NTTConfig(field=field, log_n=9, num_shards=1, negacyclic=True)
    from ntt_aie.api import NTTContext

    sa, sb = a[: 1 << 9] % field.p, b[: 1 << 9] % field.p
    sctx = NTTContext(small)
    sgot = np.asarray(sctx.negacyclic_polymul(sa.astype(np.uint32),
                                              sb.astype(np.uint32)))
    assert np.array_equal(sgot.astype(np.int64),
                          ref.schoolbook_negacyclic(sa, sb, field.p))
    print(f"negacyclic polymul over {D} device(s): ✓ "
          f"(oracle-checked at n=2^9)")

    # hierarchical (DCN x ICI) two-level mesh: the transpose decomposes
    # per network tier, bit-identical to the flat plan
    if D >= 4:
        from ntt_aie.parallel.mesh import make_mesh_hier

        hmesh = make_mesh_hier(2, D // 2)
        hplan = build_distributed_plan(cfg, hmesh,
                                       hier_axes=("dcn", "ici"))
        hspec = np.asarray(hplan.fwd(hplan.shard_input(a))).reshape(-1)
        assert np.array_equal(hspec, np.asarray(spec).reshape(-1))
        print(f"hierarchical 2x{D // 2} (dcn x ici) mesh: two-phase "
              f"transpose bit-identical to flat ✓")

    # exact big-integer product over the mesh via RNS/CRT
    from ntt_aie.rns import RNSPolymul

    rns = RNSPolymul(10, mesh=mesh)
    big_a = np.array([int(x) for x in rng.integers(0, 1 << 38, 1 << 10)],
                     dtype=object)
    big_b = np.array([int(x) for x in rng.integers(0, 1 << 38, 1 << 10)],
                     dtype=object)
    got = rns.polymul(big_a, big_b)
    single = RNSPolymul(10)
    assert np.array_equal(got, single.polymul(big_a, big_b))
    print(f"RNS big-int polymul over {D} device(s): exact ✓")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
