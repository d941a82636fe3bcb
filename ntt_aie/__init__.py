"""ntt_aie — a Number Theoretic Transform framework in JAX for NVIDIA GPUs.

A from-scratch JAX/shard_map rebuild of the capabilities of the
hal-lab-u-tokyo/ntt-aie reference (MCSoC-2024, AMD Ryzen AI NPU):

- modular arithmetic in int32/uint32 lanes (Barrett for small primes,
  Montgomery with 32-bit limb decomposition for word primes, Goldilocks
  2^64-2^32+1 via two-limb reduction),
- local NTTs as four-step column passes with butterflies along the row
  axis (instead of the reference's lane-shuffle stages, cf. reference
  src/aie_core.cc:211-336): XLA stage loops, or one CUDA kernel per pass
  on an H100 (ops/cuda_colpass.py),
- scale-out via shard_map four-step NTT with all_to_all transposes
  (replacing the reference's AIE stream-switch / lock network,
  cf. reference src/aie2.py:83-154),
- bit-exact NumPy + native C++ golden oracles mirroring the reference's CPU
  oracle (reference src/test.cpp:15-60).
"""

from ntt_aie.fields import (
    PrimeField,
    KYBER,
    DILITHIUM,
    P_998244353,
    P_2013265921,
    P_469762049,
    GOLDILOCKS,
    modpow,
    primitive_root,
    max_ntt_size,
)
from ntt_aie.config import NTTConfig
from ntt_aie.api import NTTContext
from ntt_aie.rns import RNSPolymul
from ntt_aie.ops.crt import limbs_to_int, make_crt_combine

__version__ = "0.1.0"

__all__ = [
    "PrimeField",
    "KYBER",
    "DILITHIUM",
    "P_998244353",
    "P_2013265921",
    "P_469762049",
    "GOLDILOCKS",
    "modpow",
    "primitive_root",
    "max_ntt_size",
    "NTTConfig",
    "NTTContext",
    "RNSPolymul",
    "limbs_to_int",
    "make_crt_combine",
]
