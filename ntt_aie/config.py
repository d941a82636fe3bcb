"""Configuration system.

The reference hard-wires everything as compile-time constants (logN, p, grid
shape, buffer depth in src/aie2.py:13-28; n, p, g, test_stage in
src/test.cpp:66-78) — changing a size means editing source and rebuilding
(SURVEY.md §5.6). Here configuration is a first-class dataclass that drives
plan building, kernels, sharding, and tests alike.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from ntt_aie.fields import PrimeField, FIELDS


@dataclasses.dataclass(frozen=True)
class NTTConfig:
    """Everything needed to build an NTT plan.

    Attributes:
      field: the prime field (modulus + generator).
      log_n: log2 of the transform size.
      reduction: 'auto' | 'barrett' | 'montgomery' | 'harvey' | 'harvey4'
        | 'goldilocks'.
      ordering: output ordering convention of the forward transform:
        'natural'   - true DFT order (costs one gather),
        'bitrev'    - DIF-native order (free; pointwise ops still work),
        'reference' - the reference device's blocked order
                      (butterfly-network semantics + ANS_ORDER_16,
                      reference src/test.cpp:69-71).
      table_convention: 'standard' uses proper DIF/DIT twiddles; 'reference'
        feeds the natural-order power table through the reference's
        increasing-stride network for bit-exact parity (SURVEY.md §0).
      rows_log2: log2 of N1 in the N = N1 x N2 four-step split. None =
        choose automatically: FLAT (N2 = 1, batch rides lanes) for
        single-shard transforms up to 2^16 (2^14 for 64-bit fields),
        square-ish lane-aligned four-step above / when sharded. The
        automatic split — and therefore the 'bitrev' spectral output
        order — may change between versions as the heuristic is retuned;
        pin rows_log2 when persisting spectral-domain data.
      mesh_axis: name of the mesh axis coefficients are sharded over.
      num_shards: number of devices for the distributed plan (1 = local).
      negacyclic: plan psi-scaling tables for X^n + 1 arithmetic.
    """

    field: PrimeField
    log_n: int
    reduction: str = "auto"
    ordering: str = "bitrev"
    table_convention: str = "standard"
    rows_log2: Optional[int] = None
    mesh_axis: str = "x"
    num_shards: int = 1
    negacyclic: bool = False

    def __post_init__(self):
        if self.reduction not in ("auto", "barrett", "montgomery", "harvey",
                                  "harvey4", "goldilocks"):
            raise ValueError(f"unknown reduction {self.reduction!r}")
        if self.ordering not in ("natural", "bitrev", "reference"):
            raise ValueError(f"unknown ordering {self.ordering!r}")
        if self.table_convention not in ("standard", "reference"):
            raise ValueError(f"unknown table convention {self.table_convention!r}")
        if self.table_convention == "standard" and self.n > self.field.max_n:
            raise ValueError(
                f"n=2^{self.log_n} exceeds the field's max NTT size "
                f"{self.field.max_n} (p={self.field.p})"
            )
        if self.negacyclic and 2 * self.n > self.field.max_n:
            raise ValueError("negacyclic needs a primitive 2n-th root")
        if self.num_shards & (self.num_shards - 1):
            raise ValueError("num_shards must be a power of two")

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def resolved_reduction(self) -> str:
        from ntt_aie.ops.reductions import resolve_kind

        return resolve_kind(self.reduction, self.field)

    @property
    def split(self) -> tuple[int, int]:
        """(N1, N2) for the four-step decomposition. N1 = rows (the local
        butterfly axis), N2 = columns (the lane/shard axis)."""
        if self.rows_log2 is not None:
            r = self.rows_log2
        else:
            shards_log2 = self.num_shards.bit_length() - 1
            # Flat (N2 = 1, plain DIF, the batch rides the lane axis) up
            # to 2^16 for 32-bit primes, 2^14 for Goldilocks limb pairs.
            # Not yet tuned on the GPU; a retune changes the spectral
            # order, so it is a data-format change.
            flat_max = 14 if self.field.p >= (1 << 32) else 16
            if shards_log2 == 0 and self.log_n <= flat_max:
                r = self.log_n
            else:
                # Square-ish, biased so N2 (the lane/shard axis) >= 128
                # lanes and divides cleanly by num_shards.
                r = min(self.log_n - 7 - shards_log2, self.log_n // 2)
                if r < 1:
                    r = self.log_n
        return (1 << r, 1 << (self.log_n - r))

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["field"] = self.field.name or {"p": self.field.p, "g": self.field.g}
        # The resolved split is recorded (not just rows_log2, which may be
        # None) so persisted spectral-domain data stays interpretable even
        # if the automatic split heuristic is retuned between versions.
        d["resolved_split"] = list(self.split)
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "NTTConfig":
        d = json.loads(s)
        d.pop("resolved_split", None)  # informational, not a field
        f = d.pop("field")
        field = FIELDS[f] if isinstance(f, str) else PrimeField(p=f["p"], g=f["g"])
        return NTTConfig(field=field, **d)
