"""Multiply two big integers exactly with RNS NTT polymul.

An integer is a polynomial in base 2^16 evaluated at x = 2^16; the product
polynomial's coefficients (exact via RNS/CRT) carry-propagate back into an
integer. Runs on the CPU or a GPU.

    python examples/bigint_multiply.py [bits]
"""



import sys
import pathlib


sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


import numpy as np

from ntt_aie.rns import RNSPolymul

BASE_BITS = 16


def int_to_coeffs(x: int, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=object)
    mask = (1 << BASE_BITS) - 1
    i = 0
    while x:
        out[i] = x & mask
        x >>= BASE_BITS
        i += 1
    return out


def coeffs_to_int(c) -> int:
    acc = 0
    for v in reversed(list(c)):
        acc = (acc << BASE_BITS) + int(v)
    return acc


def main(bits: int = 4096) -> int:
    rng = np.random.default_rng(0)
    x = int.from_bytes(rng.bytes(bits // 8), "little")
    y = int.from_bytes(rng.bytes(bits // 8), "little")

    digits = -(-bits // BASE_BITS)  # ceil: partial top limb counts
    log_n = (2 * digits - 1).bit_length()  # room for the full product
    rns = RNSPolymul(log_n)
    assert rns.max_input_bound() >= (1 << BASE_BITS) - 1

    c = rns.polymul(int_to_coeffs(x, 1 << log_n), int_to_coeffs(y, 1 << log_n))
    got = coeffs_to_int(c)
    assert got == x * y, "mismatch!"
    print(f"{bits}-bit x {bits}-bit multiply via n=2^{log_n} RNS NTT: exact ✓")
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 4096))
