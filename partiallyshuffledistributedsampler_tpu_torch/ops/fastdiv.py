"""Division by an invariant divisor as a multiply-high, computed on the host.

A CUDA kernel that divides many numerators by one runtime divisor ``d``
pays a reciprocal sequence per division.  With the magic number of ``d``
(Granlund and Montgomery, "Division by invariant integers using
multiplication", 1994, fig. 4.1) a division is one multiply-high, a
subtract, an add and two shifts, exact for every ``bits``-bit numerator:

    l = ceil(log2 d);  mult = floor(2^bits * (2^l - d) / d) + 1
    s1 = min(l, 1);    s2 = max(l - 1, 0)
    t = (n * mult) >> bits;  n // d = (t + ((n - t) >> s1)) >> s2

``magic`` computes ``(mult, s1, s2)``; the kernels take them as launch
arguments (``csrc/law.cuh`` ``magic_div``).  ``divide`` is the same
arithmetic in Python, the plain version the tests hold against ``//``.
"""

from __future__ import annotations


def magic(d: int, bits: int = 32) -> tuple:
    """``(mult, s1, s2)`` of divisor ``d`` in ``[1, 2^bits)`` for
    ``bits``-bit numerators (``bits`` 32 or 64); ``mult < 2^bits``."""
    d = int(d)
    if bits not in (32, 64):
        raise ValueError(f"bits must be 32 or 64, got {bits}")
    if not 1 <= d < 1 << bits:
        raise ValueError(f"divisor must be in [1, 2^{bits}), got {d}")
    lg = (d - 1).bit_length()  # ceil(log2 d)
    mult = ((1 << bits) * ((1 << lg) - d)) // d + 1
    return mult, min(lg, 1), max(lg - 1, 0)


def divide(n: int, m: tuple, bits: int = 32) -> int:
    """``n // d`` by the magic number ``m = magic(d, bits)``, as the kernels
    compute it, for ``n`` in ``[0, 2^bits)``."""
    mult, s1, s2 = m
    t = (int(n) * mult) >> bits
    return (t + ((int(n) - t) >> s1)) >> s2
