"""The 64-bit fixed point the palette and polar kernels sum on.

Each value is rounded to nearest once onto FRACTION_BITS fraction bits,
then added as an integer, so a sum is exact and the same for any order of
addition, any block split and any number of ranks: accumulators from
several ranks add as int64 (the same bits as the kernels' unsigned 64-bit
words) and are converted once.  The conversions here are the kernels'
(``to_fixed`` / ``from_fixed`` in csrc/palette.cu, csrc/polar.cu) bit for
bit: round half to even into the integer, then int64 -> float64, an exact
division by 2^28, and one rounding to float32.
"""

from __future__ import annotations

import torch

FRACTION_BITS = 28
FIXED_ONE = float(1 << FRACTION_BITS)


def to_fixed(x: torch.Tensor) -> torch.Tensor:
    """float32 values >= 0 -> int64 fixed point."""
    return torch.round(x.double() * FIXED_ONE).long()


def from_fixed(acc: torch.Tensor) -> torch.Tensor:
    """int64 fixed-point sums -> float32."""
    return (acc.double() / FIXED_ONE).float()
