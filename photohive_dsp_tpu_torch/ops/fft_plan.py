"""Host plans for the FFT kernels (counterpart of the planning half of
``photohive_dsp_tpu/ops/pallas_fft.py``: ``_factor_235``, ``eligible`` /
``use_pallas_fft`` and ``FftPlan.for_shape``).

A length-n transform runs as a mixed-radix Stockham FFT (csrc/fft.cu): one
pass per radix, natural order in and out, so no digit-reversal table
exists.  The plan of a length holds its stage radices and one twiddle table
exp(-2 pi i t / n), t < n, computed in float64 and stored as float32; every
twiddle a stage needs is an entry of it (stage s of radix r after a span
ns multiplies by W_{ns r}^{q k} = table[q k n / (ns r)], and its r-point
DFT uses W_r^u = table[u n / r]).

Unlike the TPU kernels, the gate asks nothing of the (8, 128) tiling: both
sides must factor into {2, 3, 5, 7, 11, 13} and fit the kernels' shared
memory.  Shapes outside it take the torch route (ops/fft.py), decided here
from the shape alone.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

RADIX_PRIMES = (2, 3, 5, 7, 11, 13)
# The kernels keep two complex float32 buffers of one sequence in shared
# memory: 2 * 8 * n bytes <= 232,448 (what an H100 block may take).
MAX_LENGTH = 14528


def factor(n: int) -> Optional[list]:
    """Ascending prime factors of n from RADIX_PRIMES, or None if another
    prime divides n (``pallas_fft._factor_235``)."""
    fs = []
    for p in RADIX_PRIMES:
        while n % p == 0:
            fs.append(p)
            n //= p
    return fs if n == 1 else None


def stage_radices(n: int) -> Tuple[int, ...]:
    """The kernels' stage radices for length n, in the order they run:
    pairs of 2 merged into radix-4 stages first, then the rest ascending."""
    fs = factor(n)
    if fs is None:
        raise ValueError(f"length {n} has a prime factor above 13")
    twos = fs.count(2)
    return (4,) * (twos // 2) + (2,) * (twos % 2) + tuple(
        f for f in fs if f != 2)


def fft_kernel_eligible(height: int, width: int) -> bool:
    """Whether the FFT kernels take an (height, width) image: both sides
    factor into RADIX_PRIMES and fit in shared memory."""
    return all(1 <= n <= MAX_LENGTH and factor(n) is not None
               for n in (height, width))


@functools.lru_cache(maxsize=32)
def twiddle_table(n: int) -> np.ndarray:
    """(n, 2) float32 [re, im] of exp(-2 pi i t / n), from float64; the
    quarter turns (1, -i, -1, i) are exact, so the radix-2 and radix-4
    butterflies multiply by exact 0 and +-1."""
    t = np.arange(n)
    tw = np.exp(-2j * np.pi * t / n)
    quarter = (4 * t) % n == 0
    tw[quarter] = np.array([1, -1j, -1, 1j])[(4 * t[quarter]) // n]
    return np.stack([tw.real, tw.imag], axis=1).astype(np.float32)


class LengthPlan(NamedTuple):
    """One transform length: its stages and twiddle table."""

    n: int
    radices: Tuple[int, ...]
    twiddles: torch.Tensor    # (n, 2) float32, on the plan's device

    @classmethod
    def for_length(cls, n: int, device="cpu") -> "LengthPlan":
        return cls(n=n, radices=stage_radices(n),
                   twiddles=torch.tensor(twiddle_table(n), device=device))


class FftPlan(NamedTuple):
    """The 2-D plan of one image shape: rows of length W (real input,
    W//2+1 outputs kept), then columns of length H."""

    height: int
    width: int
    rows: LengthPlan
    cols: LengthPlan

    @property
    def half(self) -> int:
        return self.width // 2 + 1

    @classmethod
    @functools.lru_cache(maxsize=32)
    def for_shape(cls, height: int, width: int, device="cpu") -> "FftPlan":
        """The plan of an (height, width) image on ``device``, built once
        per shape and device."""
        if not fft_kernel_eligible(height, width):
            raise ValueError(f"{height}x{width} is outside the FFT kernels' "
                             "gate (fft_kernel_eligible)")
        return cls(height=height, width=width,
                   rows=LengthPlan.for_length(width, device),
                   cols=LengthPlan.for_length(height, device))
