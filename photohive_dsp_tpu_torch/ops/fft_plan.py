"""Host plans for the FFT kernels (counterpart of the planning half of
``photohive_dsp_tpu/ops/pallas_fft.py``: ``_factor_235``, ``eligible`` /
``use_pallas_fft`` and ``FftPlan.for_shape``).

A length-n transform runs as a mixed-radix Stockham FFT (csrc/fft.cu): one
stage per radix, two adjacent stages fused into one pass where
``row_passes`` says, natural order in and out, so no digit-reversal table
exists.  The plan of a length holds its stage radices and one twiddle table
exp(-2 pi i t / n), t < n, computed in float64 and stored as float32; every
twiddle a stage needs is an entry of it (stage s of radix r after a span
ns multiplies by W_{ns r}^{q k} = table[q k n / (ns r)], and its r-point
DFT uses W_r^u = table[u n / r]).  The plan also lays the stage twiddles
out per stage (``stage_twiddle_table``), so that the kernels read a
stage's twiddles contiguously: the same float32 values, gathered once.
``col_tile`` chooses how the column kernel lays a tile of columns out in
shared memory.

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


# Adjacent stage radices (r1, r2) that both kernels run as one pass in
# registers (csrc/fft.cu fused_pair): r1 r2 <= 16, in the order
# stage_radices gives them.
FUSED_PAIRS = frozenset({(4, 4), (4, 2), (4, 3), (2, 3), (2, 5), (2, 7),
                         (3, 3), (3, 5)})


def row_passes(radices) -> Tuple[Tuple[int, int], ...]:
    """The kernels' passes over ``radices`` (the row kernel's and the
    column kernel's alike): (r1, r2) for two stages run as one, (r, 1) for
    a stage alone; pairs are taken greedily from the first stage."""
    out, s = [], 0
    while s < len(radices):
        pair = tuple(radices[s:s + 2])
        if pair in FUSED_PAIRS:
            out.append(pair)
            s += 2
        else:
            out.append((radices[s], 1))
            s += 1
    return tuple(out)


# What one block may take on an H100, and the column kernel's threads a
# block (csrc/fft.cu kColThreads; one such block an SM).
MAX_SHARED = 232448
COL_THREADS = 512


class ColTile(NamedTuple):
    """The column kernel's tile for columns of length n (csrc/fft.cu
    fft_cols_kernel): ``lanes`` adjacent columns a block (a power of 2,
    ``lane_bits`` its log), two buffers of ``seq`` float2 (n x lanes
    rounded up to a 128-byte line, which the swizzle stays within), after
    the stage twiddle table (``tw_len`` float2, n - 1 rounded up to even)
    when ``stw_shared``; ``bytes`` of shared memory in all."""

    lane_bits: int
    stw_shared: bool
    tw_len: int
    seq: int
    bytes: int

    @property
    def lanes(self) -> int:
        return 1 << self.lane_bits


def col_tile(n: int) -> ColTile:
    """The widest tile of 8, 4, 2 or 1 columns whose buffers and twiddle
    table fit MAX_SHARED (8 at n = 1080, 4 at 2160); past that, one column
    with the table in device memory (16 n bytes: n <= MAX_LENGTH fits)."""
    tw_len = n & ~1

    def tile(lane_bits, shared):
        seq = (n * (1 << lane_bits) + 15) & ~15
        return ColTile(lane_bits, shared, tw_len, seq,
                       8 * (tw_len if shared else 0) + 16 * seq)

    for lane_bits in (3, 2, 1, 0):
        t = tile(lane_bits, True)
        if t.bytes <= MAX_SHARED:
            return t
    return tile(0, False)


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


@functools.lru_cache(maxsize=32)
def stage_twiddle_table(n: int) -> np.ndarray:
    """(max(n - 1, 0), 2) float32: the twiddles W_{ns r}^{q k} of every
    stage, laid out [stage][q][k] for q = 1..r-1 and k < ns, where ns is
    the stage's span and r its radix.  Stage s starts at row ns - 1 (the
    spans telescope: sum (r - 1) ns = n - 1), entry (q, k) at
    (q - 1) ns + k; each entry is twiddle_table(n)[q k n / (ns r)]."""
    table = twiddle_table(n)
    parts, ns = [], 1
    for r in stage_radices(n):
        q = np.arange(1, r)[:, None]
        k = np.arange(ns)[None, :]
        parts.append(table[(q * k * (n // (ns * r))).reshape(-1)])
        ns *= r
    return (np.concatenate(parts) if parts
            else np.zeros((0, 2), np.float32))


class LengthPlan(NamedTuple):
    """One transform length: its stages and twiddle tables."""

    n: int
    radices: Tuple[int, ...]
    twiddles: torch.Tensor        # (n, 2) float32, on the plan's device
    stage_twiddles: torch.Tensor  # (n - 1, 2) float32 (stage_twiddle_table)

    @classmethod
    def for_length(cls, n: int, device="cpu") -> "LengthPlan":
        return cls(n=n, radices=stage_radices(n),
                   twiddles=torch.tensor(twiddle_table(n), device=device),
                   stage_twiddles=torch.tensor(stage_twiddle_table(n),
                                               device=device))


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
