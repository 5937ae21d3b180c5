"""Global image statistics: per-channel brightness/contrast (counterpart of
``photohive_dsp_tpu/ops/stats.py``).

reference: src/image_processing.c:533-553 (brightness = per-channel mean,
contrast = per-channel stddev via the two-pass mean/variance reducers in
src/filtering.c:125-148).  PyTorch's float32 reductions are tree sums on
the CPU and the GPU, so their rounding stays near the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def reciprocal_f32(n) -> np.float32:
    """The float32 reciprocal of float32(n), as XLA folds a division by the
    constant n: the one multiplier every constant division of the port
    uses (``div_const``, the cell-id steps of ``quantize.assign_cells``,
    ``palette_kernels.cell_index`` and the kernels' ``CellParams``)."""
    return np.float32(1.0) / np.float32(n)


def fma_f32(a, b, c) -> torch.Tensor:
    """float32 round(a * b + c) with one rounding, as XLA emits a float32
    multiply-add it contracts (inside ``jax.jit`` on the CPU), on the
    device of the tensor operands; Python scalars are taken as float32.

    PyTorch has no float32 FMA that promises one rounding, so the sum runs
    in float64: the product of two float32 values is exact there (48
    bits), and the float64 sum rounds once more only where it lands on a
    float32 midpoint that the exact sum misses.  There the exact remainder
    (TwoSum) says which neighbour the exact sum is nearer.  Scalars stay
    on the host (a scalar copied to the card would wait for its queue)."""
    a, b, c = (x.double() if isinstance(x, torch.Tensor)
               else float(np.float32(x)) for x in (a, b, c))
    p = a * b
    s = p + c
    p_part = s - c
    rem = (p - p_part) + (c - (s - p_part))       # p + c == s + rem exactly
    r = s.float()
    rd = r.double()
    toward_s = torch.where(rd < s, torch.inf, -torch.inf).float()
    other = torch.nextafter(r, toward_s)
    tie = ((rd + other.double()) * 0.5 == s) & (rem != 0)
    nearer = torch.where(rem > 0, torch.maximum(r, other),
                         torch.minimum(r, other))
    return torch.where(tie, nearer, r)


def div_const(x: torch.Tensor, n) -> torch.Tensor:
    """x / n for a constant n, computed as XLA lowers it: x times the
    float32 reciprocal of n.  The JAX package's results carry that rounding
    (e.g. palette percentages, the cell ids), and the port matches them bit
    for bit.  A multiply rounds alike on the CPU and the card."""
    return x * float(reciprocal_f32(n))


def mean_and_std(x: torch.Tensor, dims=(-2, -1)):
    """Two-pass mean/stddev over ``dims``, like the reference's reducers."""
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.square(x - mean).mean(dim=dims, keepdim=True)
    return mean.squeeze(dims), torch.sqrt(var).squeeze(dims)


def rgb_statistics(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) -> (..., 6) [Br, Bg, Bb, Cr, Cg, Cb].

    reference: src/image_processing.c:543-553."""
    mean, std = mean_and_std(rgb)
    return torch.cat([mean, std], dim=-1)


def blur_dc(stats: torch.Tensor) -> torch.Tensor:
    """(..., 6) ``rgb_statistics`` -> (...) the DC term the blur stage
    removes from the luma, (Br + Bg + Bb) / 3, with the division as XLA
    lowers it (``div_const``)."""
    return div_const(stats[..., 0] + stats[..., 1] + stats[..., 2], 3)


def mean_saturation(s: torch.Tensor) -> torch.Tensor:
    """(B, H, W) saturation planes -> (B,) mean (reference
    src/image_processing.c:533-540).  The sum runs in float64, then the
    division by the pixel count as XLA lowers it (``div_const``)."""
    total = s.sum(dim=(-2, -1), dtype=torch.float64).float()
    return div_const(total, s.shape[-2] * s.shape[-1])
