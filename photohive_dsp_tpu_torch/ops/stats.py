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


def div_const(x: torch.Tensor, n) -> torch.Tensor:
    """x / n for a constant n, computed as XLA lowers it: x times the
    float32 reciprocal of n.  The JAX package's results carry that rounding
    (e.g. palette percentages), and the port matches them bit for bit."""
    return x * float(np.float32(1.0) / np.float32(n))


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
