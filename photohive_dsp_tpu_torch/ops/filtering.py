"""Small FIR stencils (counterpart of ``photohive_dsp_tpu/ops/filtering.py``).

* 3x3 Laplacian with zero-padded borders — reference src/filtering.c:40-50
  (kernel) and :81-107 (zero-padded correlation).  Written as padded
  slice-adds, as the JAX package does, and not as ``conv2d``: cuDNN runs
  float32 convolutions in TF32 by default.
* Trailing circular 1-D box smoother — reference src/filtering.c:12-24:
  result[i] = mean_{j=0..size-1} x[(i-j) mod n] (a *trailing* window).
* The general FIR and the reference's unused alternates
  (src/filtering.c:58, 110, 186), for component parity: on neither
  package's report path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .stats import div_const


def laplacian_3x3(x: torch.Tensor) -> torch.Tensor:
    """response = 8*x - sum of the 8 zero-padded neighbours, over the last
    two dims.  Same separable form as the JAX package: one horizontal
    triple-sum, a vertical triple-sum of it, and 9x - box3x3."""
    h = F.pad(x, (1, 1))
    t = h[..., :-2] + h[..., 1:-1] + h[..., 2:]
    v = F.pad(t, (0, 0, 1, 1))
    box = v[..., :-2, :] + v[..., 1:-1, :] + v[..., 2:, :]
    return 9.0 * x - box


def trailing_circular_box(x: torch.Tensor, size: int) -> torch.Tensor:
    """Circular trailing box mean along the last dim (reference
    src/filtering.c:12-24)."""
    acc = x
    for j in range(1, size):
        acc = acc + torch.roll(x, j, dims=-1)
    return div_const(acc, size)


SHARPNESS_AVG_THRESHOLD = 0.2  # reference src/filtering.c:6


def filter_image(x: torch.Tensor, taps) -> torch.Tensor:
    """Zero-padded 2-D correlation of the last two dims with an (fh, fw)
    tap matrix (reference filter_image, src/filtering.c:81-107): no kernel
    flip, no normalisation, out-of-image taps contribute zero.

    ``taps`` may be nested lists; they are cast to x's dtype and device.
    Written as fh*fw shifted products added in row-major tap order, a
    multiply and an add apiece, so the result is the same on every device
    (``conv2d`` would run in TF32 under cuDNN's default).  The JAX package
    runs one XLA convolution, whose summation order differs."""
    taps = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    fh, fw = taps.shape
    h, w = x.shape[-2:]
    xp = F.pad(x, (fw // 2, (fw - 1) // 2, fh // 2, (fh - 1) // 2))
    out = torch.zeros_like(x)
    for fy in range(fh):
        for fx in range(fw):
            out = out + taps[fy, fx] * xp[..., fy:fy + h, fx:fx + w]
    return out


def create_filtered_rgb(rgb: torch.Tensor, taps) -> torch.Tensor:
    """Per-channel FIR over a (3, H, W) image (reference
    src/filtering.c:110-117)."""
    return filter_image(rgb, taps)


def sharpness_avg(response: torch.Tensor) -> torch.Tensor:
    """Mean of the response values above SHARPNESS_AVG_THRESHOLD
    (reference src/filtering.c:58-72); NaN when none is above it (0/0), as
    in the reference."""
    mask = response > SHARPNESS_AVG_THRESHOLD
    total = torch.where(mask, response, torch.zeros_like(response)).sum()
    return total / mask.sum()


def average_sharpness(pgm: torch.Tensor) -> torch.Tensor:
    """get_average_sharpness (reference src/filtering.c:186-199): the
    Laplacian response's thresholded mean."""
    return sharpness_avg(laplacian_3x3(pgm))
