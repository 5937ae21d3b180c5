"""Small FIR stencils (counterpart of ``photohive_dsp_tpu/ops/filtering.py``).

* 3x3 Laplacian with zero-padded borders — reference src/filtering.c:40-50
  (kernel) and :81-107 (zero-padded correlation).  Written as padded
  slice-adds, as the JAX package does, and not as ``conv2d``: cuDNN runs
  float32 convolutions in TF32 by default.
* Trailing circular 1-D box smoother — reference src/filtering.c:12-24:
  result[i] = mean_{j=0..size-1} x[(i-j) mod n] (a *trailing* window).
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
