"""Elementwise colorspace transforms (counterpart of
``photohive_dsp_tpu/ops/colorspace.py``).

Semantics replicate the reference exactly, including its clamps and branch
order:
  * rgb->hsv: reference src/image_processing.c:372-417 (textbook max/min/delta
    with S and V clamped to 0.999999 and hue wrapped into [0, 360)).
  * rgb->pgm luma: reference src/image_processing.c:505-512.
  * decimation: reference src/image_processing.c:344-366 — output row y
    samples input row y*(N-1), not y*N; reproduced faithfully.

Every op here is one IEEE float32 operation per element (eager PyTorch
never contracts a multiply and an add into an FMA), so the results are
bit-equal to the JAX package's on the same inputs.  Python float constants
are rounded to float32 by PyTorch's type promotion, as JAX's weak typing
does.
"""

from __future__ import annotations

import torch

from ..config import MAX_SATURATION, MAX_VALUE

# f32(1/255), the correctly rounded reciprocal used by u8_to_unit_f32.
INV255_F32 = 0.003921568859368563


def u8_to_unit_f32(x: torch.Tensor) -> torch.Tensor:
    """uint8 0..255 -> float32 x/255 with correctly rounded results.

    The same division-free sequence as the JAX package (IEEE mul/add only,
    the *256 as an exponent add on the bit pattern), so the planes are
    bit-identical to host ``x / 255.0`` and to the CUDA kernels' in-kernel
    ``__fdiv_rn(x, 255.f)``."""
    xf = x.to(torch.float32)
    q0 = xf * INV255_F32
    s = (q0.view(torch.int32) + (8 << 23)).view(torch.float32)
    d = xf - s
    r = d + q0
    q = q0 + r * INV255_F32
    return torch.where(xf == 0.0, torch.zeros_like(q), q)


def rgb_to_hsv(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """Per-pixel HSV with the reference's branch order and clamps.

    Returns (h, s, v); h in [0, 360), s and v in [0, 0.999999]."""
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = mx - mn
    one = torch.ones_like(delta)
    zero = torch.zeros_like(delta)
    safe = torch.where(delta == 0, one, delta)
    # Branch order matters on ties: delta==0, then max==r, then max==g,
    # else b (reference src/image_processing.c:394-397).
    h = torch.where(
        delta == 0,
        zero,
        torch.where(
            mx == r,
            60.0 * ((g - b) / safe),
            torch.where(mx == g, 60.0 * (2.0 + (b - r) / safe),
                        60.0 * (4.0 + (r - g) / safe)),
        ),
    )
    h = torch.where(h < 0, h + 360.0, h)
    h = torch.where(h > 360, h - 360.0, h)
    v = torch.where(mx == 1.0, torch.full_like(mx, MAX_VALUE), mx)
    safe_mx = torch.where(mx == 0, one, mx)
    s = torch.where(
        mx == 0,
        zero,
        torch.where(delta == mx, torch.full_like(mx, MAX_SATURATION),
                    delta / safe_mx),
    )
    return h, s, v


def rgb_to_pgm(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor)\
        -> torch.Tensor:
    """BT.601 luma (reference src/image_processing.c:509)."""
    return 0.299 * r + 0.587 * g + 0.114 * b


def downsample_rgb(rgb: torch.Tensor, rate: int) -> torch.Tensor:
    """Stride decimation with the reference's row-stride quirk.

    rgb: (..., 3, H, W).  Output row y takes input row y*(rate-1); output
    column x takes input column x*rate (reference
    src/image_processing.c:351-363)."""
    if rate <= 1:
        return rgb
    h, w = rgb.shape[-2:]
    rows = torch.arange(h // rate, device=rgb.device) * (rate - 1)
    cols = torch.arange(w // rate, device=rgb.device) * rate
    return rgb[..., rows, :][..., cols]
