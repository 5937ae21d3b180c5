"""2-D real FFT magnitude and log normalisation (counterpart of
``photohive_dsp_tpu/ops/fft.py``).

reference: src/fft_processing.c
  * pgm_fft (:18-63): real-to-complex 2-D transform; |X|^2 over the half
    spectrum of width W//2+1.
  * pgm_normalize_fft (:173-213): global max, G_s = 1/(2*log(sqrt(max)+1)),
    then x < 1 -> 0 else log(x)*G_s.

This is the JAX package's XLA route (``jnp.fft.rfft2``), here
``torch.fft.rfft2`` in complex64, taken by shapes outside the FFT kernels'
gate (fft_plan.fft_kernel_eligible); the others take
blur.blur_bins_lognorm.
"""

from __future__ import annotations

import torch


def magnitude_fft(pgm: torch.Tensor) -> torch.Tensor:
    """|rfft2(pgm)|^2 over the last two dims: (..., H, W//2+1) float32."""
    spec = torch.fft.rfft2(pgm)
    return torch.square(spec.real) + torch.square(spec.imag)


def normalize_fft(mag_sq: torch.Tensor) -> torch.Tensor:
    """Log compression with the reference's G_s gain, per image (the max is
    taken over the last two dims)."""
    mx = mag_sq.amax(dim=(-2, -1), keepdim=True)
    g_s = 1.0 / (2.0 * torch.log(torch.sqrt(mx) + 1.0))
    below = mag_sq < 1.0
    safe = torch.where(below, torch.ones_like(mag_sq), mag_sq)
    return torch.where(below, torch.zeros_like(mag_sq), torch.log(safe) * g_s)


def magnitude_fft_normalized(pgm_dc_removed: torch.Tensor) -> torch.Tensor:
    """compute_magnitude_fft equivalent (reference
    src/fft_processing.c:70-74)."""
    return normalize_fft(magnitude_fft(pgm_dc_removed))
