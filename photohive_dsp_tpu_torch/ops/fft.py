"""2-D real FFT magnitude and log normalisation (counterpart of
``photohive_dsp_tpu/ops/fft.py``).

reference: src/fft_processing.c
  * pgm_fft (:18-63): real-to-complex 2-D transform; |X|^2 over the half
    spectrum of width W//2+1.
  * pgm_normalize_fft (:173-213): global max, G_s = 1/(2*log(sqrt(max)+1)),
    then x < 1 -> 0 else log(x)*G_s.

This is the JAX package's XLA route (``jnp.fft.rfft2``), here
``torch.fft.rfft2`` in complex64.  ``magnitude_fft`` is the FFT of shapes
outside the FFT kernels' gate (fft_plan.fft_kernel_eligible), whose |X|^2
the polar kernel bins (the operator ``photohive::spectrum_bins``); the
others take blur.blur_bins_lognorm.  ``normalize_fft`` feeds the gather
route (blur.blur_profile_bins), off the report path, as does
``fft_shift``, the dev/viz centring of a half spectrum
(src/fft_processing.c:111-157).
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


def fft_shift(half_mag: torch.Tensor) -> torch.Tensor:
    """Centre a half-spectrum magnitude for display: (..., H, W2) ->
    (..., H, 2*W2-1).

    The right half is the input with its rows rolled by H//2, so DC lands
    on the centre row; the left half is the right half's 180-degree
    rotation without its last column (a real signal's spectrum magnitude
    is symmetric about DC).  As in the JAX package, the reference's output
    layout is not reproduced: it writes the ``2*W2-1``-wide image with the
    input's width as its row stride, which scrambles it.  For odd H and an
    odd full width this is ``np.fft.fftshift`` of the full spectrum; for
    even sizes the left half is one row off, as a rotation implies."""
    right = torch.roll(half_mag, half_mag.shape[-2] // 2, dims=-2)
    left = right.flip(-2, -1)[..., :-1]
    return torch.cat([left, right], dim=-1)
