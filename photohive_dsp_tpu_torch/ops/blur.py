"""Polar blur profile and directional blur-vector extraction (counterpart of
``photohive_dsp_tpu/ops/blur.py``).

reference: src/blur_profile.c
  * calculate_blur_profile (:34-126): per-FFT-pixel (angle, radius) binning,
    then per-bin mean.
  * vectorize_blur_profile (:324-416): per-angle low-band totals, trailing
    circular 5-tap smoothing, local-maxima streak detection, and conversion
    to <=10 (angle, magnitude) blur vectors.

The bin of every FFT pixel depends only on the image shape (ops/geometry.py).
Two routes give the report's bins, both the same from run to run, and both
end in the polar kernel (K7+K8): the log-gated bin sums (exact fixed
point) and the per-image max in one pass, the gain and the means in its
finish, over the int32 ``bin_ids`` in the natural half-spectrum layout:

  * ``blur_bins_lognorm`` (shapes inside fft_plan.fft_kernel_eligible):
    the FFT kernels (K6a, K6b) write |X|^2; the counterpart of
    ``pallas_fft.blur_bins_scrambled_lognorm``.
  * the operator ``photohive::spectrum_bins`` (ops/library.py; all other
    shapes): ``torch.fft.rfft2`` writes it.

The normalised spectrum never exists.  ``blur_profile_bins`` is the JAX
package's gather route (a static gather of the normalised spectrum,
ops/fft.py, into per-bin padded rows, and a row sum), off the report
path: its padded table ``pad_index`` is built only on request
(``PolarTables.for_shape(..., gather=True)``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import NUM_BLUR_VECTORS, ReportConfig
from .fft_kernels import magnitude2
from .fft_plan import FftPlan
from .filtering import trailing_circular_box
from .geometry import polar_geometry
from .polar_kernels import mean_per_bin, polar_bin_means_lognorm
from .stats import div_const


class PolarTables(NamedTuple):
    """Polar binning constants for one image shape (geometry.PolarGeometry)."""

    # (A*R, Lmax) int64 spectrum index, sentinel P: blur_profile_bins'
    # gather table, None where nothing gathers.
    pad_index: Optional[torch.Tensor]
    bin_counts: torch.Tensor  # (A*R,) int32
    # (H * fft_width,) int32, natural row-major order: the layout the FFT
    # kernels write, so it is also the polar kernel's table.
    bin_ids: torch.Tensor

    @classmethod
    def for_shape(cls, height: int, width: int, cfg: ReportConfig,
                  device="cpu", gather: bool = False) -> "PolarTables":
        """The tables of one shape; ``gather`` adds ``pad_index``."""
        geom = polar_geometry(height, width, cfg.angle_partitions,
                              cfg.radius_partitions)
        return cls.from_numpy(geom.pad_index if gather else None,
                              geom.bin_counts, geom.bin_ids, device)

    @classmethod
    def from_numpy(cls, pad_index, bin_counts, bin_ids,
                   device="cpu") -> "PolarTables":
        return cls(
            pad_index=None if pad_index is None else torch.tensor(
                np.asarray(pad_index, np.int64), device=device),
            bin_counts=torch.tensor(np.asarray(bin_counts, np.int32),
                                    device=device),
            bin_ids=torch.tensor(np.asarray(bin_ids, np.int32),
                                 device=device))


def blur_profile_bins(mag_norm: torch.Tensor, tables: PolarTables,
                      num_angle_bins: int, num_radius_bins: int)\
        -> torch.Tensor:
    """Mean normalized FFT magnitude per (angle, radius) bin.

    mag_norm: (B, H, W//2+1); ``tables`` with ``pad_index``.  Returns (B,
    A, R) float32; empty bins are 0 (reference
    src/blur_profile.c:106-116)."""
    b = mag_norm.shape[0]
    flat = torch.cat([mag_norm.reshape(b, -1),
                      mag_norm.new_zeros((b, 1))], dim=1)
    sums = flat[:, tables.pad_index].sum(dim=-1)       # (B, A*R)
    return bin_means(sums, tables.bin_counts, num_angle_bins,
                     num_radius_bins)


def bin_means(sums: torch.Tensor, bin_counts: torch.Tensor,
              num_angle_bins: int, num_radius_bins: int) -> torch.Tensor:
    """(B, A*R) bin sums and (A*R,) pixel counts -> (B, A, R) means; empty
    bins are 0."""
    return mean_per_bin(sums, bin_counts).reshape(
        sums.shape[0], num_angle_bins, num_radius_bins)


def blur_bins_lognorm(pgm_dc: torch.Tensor, plan: FftPlan,
                      tables: PolarTables, num_angle_bins: int,
                      num_radius_bins: int) -> torch.Tensor:
    """Mean normalised FFT magnitude per (angle, radius) bin, (B, A, R)
    float32, from the DC-removed luma (B, H, W), by the FFT and polar
    kernels (``pallas_fft.blur_bins_scrambled_lognorm``).

    The reference's x < 1 -> 0 else log(x) * G_s is summed as log(x) per
    bin and the per-image gain G_s = 1 / (2 log(sqrt(max) + 1)) multiplies
    the sums: a scalar through a linear sum.  A zero spectrum (black or
    uniform frame) has max 0 and gain 0, so its bins are 0, not NaN."""
    mag2 = magnitude2(pgm_dc, plan)
    return lognorm_bin_means(mag2.reshape(mag2.shape[0], -1), tables,
                             num_angle_bins, num_radius_bins)


def lognorm_bin_means(mag2: torch.Tensor, tables: PolarTables,
                      num_angle_bins: int, num_radius_bins: int)\
        -> torch.Tensor:
    """The half of ``blur_bins_lognorm`` after the FFT: (B, P) |X|^2 in the
    FFT kernels' layout -> (B, A, R) normalised bin means (one launch of
    the polar kernel: sums, max, gain and means)."""
    means = polar_bin_means_lognorm(mag2, tables.bin_ids, tables.bin_counts)
    return means.reshape(mag2.shape[0], num_angle_bins, num_radius_bins)


def _angle_table(a: int) -> np.ndarray:
    """Blur-vector angle per rolled angle bin, in float32 as the C code
    rounds it without FMA contraction: (int)(180 * ((float)idx / (float)A)
    - 90), e.g. idx=50, A=72 gives 34 (reference src/blur_profile.c:413)."""
    angle_idx = (np.arange(a) + a // 2) % a
    return np.trunc(
        np.float32(180) * (angle_idx.astype(np.float32) / np.float32(a))
        - np.float32(90)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _angle_table_on(a: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_angle_table(a), device=device)


def angle_table(a: int, device: torch.device) -> torch.Tensor:
    """``_angle_table(a)`` on ``device``, copied there once per (A,
    device), so that a report makes no copy for it (and a CUDA graph can
    hold it).  Made afresh while torch.export or torch.compile traces: a
    cached tensor would be the tracer's."""
    if torch.compiler.is_compiling():
        return torch.as_tensor(_angle_table(a), device=device)
    return _angle_table_on(a, device)


def vectorize_blur_profile(bins: torch.Tensor, cfg: ReportConfig):
    """Extract <=10 blur vectors per image (reference
    src/blur_profile.c:324-416).

    bins: (B, A, R).  Returns (angles int32 (B, 10), magnitudes f32 (B, 10));
    unused slots are zero like the reference's calloc'd 10-slot group."""
    a = cfg.angle_partitions
    r = cfg.radius_partitions
    radius_cutoff = r // cfg.blur_cutoff_ratio_denom
    dev = bins.device

    tot = bins[..., :radius_cutoff].sum(dim=-1)             # (B, A)
    avg = div_const(tot.sum(dim=-1, keepdim=True), a)       # (B, 1)
    smooth = trailing_circular_box(tot, 5)

    # Local maxima with circular neighbours (reference :360-379).
    left = torch.roll(smooth, 1, dims=-1)
    right = torch.roll(smooth, -1, dims=-1)
    is_max = (smooth > left) & (smooth > right) \
        & (smooth > avg * cfg.fft_streak_thresh)
    # The first 10 maxima in ascending angle order fill the 10 slots.
    rank = torch.cumsum(is_max.to(torch.int32), dim=-1) - 1
    keep = is_max & (rank < NUM_BLUR_VECTORS)

    # Re-indexed angle (:387): cur[i] = bins[(i + A//2) % A]; vetted
    # against the global average (:392-400).
    cur = torch.roll(bins, -(a // 2), dims=-2)              # (B, A, R)
    blur_avg = cur[..., :radius_cutoff].sum(dim=-1)
    suppressed = blur_avg > avg

    # Magnitude: first radius bin below the magnitude threshold (:403-412).
    below = cur < cfg.magnitude_thresh
    first_below = torch.where(below.any(dim=-1),
                              below.to(torch.int32).argmax(dim=-1),
                              torch.full_like(rank, r, dtype=torch.int64))
    magnitude = div_const(first_below.to(bins.dtype), r)

    table = angle_table(a, dev)
    live = keep & ~suppressed
    angles_a = torch.where(live, table, torch.zeros_like(table))
    mags_a = torch.where(live, magnitude, torch.zeros_like(magnitude))

    # Slot k <- the maximum whose rank is k.
    slots = torch.arange(NUM_BLUR_VECTORS, device=dev)[:, None]
    sel = (rank[:, None, :] == slots) & keep[:, None, :]    # (B, 10, A)
    angles = torch.where(sel, angles_a[:, None, :], 0).sum(
        dim=-1, dtype=torch.int32)
    mags = torch.where(sel, mags_a[:, None, :], 0.0).sum(dim=-1)
    return angles, mags
