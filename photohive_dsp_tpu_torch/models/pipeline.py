"""The batched full-report pipeline (counterpart of
``photohive_dsp_tpu/models/pipeline.py``).

Mirrors the reference orchestrator get_full_report_data
(src/interface.c:20-94) stage for stage:

  downsample -> palette + mean saturation (downsampled, K1-K4)
  -> rgb2pgm and rgb statistics (full res) -> crop sharpness (pre-DC
  removal) -> DC removal with the RGB brightness mean -> blur bins (FFT
  kernels K6a/K6b + log-gated polar kernel K7+K8 on shapes inside
  fft_plan.fft_kernel_eligible, else torch rfft2 + normalisation + gather)
  -> blur vectors.

Behavioural subtleties honoured (SURVEY.md §3.1): palette and saturation
run on the *downsampled* image, the rest on the full-resolution original;
sharpness comes before DC removal; the DC removed is (Br+Bg+Bb)/3.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ReportConfig
from ..ops.blur import (PolarTables, blur_bins_lognorm, blur_profile_bins,
                        vectorize_blur_profile)
from ..ops.colorspace import downsample_rgb, rgb_to_pgm, u8_to_unit_f32
from ..ops.fft import magnitude_fft_normalized
from ..ops.fft_plan import FftPlan, fft_kernel_eligible
from ..ops.quantize import OctreeTables, color_palette_batched_from_rgb
from ..ops.sharpness import variance_sharpness_batched
from ..ops.stats import div_const, rgb_statistics


class ReportData(NamedTuple):
    """Fixed-shape reports with a leading batch dimension."""

    rgb_stats: torch.Tensor           # (B, 6) [Br, Bg, Bb, Cr, Cg, Cb]
    average_saturation: torch.Tensor  # (B,)
    palette_hsv: torch.Tensor         # (B, C, 3) valid-order HSV averages
    palette_pct: torch.Tensor         # (B, C)
    palette_n: torch.Tensor           # (B,) int32
    palette_ids: torch.Tensor         # (B, C) int32 backing cell ids (-1 pad)
    sharpness: torch.Tensor           # (B, MAX_CROP_BOXES)
    blur_bins: torch.Tensor           # (B, A, R)
    blur_vector_angles: torch.Tensor  # (B, NUM_BLUR_VECTORS) int32 degrees
    blur_vector_mags: torch.Tensor    # (B, NUM_BLUR_VECTORS)


class ReportTables(NamedTuple):
    """The system's state: the shape- and config-static host tables."""

    polar: PolarTables
    octree: OctreeTables

    @classmethod
    def build(cls, height: int, width: int, cfg: ReportConfig,
              device="cpu") -> "ReportTables":
        return cls(polar=PolarTables.for_shape(height, width, cfg, device),
                   octree=OctreeTables.for_config(cfg, device))

    @classmethod
    def from_numpy(cls, tables, device="cpu") -> "ReportTables":
        """Build from any tables with the JAX package's layout, e.g. its
        ``ReportTables`` (``tables.octree.{centers, s_v_f32, dist_ranks}``,
        ``tables.polar.{pad_index, bin_counts, bin_ids}``), each leaf taken
        as a numpy array."""
        oc, po = tables.octree, tables.polar
        return cls(
            polar=PolarTables.from_numpy(np.asarray(po.pad_index),
                                         np.asarray(po.bin_counts),
                                         np.asarray(po.bin_ids), device),
            octree=OctreeTables.from_numpy(np.asarray(oc.centers),
                                           np.asarray(oc.s_v_f32),
                                           np.asarray(oc.dist_ranks), device))


def full_report_batched(rgb: torch.Tensor, boxes, boxes_valid,
                        tables: ReportTables,
                        cfg: ReportConfig) -> ReportData:
    """Reports for a batch of same-shape images.

    rgb:         (B, 3, H, W) float32 in [0, 1], or uint8, on the device
                 the tables live on.
    boxes:       (B, MAX_CROP_BOXES, 4) int [top, bottom, left, right),
                 a host array.
    boxes_valid: (B, MAX_CROP_BOXES) bool, a host array.

    The routes are picked on the host from the shape, the boxes and, once
    per batch,
    from one scalar of the palette's tie structure read from the device."""
    # uint8 frames feed the palette kernels directly when no decimation is
    # configured (in-kernel x/255, bit-identical to the float planes).
    pal_in = rgb
    if rgb.dtype == torch.uint8:
        rgb = u8_to_unit_f32(rgb)
    if pal_in.dtype != torch.uint8 or cfg.downsample_rate != 1:
        pal_in = downsample_rgb(rgb, cfg.downsample_rate)
    pal_in = pal_in.contiguous()
    palette, s_sum = color_palette_batched_from_rgb(pal_in, cfg,
                                                    tables.octree)
    s_bar = div_const(s_sum, pal_in.shape[2] * pal_in.shape[3])

    pgm = rgb_to_pgm(rgb[:, 0], rgb[:, 1], rgb[:, 2])
    stats = rgb_statistics(rgb)
    sharp = variance_sharpness_batched(pgm, boxes, boxes_valid)

    dc = (stats[:, 0] + stats[:, 1] + stats[:, 2]) / 3.0
    pgm_dc = pgm - dc[:, None, None]
    h, w = pgm_dc.shape[1:]
    if fft_kernel_eligible(h, w):
        bins = blur_bins_lognorm(pgm_dc,
                                 FftPlan.for_shape(h, w, pgm_dc.device),
                                 tables.polar, cfg.angle_partitions,
                                 cfg.radius_partitions)
    else:
        bins = blur_profile_bins(magnitude_fft_normalized(pgm_dc),
                                 tables.polar, cfg.angle_partitions,
                                 cfg.radius_partitions)
    angles, mags = vectorize_blur_profile(bins, cfg)

    return ReportData(
        rgb_stats=stats, average_saturation=s_bar,
        palette_hsv=palette.hsv, palette_pct=palette.percentages,
        palette_n=palette.n_valid, palette_ids=palette.parent_ids,
        sharpness=sharp, blur_bins=bins,
        blur_vector_angles=angles, blur_vector_mags=mags)
