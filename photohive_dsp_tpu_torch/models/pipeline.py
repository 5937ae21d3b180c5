"""The batched full-report pipeline (counterpart of
``photohive_dsp_tpu/models/pipeline.py``).

Mirrors the reference orchestrator get_full_report_data
(src/interface.c:20-94) stage for stage:

  downsample -> palette + mean saturation (downsampled; K1-K4, K11-K13
  or, under PHOTOHIVE_PALETTE_KERNEL=cwide, flat HSV with K9/K14)
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

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import MAX_CROP_BOXES, ReportConfig
from ..ops.blur import (PolarTables, blur_bins_lognorm, blur_profile_bins,
                        vectorize_blur_profile)
from ..ops.colorspace import (downsample_rgb, rgb_to_hsv, rgb_to_pgm,
                               u8_to_unit_f32)
from ..ops.fft import magnitude_fft_normalized
from ..ops.fft_plan import FftPlan, fft_kernel_eligible
from ..ops.quantize import (OctreeTables, color_palette_batched,
                             color_palette_batched_from_rgb,
                             palette_kernel_variant)
from ..ops.sharpness import variance_sharpness_batched
from ..ops.stats import blur_dc, div_const, mean_saturation, \
    rgb_statistics
from ..utils.profiling import span


class ReportData(NamedTuple):
    """Fixed-shape reports with a leading batch dimension (one image's
    report, as ``full_report`` returns it, has none)."""

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


def resolve_device(device) -> torch.device:
    """The torch device to compute on; raises if CUDA is asked for and is
    not there (no silent fallback to the CPU).  A bare "cuda" becomes the
    current card, so caches keyed on the device see one name for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=16)
def cached_tables(height: int, width: int, cfg: ReportConfig,
                  device: torch.device) -> ReportTables:
    """ReportTables per (shape, config, device), built once."""
    return ReportTables.build(height, width, cfg, device)


def full_report_batched(rgb: torch.Tensor, boxes, boxes_valid,
                        tables: ReportTables,
                        cfg: ReportConfig) -> ReportData:
    """Reports for a batch of same-shape images.

    rgb:         (B, 3, H, W) float32 in [0, 1], or uint8, on the device
                 the tables live on.
    boxes:       (B, MAX_CROP_BOXES, 4) int [top, bottom, left, right),
                 a host array or a CPU tensor.
    boxes_valid: (B, MAX_CROP_BOXES) bool, a host array or a CPU tensor.

    The shape and the palette variant (``quantize.palette_kernel_variant``,
    read once here) pick routes in Python; the palette tier and the
    sharpness route are graph conditionals (``ops.library.branch``), whose
    predicates come from the boxes on the host and, once per batch on the
    RGB palette routes, from one scalar of the palette's tie structure
    copied from the device.  So ``torch.export`` traces the whole function
    (``serving.export_report``)."""
    with span("photohive.pipeline"):
        variant = palette_kernel_variant()
        # On the bf16 route uint8 frames feed the palette kernels directly
        # when no decimation is configured (in-kernel x/255, bit-identical
        # to the float planes); the candidate and cwide routes take the
        # float planes.
        with span("photohive.stage.decode"):
            pal_in = rgb
            if rgb.dtype == torch.uint8:
                rgb = u8_to_unit_f32(rgb)
            if variant != "bf16" or pal_in.dtype != torch.uint8 \
                    or cfg.downsample_rate != 1:
                pal_in = downsample_rgb(rgb, cfg.downsample_rate)
        with span("photohive.stage.palette"):
            if variant == "cwide":
                # Flat HSV planes (12 B a pixel), K9 and K14.
                h, s, v = rgb_to_hsv(pal_in[:, 0], pal_in[:, 1], pal_in[:, 2])
                s_bar = mean_saturation(s)
                palette = color_palette_batched(h, s, v, cfg, tables.octree,
                                                variant)
            else:
                pal_in = pal_in.contiguous()
                palette, s_sum = color_palette_batched_from_rgb(
                    pal_in, cfg, tables.octree)
                s_bar = div_const(s_sum, pal_in.shape[2] * pal_in.shape[3])

        with span("photohive.stage.stats"):
            pgm = rgb_to_pgm(rgb[:, 0], rgb[:, 1], rgb[:, 2])
            stats = rgb_statistics(rgb)
        with span("photohive.stage.sharpness"):
            sharp = variance_sharpness_batched(pgm, boxes, boxes_valid)

        with span("photohive.stage.blur"):
            dc = blur_dc(stats)
            pgm_dc = pgm - dc[:, None, None]
            h, w = pgm_dc.shape[1:]
            if fft_kernel_eligible(h, w):
                plan = FftPlan.for_shape(h, w, pgm_dc.device)
                bins = blur_bins_lognorm(pgm_dc, plan, tables.polar,
                                         cfg.angle_partitions,
                                         cfg.radius_partitions)
            else:
                bins = blur_profile_bins(magnitude_fft_normalized(pgm_dc),
                                         tables.polar, cfg.angle_partitions,
                                         cfg.radius_partitions)
        with span("photohive.stage.vectors"):
            angles, mags = vectorize_blur_profile(bins, cfg)

        return ReportData(
            rgb_stats=stats, average_saturation=s_bar,
            palette_hsv=palette.hsv, palette_pct=palette.percentages,
            palette_n=palette.n_valid, palette_ids=palette.parent_ids,
            sharpness=sharp, blur_bins=bins,
            blur_vector_angles=angles, blur_vector_mags=mags)


def full_report(rgb: torch.Tensor, boxes, boxes_valid, tables: ReportTables,
                cfg: ReportConfig) -> ReportData:
    """The report of one image: full_report_batched at B=1, each field
    without its batch dimension.

    rgb:         (3, H, W) float32 in [0, 1] (or uint8), on the device the
                 tables live on.
    boxes:       (MAX_CROP_BOXES, 4) int [top, bottom, left, right), a host
                 array or a CPU tensor.
    boxes_valid: (MAX_CROP_BOXES,) bool, a host array or a CPU tensor."""
    data = full_report_batched(rgb[None], torch.as_tensor(boxes)[None],
                               torch.as_tensor(boxes_valid)[None], tables,
                               cfg)
    return ReportData(*(x[0] for x in data))


def jitted_full_report(height: int, width: int, cfg: ReportConfig,
                       device="cuda"):
    """(fn, tables) for one image shape and config on ``device``: fn is
    ``full_report`` with cfg bound, called as fn(rgb, boxes, boxes_valid,
    tables).  Named after the JAX package's compiled counterpart; nothing
    is compiled here (the kernels build at their first launch).  Cached
    per resolved device, so a second call returns the same objects."""
    return _report_fn(height, width, cfg, resolve_device(device))


@functools.lru_cache(maxsize=16)
def _report_fn(height: int, width: int, cfg: ReportConfig,
               device: torch.device):
    return (functools.partial(full_report, cfg=cfg),
            cached_tables(height, width, cfg, device))


def empty_boxes() -> Tuple[torch.Tensor, torch.Tensor]:
    """No crop boxes: (MAX_CROP_BOXES, 4) int32 and (MAX_CROP_BOXES,) bool
    zeros, CPU tensors."""
    return (torch.zeros((MAX_CROP_BOXES, 4), dtype=torch.int32),
            torch.zeros((MAX_CROP_BOXES,), dtype=torch.bool))
