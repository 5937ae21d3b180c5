"""Row-sharded single-image report: the rows of one image over the ranks of
the spatial process group (counterpart of
``photohive_dsp_tpu/parallel/spatial.py``).

Every stage runs on the rank's own rows, with the JAX package's
communication pattern on ``torch.distributed`` collectives:

  * statistics: local float64 sums -> all_reduce;
  * colour palette: K9 histogram of the rank's decimated pixels (padded
    rows carry the hue sentinel -1) -> all_reduce -> replicated saliency,
    K2 and parent selection -> K10 palette sums -> all_reduce ->
    ``palette_finalize_by_k``;
  * crop sharpness: the neighbours' edge rows (all_gather) as K5's halo, K5
    on the rank's rows at its row offset -> all_reduce of (s1, s2) -> the
    single-device finish; boxes under TINY_BOX_PX keep the masked two-pass
    form (mean from the reduced s1, then the squared deviations of the
    masked crop, plain PyTorch, all_reduce);
  * blur profile: local row rfft, all_to_all to column shards, column fft
    (library FFTs: the JAX package runs these in XLA), the K7+K8 kernel
    against the rank's bin ids -> all_reduce of the sums, all_reduce MAX of
    the peak -> the gain and the means.

The histogram, palette and polar sums are reduced as the kernels' int64
fixed-point accumulators and converted once after the all_reduce, so they
equal the single-device sums bit for bit at any number of ranks; mean
saturation comes from K9's accumulator the same way.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ReportConfig
from ..models.pipeline import ReportData
from ..ops import palette_kernels as pk
from ..ops.blur import bin_means, vectorize_blur_profile
from ..ops.colorspace import (downsample_rgb, rgb_to_hsv, rgb_to_pgm,
                              u8_to_unit_f32)
from ..ops.fixed_point import from_fixed
from ..ops.geometry import polar_geometry
from ..ops.margin_sort import margin_sort
from ..ops.polar_kernels import lognorm_gain, polar_bin_sums_lognorm
from ..ops.quantize import (OctreeTables, palette_finalize_by_k,
                            palette_kernel_variant, palette_sums_by_k_auto,
                            parent_assignment_from_order, saliency_f32)
from ..ops.sharpness import finish_sharpness, thin_boxes
from ..ops.sharpness_kernels import box_crops, box_tensor, sharpness_sums
from ..ops.stats import div_const

SUM = dist.ReduceOp.SUM


class ShardedPolarTables(NamedTuple):
    """Per-rank polar bin ids in each rank's local spectrum layout."""

    flat_ids: np.ndarray   # (n_shards, H * wc) int32, sentinel A*R on the
    #                        padded columns past the true spectrum
    counts: np.ndarray     # (A*R,) int32 global bin counts
    wc: int                # spectrum columns per rank after the all_to_all

    @classmethod
    def from_numpy(cls, tables) -> "ShardedPolarTables":
        """From any tables with these fields, e.g. the JAX package's
        ``ShardedPolarTables`` (its gather tables are not used here)."""
        return cls(flat_ids=np.asarray(tables.flat_ids, np.int32),
                   counts=np.asarray(tables.counts, np.int32),
                   wc=int(tables.wc))


@functools.lru_cache(maxsize=16)
def sharded_polar_tables(height: int, width: int, num_angle_bins: int,
                         num_radius_bins: int, n_shards: int)\
        -> ShardedPolarTables:
    """The bin id of every spectrum pixel a rank holds after the
    all_to_all: rank k holds columns [k*wc, (k+1)*wc) of the half spectrum
    padded to wc*n_shards columns, all rows, row-major."""
    geom = polar_geometry(height, width, num_angle_bins, num_radius_bins)
    wf = geom.fft_width
    wc = -(-wf // n_shards)
    num_bins = num_angle_bins * num_radius_bins
    bin_2d = geom.bin_ids.reshape(height, wf)
    ids = np.full((n_shards, height, wc), num_bins, dtype=np.int32)
    for k in range(n_shards):
        c0, c1 = k * wc, min((k + 1) * wc, wf)
        if c1 > c0:
            ids[k, :, :c1 - c0] = bin_2d[:, c0:c1]
    return ShardedPolarTables(flat_ids=ids.reshape(n_shards, -1),
                              counts=geom.bin_counts.astype(np.int32), wc=wc)


def own_rows(x: torch.Tensor, rank: int, rows: int,
             device: torch.device) -> torch.Tensor:
    """(3, H, W) whole image, uint8 or float32 in [0, 1] -> (3, rows, W)
    float32 on ``device``: rows rank*rows onwards, zero rows past H."""
    part = x[:, rank * rows:(rank + 1) * rows].to(device)
    part = u8_to_unit_f32(part) if part.dtype == torch.uint8 else part.float()
    pad = rows - part.shape[1]
    if pad:
        part = torch.cat([part, part.new_zeros((3, pad, x.shape[2]))], dim=1)
    return part.contiguous()


def rgb_stats(rgb_local: torch.Tensor, row_offset: int, height: int,
              width: int, group) -> torch.Tensor:
    """(6,) float32 means and standard deviations of R, G, B over the whole
    image, two-pass like the reference's reducers; padded rows are zero, so
    the means need no mask and the deviations do."""
    total = height * width
    local_h = rgb_local.shape[1]
    sums = rgb_local.sum(dim=(1, 2), dtype=torch.float64)
    dist.all_reduce(sums, SUM, group=group)
    means = (sums / total).float()
    real_rows = (row_offset
                 + torch.arange(local_h, device=rgb_local.device)) < height
    dev2 = (torch.square(rgb_local - means[:, None, None])
            * real_rows[:, None]).sum(dim=(1, 2), dtype=torch.float64)
    dist.all_reduce(dev2, SUM, group=group)
    return torch.cat([means, torch.sqrt(dev2 / total).float()])


def masked_hsv(down_local: torch.Tensor, rank: int, d_h: int) -> list:
    """(3, d_lh, W') decimated rows -> [h, s, v], each (1, d_lh * W')
    float32, the hue -1 (K9's and K10's sentinel) on the padded rows past
    the decimated height d_h."""
    d_local_h = down_local.shape[1]
    h, s, v = rgb_to_hsv(down_local[0], down_local[1], down_local[2])
    real = (rank * d_local_h
            + torch.arange(d_local_h, device=down_local.device)) < d_h
    return [torch.where(real[:, None], h, -1.0).reshape(1, -1),
            s.reshape(1, -1), v.reshape(1, -1)]


def halo_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(lh, W) -> (2, W): the row just above the rank's rows and the row
    just below, from the neighbouring ranks; zeros at the image's edges,
    the reference's zero padding (src/filtering.c:96)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    edges = torch.stack([x[0], x[-1]])
    gathered = [torch.empty_like(edges) for _ in range(n)]
    dist.all_gather(gathered, edges, group=group)
    zero = torch.zeros_like(x[0])
    return torch.stack([gathered[rank - 1][1] if rank > 0 else zero,
                        gathered[rank + 1][0] if rank < n - 1 else zero])


def _sharded_sharpness(pgm_local: torch.Tensor, boxes: np.ndarray,
                       boxes_valid: np.ndarray, row_offset: int,
                       group) -> torch.Tensor:
    """(lh, W) rows at ``row_offset`` -> (10,) sharpness of the whole
    image's boxes, the same on every rank.  The route is picked from the
    boxes, which every rank holds, so all ranks take the same
    collectives."""
    dev = pgm_local.device
    if not boxes_valid.any():
        return torch.zeros(boxes_valid.shape, dtype=torch.float32, device=dev)
    halo = halo_rows(pgm_local, group)[None].contiguous()
    pgm = pgm_local[None].contiguous()
    bt = box_tensor(boxes[None], boxes_valid[None], dev)
    s1, s2 = sharpness_sums(pgm, bt, halo, row_offset)
    sums = torch.stack([s1, s2], dim=-1)
    dist.all_reduce(sums, SUM, group=group)
    s1, s2 = sums[..., 0], sums[..., 1]
    if not thin_boxes(boxes, boxes_valid).any():
        return finish_sharpness(s1, s2, boxes[None], boxes_valid[None])[0]
    # Masked two-pass: sum((resp - mean)^2) over each masked crop.
    area = torch.as_tensor((boxes[:, 1] - boxes[:, 0])
                           * (boxes[:, 3] - boxes[:, 2]), device=dev)
    n = torch.clamp(area, min=1).float()
    mean = s1[0].float() / n
    dev2 = torch.zeros(boxes_valid.shape, dtype=torch.float64, device=dev)
    for _, k, _, resp, _ in box_crops(pgm, bt, halo, row_offset):
        dev2[k] = torch.square(resp - mean[k]).double().sum()
    dist.all_reduce(dev2, SUM, group=group)
    var = dev2.float() / n
    return torch.where(torch.as_tensor(boxes_valid, device=dev), var / mean,
                       torch.zeros_like(mean))


def power_spectrum(pgm_local: torch.Tensor, dc: torch.Tensor, wc: int,
                   height: int, width: int, group) -> torch.Tensor:
    """Distributed 2-D rFFT of the DC-removed luma -> (1, H * wc) float32
    |X|^2 of the rank's wc spectrum columns, all rows, row-major (the
    layout of sharded_polar_tables' flat_ids)."""
    n = dist.get_world_size(group)
    lh = pgm_local.shape[0]
    wf = width // 2 + 1
    spec = torch.fft.rfft(pgm_local - dc, dim=1)               # (lh, wf)
    spec = torch.cat([spec, spec.new_zeros((lh, wc * n - wf))], dim=1)
    # Row shards -> column shards: chunk j of my columns goes to rank j.
    send = torch.view_as_real(spec).reshape(lh, n, wc, 2).transpose(0, 1)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # Row r of the stacked chunks is image row r; the padded rows go.
    cols = torch.view_as_complex(recv.reshape(n * lh, wc, 2))[:height]
    col_spec = torch.fft.fft(cols, dim=0)
    mag2 = torch.square(col_spec.real) + torch.square(col_spec.imag)
    return mag2.reshape(1, -1)


def _sharded_blur_bins(pgm_local: torch.Tensor, dc: torch.Tensor,
                       flat_ids: torch.Tensor, bin_counts: torch.Tensor,
                       wc: int, height: int, width: int, cfg: ReportConfig,
                       group) -> torch.Tensor:
    """Distributed 2-D rFFT of the DC-removed luma -> (A, R) normalised
    bin means, the same on every rank."""
    mag2 = power_spectrum(pgm_local, dc, wc, height, width, group)
    a, r = cfg.angle_partitions, cfg.radius_partitions
    # The kernel's pass gives the rank's maximum beside its sums.
    acc, mx = polar_bin_sums_lognorm(mag2, flat_ids, a * r, fixed=True)
    dist.all_reduce(mx, dist.ReduceOp.MAX, group=group)
    dist.all_reduce(acc, SUM, group=group)
    return bin_means(from_fixed(acc) * lognorm_gain(mx)[:, None],
                     bin_counts, a, r)[0]


def spatial_report_body(rgb_local: torch.Tensor, down_local: torch.Tensor,
                        boxes, boxes_valid, flat_ids: torch.Tensor,
                        bin_counts: torch.Tensor, octree: OctreeTables,
                        wc: int, height: int, width: int, cfg: ReportConfig,
                        group, variant: str) -> ReportData:
    """One rank's part of the report of one row-sharded image.

    rgb_local:  (3, lh, W) float32 full-resolution rows (statistics,
                sharpness, blur), rows rank*lh onwards, zero rows past the
                image's height.
    down_local: (3, d_lh, W') float32 rows of the decimated image (palette,
                mean saturation); the same as rgb_local at
                downsample_rate 1.
    boxes, boxes_valid: the whole image's (10, 4) / (10,) host arrays.
    flat_ids:   (H * wc,) int32 this rank's bin ids (sharded_polar_tables).
    variant:    the palette variant (quantize.palette_kernel_variant):
                K14 for the pixel pass under ``cwide``, else K10.

    Returns the whole image's report, unbatched, the same on every rank."""
    rank = dist.get_rank(group)
    boxes = np.asarray(boxes, np.int64)
    boxes_valid = np.asarray(boxes_valid, bool)
    rate = cfg.downsample_rate
    d_h = height // rate if rate > 1 else height
    d_total = d_h * (width // rate if rate > 1 else width)
    row_offset = rank * rgb_local.shape[1]
    stats = rgb_stats(rgb_local, row_offset, height, width, group)

    # Palette: K9 -> replicated selection -> K10 (K14 under cwide), on the
    # fixed point.
    hsv = masked_hsv(down_local, rank, d_h)
    acc = pk.cell_counts_from_hsv(*hsv, cfg)
    dist.all_reduce(acc, SUM, group=group)
    counts, s_sum = pk.counts_s_from_fixed(acc)
    s_bar = div_const(s_sum, d_total)[0]
    order = margin_sort(saliency_f32(counts, octree.s_v_f32, cfg))
    assign = parent_assignment_from_order(counts, order, d_total, cfg,
                                          octree)
    acc = palette_sums_by_k_auto(*hsv, assign, counts, cfg, octree, variant)
    dist.all_reduce(acc, SUM, group=group)
    palette = palette_finalize_by_k(pk.palette_sums_from_fixed(acc), assign,
                                    d_total, octree)

    pgm = rgb_to_pgm(rgb_local[0], rgb_local[1], rgb_local[2])
    sharp = _sharded_sharpness(pgm, boxes, boxes_valid, row_offset, group)

    dc = (stats[0] + stats[1] + stats[2]) / 3.0
    bins = _sharded_blur_bins(pgm, dc, flat_ids, bin_counts, wc, height,
                              width, cfg, group)
    angles, mags = vectorize_blur_profile(bins[None], cfg)
    return ReportData(
        rgb_stats=stats, average_saturation=s_bar,
        palette_hsv=palette.hsv[0], palette_pct=palette.percentages[0],
        palette_n=palette.n_valid[0], palette_ids=palette.parent_ids[0],
        sharpness=sharp, blur_bins=bins,
        blur_vector_angles=angles[0], blur_vector_mags=mags[0])


def build_spatial_report(group, height: int, width: int, cfg: ReportConfig,
                         device="cuda"):
    """The row-sharded report over the ranks of ``group``
    (mesh.init_spatial_group); each rank computes on ``device``.

    Returns fn(rgb, boxes, valid) -> ReportData (unbatched, the same on
    every rank).  Every rank calls fn with the whole image, (3, H, W) uint8
    or float32 in [0, 1] (numpy, or a tensor on any device), and moves only
    its own rows to ``device``.  The decimation runs on the whole image
    before sharding: its stride-(rate-1) row pick is not aligned with
    row shards.  Heights that the rank count does not divide are padded
    with zero rows, which every stage masks.  The palette variant
    (``PHOTOHIVE_PALETTE_KERNEL``) is read at each call."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rate = cfg.downsample_rate
    d_h = height // rate if rate > 1 else height
    local_h, d_local_h = -(-height // n), -(-d_h // n)
    tabs = sharded_polar_tables(height, width, cfg.angle_partitions,
                                cfg.radius_partitions, n)
    flat_ids = torch.as_tensor(tabs.flat_ids[rank], device=dev)
    bin_counts = torch.as_tensor(tabs.counts, device=dev)
    octree = OctreeTables.for_config(cfg, dev)

    def run(rgb, boxes, valid) -> ReportData:
        rgb = torch.as_tensor(rgb)
        if tuple(rgb.shape) != (3, height, width):
            raise ValueError(f"rgb: expected {(3, height, width)}, got "
                             f"{tuple(rgb.shape)}")
        rgb_local = own_rows(rgb, rank, local_h, dev)
        down_local = rgb_local if rate == 1 else \
            own_rows(downsample_rgb(rgb, rate), rank, d_local_h, dev)
        return spatial_report_body(rgb_local, down_local, boxes, valid,
                                   flat_ids, bin_counts, octree, tabs.wc,
                                   height, width, cfg, group,
                                   palette_kernel_variant())

    return run
