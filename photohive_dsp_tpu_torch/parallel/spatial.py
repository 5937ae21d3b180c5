"""Row-sharded report: the rows of one image over the ranks of the spatial
process group, and, in ``build_dp_spatial_report``, a batch over the data
axis besides (counterpart of ``photohive_dsp_tpu/parallel/spatial.py``).

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
saturation comes from K9's accumulator the same way.  The batched step
runs the palette of its whole local batch in one deferred pass
(``DeferredPalette``, ``sharded_palette``): two all_reduces a batch.
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
from ..ops.quantize import (OctreeTables, PaletteResult,
                            palette_finalize_by_k, palette_kernel_variant,
                            palette_sums_by_k_auto,
                            parent_assignment_from_order, saliency_f32)
from ..ops.sharpness import finish_sharpness, thin_boxes
from ..ops.sharpness_kernels import box_crops, box_tensor, sharpness_sums
from ..ops.stats import blur_dc, div_const
from ..utils.profiling import span
from .sharding import gather_reports

SUM = dist.ReduceOp.SUM


def _all_reduce(x: torch.Tensor, op, group) -> None:
    """``dist.all_reduce`` of ``x`` in place over ``group``, in its span."""
    with span("photohive.collective.all_reduce"):
        dist.all_reduce(x, op, group=group)


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
    with span("photohive.h2d"):
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
    _all_reduce(sums, SUM, group)
    means = (sums / total).float()
    real_rows = (row_offset
                 + torch.arange(local_h, device=rgb_local.device)) < height
    dev2 = (torch.square(rgb_local - means[:, None, None])
            * real_rows[:, None]).sum(dim=(1, 2), dtype=torch.float64)
    _all_reduce(dev2, SUM, group)
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
    with span("photohive.collective.all_gather"):
        dist.all_gather(gathered, edges, group=group)
    zero = torch.zeros_like(x[0])
    return torch.stack([gathered[rank - 1][1] if rank > 0 else zero,
                        gathered[rank + 1][0] if rank < n - 1 else zero])


def _sharded_sharpness(pgm_local: torch.Tensor, boxes: np.ndarray,
                       boxes_valid: np.ndarray, row_offset: int, group,
                       any_tiny=None, any_valid=None) -> torch.Tensor:
    """(lh, W) rows at ``row_offset`` -> (10,) sharpness of the whole
    image's boxes, the same on every rank.  The route is picked from the
    boxes, which every rank holds, so all ranks take the same
    collectives: nothing when no box is valid, the masked two-pass route
    when one is thinner than TINY_BOX_PX, else K5's.  ``any_tiny`` and
    ``any_valid`` let a batched caller pick the route for its whole local
    batch, as ``ops/sharpness.variance_sharpness_batched`` does (every
    rank of the group holds the same batch, so the same predicates)."""
    dev = pgm_local.device
    if any_valid is None:
        any_valid = bool(boxes_valid.any())
    if any_tiny is None:
        any_tiny = bool(thin_boxes(boxes, boxes_valid).any())
    if not any_valid:
        return torch.zeros(boxes_valid.shape, dtype=torch.float32, device=dev)
    halo = halo_rows(pgm_local, group)[None].contiguous()
    pgm = pgm_local[None].contiguous()
    host_bt = box_tensor(boxes[None], boxes_valid[None], "cpu")
    bt = host_bt.to(dev)
    s1, s2 = sharpness_sums(pgm, bt, halo, row_offset)
    sums = torch.stack([s1, s2], dim=-1)
    _all_reduce(sums, SUM, group)
    s1, s2 = sums[..., 0], sums[..., 1]
    if not any_tiny:
        return finish_sharpness(s1, s2, boxes[None], boxes_valid[None])[0]
    # Masked two-pass: sum((resp - mean)^2) over each masked crop.
    area = torch.as_tensor((boxes[:, 1] - boxes[:, 0])
                           * (boxes[:, 3] - boxes[:, 2]), device=dev)
    n = torch.clamp(area, min=1).float()
    mean = s1[0].float() / n
    dev2 = torch.zeros(boxes_valid.shape, dtype=torch.float64, device=dev)
    for _, k, _, resp, _ in box_crops(pgm, host_bt, halo, row_offset):
        dev2[k] = torch.square(resp - mean[k]).double().sum()
    _all_reduce(dev2, SUM, group)
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
    with span("photohive.collective.all_to_all"):
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
    _all_reduce(mx, dist.ReduceOp.MAX, group)
    _all_reduce(acc, SUM, group)
    return bin_means(from_fixed(acc) * lognorm_gain(mx)[:, None],
                     bin_counts, a, r)[0]




class DeferredPalette(NamedTuple):
    """The palette inputs of one rank's rows of one image, which a batched
    caller stacks and runs through ``sharded_palette`` in one pass for its
    whole local batch (``build_dp_spatial_report``): one tier read from
    the device and two all_reduces a batch, not two an image, as the JAX
    package defers its pixel pass out of the per-image vmap."""

    h: torch.Tensor   # (1, d_lh * W') hue, -1 on padded rows
    s: torch.Tensor   # (1, d_lh * W')
    v: torch.Tensor   # (1, d_lh * W')


def sharded_palette(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor,
                    d_total: int, cfg: ReportConfig, octree: OctreeTables,
                    group, variant: str):
    """The palette of B row-sharded images from each rank's (B, P_l) flat
    HSV: K9 -> all_reduce of its int64 accumulators -> replicated
    saliencies, K2 and parent selection -> the pixel pass
    (``palette_sums_by_k_auto``: K10 at the tier the batch needs, one
    device read, or K14 under ``cwide``) -> all_reduce ->
    ``palette_finalize_by_k``.  Returns (PaletteResult, (B,) mean
    saturation), the same on every rank; image i's equals its palette
    alone bit for bit (the sums are exact, and a wider tier finds the same
    first-minimum parent)."""
    acc = pk.cell_counts_from_hsv(h, s, v, cfg)
    _all_reduce(acc, SUM, group)
    counts, s_sum = pk.counts_s_from_fixed(acc)
    s_bar = div_const(s_sum, d_total)
    order = margin_sort(saliency_f32(counts, octree.s_v_f32, cfg))
    assign = parent_assignment_from_order(counts, order, d_total, cfg,
                                          octree)
    acc = palette_sums_by_k_auto(h, s, v, assign, counts, cfg, octree,
                                 variant)
    _all_reduce(acc, SUM, group)
    return palette_finalize_by_k(pk.palette_sums_from_fixed(acc), assign,
                                 d_total, octree), s_bar


def spatial_report_body(rgb_local: torch.Tensor, down_local: torch.Tensor,
                        boxes, boxes_valid, flat_ids: torch.Tensor,
                        bin_counts: torch.Tensor, octree: OctreeTables,
                        wc: int, height: int, width: int, cfg: ReportConfig,
                        group, variant: str, any_tiny=None, any_valid=None,
                        defer_palette: bool = False):
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
    any_tiny, any_valid: the sharpness route's predicates for a batched
                caller's whole local batch (``_sharded_sharpness``).

    Returns the whole image's report, unbatched, the same on every rank.
    With ``defer_palette`` the palette is not computed: returns (the
    report with zeros for the palette and mean saturation,
    DeferredPalette), and the caller runs ``sharded_palette``."""
    with span("photohive.pipeline"):
        rank = dist.get_rank(group)
        boxes = np.asarray(boxes, np.int64)
        boxes_valid = np.asarray(boxes_valid, bool)
        rate = cfg.downsample_rate
        d_h = height // rate if rate > 1 else height
        d_total = d_h * (width // rate if rate > 1 else width)
        row_offset = rank * rgb_local.shape[1]
        with span("photohive.stage.stats"):
            stats = rgb_stats(rgb_local, row_offset, height, width, group)
            pgm = rgb_to_pgm(rgb_local[0], rgb_local[1], rgb_local[2])

        with span("photohive.stage.palette"):
            deferred = DeferredPalette(*masked_hsv(down_local, rank, d_h))
            if defer_palette:
                c = cfg.num_cells
                dev = rgb_local.device
                s_bar = torch.zeros((1,), dtype=torch.float32, device=dev)
                palette = PaletteResult(
                    hsv=torch.zeros((1, c, 3), device=dev),
                    percentages=torch.zeros((1, c), device=dev),
                    n_valid=torch.zeros((1,), dtype=torch.int32, device=dev),
                    parent_ids=torch.zeros((1, c), dtype=torch.int32,
                                           device=dev))
            else:
                palette, s_bar = sharded_palette(*deferred, d_total, cfg,
                                                 octree, group, variant)

        with span("photohive.stage.sharpness"):
            sharp = _sharded_sharpness(pgm, boxes, boxes_valid, row_offset,
                                       group, any_tiny, any_valid)

        with span("photohive.stage.blur"):
            dc = blur_dc(stats)
            bins = _sharded_blur_bins(pgm, dc, flat_ids, bin_counts, wc,
                                      height, width, cfg, group)
        with span("photohive.stage.vectors"):
            angles, mags = vectorize_blur_profile(bins[None], cfg)
        data = ReportData(
            rgb_stats=stats, average_saturation=s_bar[0],
            palette_hsv=palette.hsv[0], palette_pct=palette.percentages[0],
            palette_n=palette.n_valid[0], palette_ids=palette.parent_ids[0],
            sharpness=sharp, blur_bins=bins,
            blur_vector_angles=angles[0], blur_vector_mags=mags[0])
        return (data, deferred) if defer_palette else data


class _RowShard:
    """What one rank of a spatial group holds for (H, W, config): its row
    counts, its bin ids and the tables, on its device."""

    def __init__(self, group, height: int, width: int, cfg: ReportConfig,
                 device):
        self.group = group
        self.n, self.rank = dist.get_world_size(group), dist.get_rank(group)
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.dev = dev
        self.height, self.width, self.cfg = height, width, cfg
        rate = cfg.downsample_rate
        self.d_h = height // rate if rate > 1 else height
        self.d_total = self.d_h * (width // rate if rate > 1 else width)
        self.local_h = -(-height // self.n)
        self.d_local_h = -(-self.d_h // self.n)
        self.tabs = sharded_polar_tables(height, width, cfg.angle_partitions,
                                         cfg.radius_partitions, self.n)
        self.flat_ids = torch.as_tensor(self.tabs.flat_ids[self.rank],
                                        device=dev)
        self.bin_counts = torch.as_tensor(self.tabs.counts, device=dev)
        self.octree = OctreeTables.for_config(cfg, dev)

    def rows(self, rgb: torch.Tensor):
        """(3, H, W) whole image -> (rgb_local, down_local) on the device.
        The decimation runs on the whole image before sharding: its
        stride-(rate-1) row pick is not aligned with row shards."""
        rate = self.cfg.downsample_rate
        rgb_local = own_rows(rgb, self.rank, self.local_h, self.dev)
        down_local = rgb_local if rate == 1 else own_rows(
            downsample_rgb(rgb, rate), self.rank, self.d_local_h, self.dev)
        return rgb_local, down_local

    def body(self, rgb, boxes, valid, variant, **kw):
        return spatial_report_body(
            *self.rows(rgb), boxes, valid, self.flat_ids, self.bin_counts,
            self.octree, self.tabs.wc, self.height, self.width, self.cfg,
            self.group, variant, **kw)


def _check_shape(x: torch.Tensor, want: tuple, name: str) -> None:
    if tuple(x.shape) != want:
        raise ValueError(f"{name}: expected {want}, got {tuple(x.shape)}")


def build_spatial_report(group, height: int, width: int, cfg: ReportConfig,
                         device="cuda"):
    """The row-sharded report over the ranks of ``group``
    (mesh.init_spatial_group); each rank computes on ``device``.

    Returns fn(rgb, boxes, valid) -> ReportData (unbatched, the same on
    every rank).  Every rank calls fn with the whole image, (3, H, W) uint8
    or float32 in [0, 1] (numpy, or a tensor on any device), and moves only
    its own rows to ``device``.  Heights that the rank count does not
    divide are padded with zero rows, which every stage masks.  The palette
    variant (``PHOTOHIVE_PALETTE_KERNEL``) is read at each call."""
    shard = _RowShard(group, height, width, cfg, device)

    def run(rgb, boxes, valid) -> ReportData:
        rgb = torch.as_tensor(rgb)
        _check_shape(rgb, (3, height, width), "rgb")
        return shard.body(rgb, boxes, valid, palette_kernel_variant())

    return run


def build_dp_spatial_report(mesh, batch: int, height: int, width: int,
                            cfg: ReportConfig, device="cuda"):
    """The full multi-rank step: the batch over ``mesh``'s data axis and
    each image's rows over its spatial axis (mesh.make_mesh: a JAX device
    mesh as process groups).

    Returns fn(rgb (B, 3, H, W), boxes (B, 10, 4), valid (B, 10)) ->
    ReportData with the batch leading, the same on every rank.  Every rank
    is handed the whole batch (uint8 or float32 in [0, 1]; numpy, or
    tensors on any device; the boxes on the host) and moves only its own
    rows of its data group's B / data images to ``device``.  Per local
    batch: one sharpness route for all its images (one thin box sends
    every image to the masked route, as ``variance_sharpness_batched``
    does), the palettes in one deferred pass (``sharded_palette``), then
    one all_gather of the reports over the data axis, in data-index
    order.  Each image equals ``build_spatial_report`` of it bit for bit
    when both take the same sharpness route."""
    if batch % mesh.data:
        raise ValueError(f"batch {batch} must divide by data={mesh.data}")
    per = batch // mesh.data
    first = mesh.data_index * per
    shard = _RowShard(mesh.spatial_group, height, width, cfg, device)

    def run(rgb, boxes, valid) -> ReportData:
        rgb = torch.as_tensor(rgb)
        _check_shape(rgb, (batch, 3, height, width), "rgb")
        boxes = np.asarray(boxes, np.int64)[first:first + per]
        valid = np.asarray(valid, bool)[first:first + per]
        variant = palette_kernel_variant()
        route = dict(any_tiny=bool(thin_boxes(boxes, valid).any()),
                     any_valid=bool(valid.any()), defer_palette=True)
        reports, hsv = zip(*(shard.body(rgb[first + i], boxes[i], valid[i],
                                        variant, **route)
                             for i in range(per)))
        with span("photohive.pipeline"), span("photohive.stage.palette"):
            palette, s_bar = sharded_palette(
                *(torch.cat(x) for x in zip(*hsv)), shard.d_total, cfg,
                shard.octree, mesh.spatial_group, variant)
        local = ReportData(*(torch.stack(x) for x in zip(*reports)))._replace(
            average_saturation=s_bar, palette_hsv=palette.hsv,
            palette_pct=palette.percentages, palette_n=palette.n_valid,
            palette_ids=palette.parent_ids)
        return gather_reports(local, mesh.data_group)

    return run
