"""The CUDA kernels as registered PyTorch operators, ``torch.ops.photohive``.

One operator for each C entry point of the kernel library (ops/_cuda.py):

    operator            entry point            kernels
    cell_counts_s       ph_cell_counts_s       K1 (uint8), K11 (float32)
    cell_counts_hsv     ph_cell_counts_hsv     K9
    cell_counts_ids     ph_cell_counts_ids     K15
    palette_sums_q1     ph_palette_sums_q1     K3 (uint8), K12 (float32)
    palette_sums        ph_palette_sums        K4 (uint8), K13 (float32)
    palette_sums_hsv    ph_palette_sums_hsv    K10
    palette_sums_cwide  ph_palette_sums_cwide  K14
    margin_sort         ph_margin_sort         K2
    sharpness_sums      ph_sharpness_sums      K5
    fft_rows            ph_fft_rows            K6a
    fft_cols            ph_fft_cols            K6b
    polar_lognorm       ph_polar_lognorm       K7+K8

Each of these operators has three implementations: for CPU tensors the
kernel's plain version; for CUDA tensors the kernel's launch, the only
place the package calls ``_cuda.launch``, which counts it in
``_cuda.LAUNCHES`` (there is no fallback: a launch that fails raises);
and a fake one that gives the outputs' shapes and dtypes alone, a
symbolic batch included.  So ``torch.export``, ``torch.compile``,
CUDA-graph capture and ``TorchDispatchMode``s see each kernel as one
operator, and an exported program finds it by name in any process that
has imported this package.
The wrappers in the kernel modules check their inputs and call these
operators; they are the package's interface to the kernels.

An operator takes tensors and scalars only.  The palette operators get the
report configuration as its cell grid (``palette_kernels.cell_grid``: the
h, s and v partitions and the black and gray thresholds, all that the cell
id depends on) and rebuild it (``palette_kernels.grid_config``); the FFT
operators get the plan's stage radices and twiddle tables.  What the
launch derives from those, the cell-id thresholds
(``palette_kernels.index_bounds``, on the device once per grid; the cell id
is XLA's ``x * f32(1/L)``, like ``div_const``), K2's
bucket, K6b's tile and K5's scratch, tickets and 16-byte row loads, stays
inside the CUDA implementations, out of any traced graph.

``masked_sharpness`` is the masked sharpness route, which no kernel
implements yet: plain PyTorch (``ops/sharpness._masked_sharpness``) for
CPU tensors; for CUDA tensors the same operations replayed from a CUDA
graph (``ops/sharpness.masked_sharpness_graphed``); and a fake.  As an
operator it is one node of an exported graph and one range of a trace,
which charges the device time of its PyTorch kernels to it; its counter
in ``_cuda.LAUNCHES`` counts the images it takes, on either device.

``spectrum_bins`` is the blur route of shapes outside the FFT kernels'
gate (``fft_plan.fft_kernel_eligible``): ``torch.fft.rfft2``'s |X|^2 in
the natural half-spectrum layout, then K7+K8 (``polar_lognorm``) on it
with the int32 bin ids, as on shapes inside the gate; for CPU and CUDA
tensors alike, and a fake.  As an operator it is one node of an exported
graph and one range of a trace, which charges the device time of cuFFT's
kernels and of K7+K8 to it.

``branch`` is the conditional with which the routes choose between
kernels (the palette tier, the sharpness route).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from ..config import MAX_CROP_BOXES, ReportConfig
from . import _cuda
from . import fft_kernels as fk
from . import margin_sort as ms
from . import palette_kernels as pk
from . import polar_kernels as pol
from . import sharpness_kernels as sk
from .fft import magnitude_fft
from .fft_plan import LengthPlan, col_tile
from .fixed_point import from_fixed


def branch(pred, true_fn, false_fn, operands: tuple):
    """``torch.cond(pred, true_fn, false_fn, operands)``.  Traced
    (``torch.export``, ``torch.compile``), both branches enter the graph
    and the predicate is read when the graph runs.  Run eagerly, the
    predicate is read here, and only the branch taken runs: a predicate on
    the host costs no device sync (``torch.cond`` itself would compile the
    branches with dynamo on every eager call)."""
    if not torch.compiler.is_compiling():
        pred = bool(pred)
    return torch.cond(pred, true_fn, false_fn, operands)


# -------------------------------------------- the palette's launches ---

@functools.lru_cache(maxsize=None)
def _device_bounds(cfg: ReportConfig, device: torch.device):
    """(tops, [v | s | h] thresholds as one tensor on ``device``)."""
    bounds = pk.index_bounds(cfg)
    return (tuple(top for top, _ in bounds),
            torch.as_tensor(np.concatenate([t for _, t in bounds]),
                            device=device))


def _cell_params(cfg: ReportConfig, device: torch.device):
    tops, bounds = _device_bounds(cfg, device)
    return ctypes.byref(_cuda.CellParams.for_config(cfg, tops, bounds))


def _rgb_args(rgb: Tensor, cfg: ReportConfig):
    b, _, hh, ww = rgb.shape
    return (_cuda.ptr(rgb), int(rgb.dtype == torch.uint8), b, hh * ww,
            _cell_params(cfg, rgb.device))


def _hsv_args(h: Tensor, s: Tensor, v: Tensor, cfg: ReportConfig):
    return (_cuda.ptr(h), _cuda.ptr(s), _cuda.ptr(v), h.shape[0], h.shape[1],
            _cell_params(cfg, h.device))


def _count_rgb(name: str, rgb: Tensor) -> None:
    """Count a launch of an RGB palette kernel: K1/K3/K4 for uint8 input,
    K11/K12/K13 (``*_f32``) for float32, whatever the route (see
    ``_cuda``)."""
    _cuda.LAUNCHES[name if rgb.dtype == torch.uint8 else name + "_f32"] += 1


def _num_cells(grid: Sequence[float]) -> int:
    return pk.grid_config(grid).num_cells


def _empty(like: Tensor, shape, dtype) -> Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def _define(name: str):
    """Register ``photohive::<name>`` with its CPU implementation."""
    return torch.library.custom_op(f"photohive::{name}", mutates_args=(),
                                   device_types="cpu")


# ----------------------------------------------------- K1 / K9 / K15 ---

@_define("cell_counts_s")
def cell_counts_s(rgb: Tensor, grid: List[float]) -> Tuple[Tensor, Tensor]:
    return pk.cell_counts_s_from_rgb_plain(rgb, pk.grid_config(grid))


@cell_counts_s.register_kernel("cuda")
def _(rgb, grid):
    cfg = pk.grid_config(grid)
    b, c = rgb.shape[0], cfg.num_cells
    counts = _empty(rgb, (b, c), torch.int32)
    s_sum = _empty(rgb, (b,), torch.float32)
    acc = _empty(rgb, (b, c + 1), torch.int64)
    _cuda.launch("ph_cell_counts_s", rgb, *_rgb_args(rgb, cfg),
                 _cuda.ptr(counts), _cuda.ptr(s_sum), _cuda.ptr(acc))
    _count_rgb("cell_counts_s", rgb)
    return counts, s_sum


@cell_counts_s.register_fake
def _(rgb, grid):
    b = rgb.shape[0]
    return (rgb.new_empty((b, _num_cells(grid)), dtype=torch.int32),
            rgb.new_empty((b,), dtype=torch.float32))


@_define("cell_counts_hsv")
def cell_counts_hsv(h: Tensor, s: Tensor, v: Tensor,
                    grid: List[float]) -> Tensor:
    return pk.cell_counts_from_hsv_plain(h, s, v, pk.grid_config(grid))


@cell_counts_hsv.register_kernel("cuda")
def _(h, s, v, grid):
    cfg = pk.grid_config(grid)
    acc = _empty(h, (h.shape[0], cfg.num_cells + 1), torch.int64)
    _cuda.launch("ph_cell_counts_hsv", h, *_hsv_args(h, s, v, cfg),
                 _cuda.ptr(acc))
    _cuda.LAUNCHES["cell_counts_hsv"] += 1
    return acc


@cell_counts_hsv.register_fake
def _(h, s, v, grid):
    return h.new_empty((h.shape[0], _num_cells(grid) + 1), dtype=torch.int64)


@_define("cell_counts_ids")
def cell_counts_ids(cells: Tensor, num_cells: int) -> Tensor:
    return pk.cell_counts_batched_plain(cells, num_cells)


@cell_counts_ids.register_kernel("cuda")
def _(cells, num_cells):
    b, p = cells.shape
    counts = _empty(cells, (b, num_cells), torch.int32)
    acc = _empty(cells, (b, num_cells + 1), torch.int64)
    _cuda.launch("ph_cell_counts_ids", cells, _cuda.ptr(cells), b, p,
                 num_cells, _cuda.ptr(counts), _cuda.ptr(acc))
    _cuda.LAUNCHES["cell_counts_ids"] += 1
    return counts


@cell_counts_ids.register_fake
def _(cells, num_cells):
    return cells.new_empty((cells.shape[0], num_cells), dtype=torch.int32)


# ------------------------------------------------- K3 / K4 / K10 / K14 -

@_define("palette_sums_q1")
def palette_sums_q1(rgb: Tensor, slot_of_cell: Tensor, offset_of_cell: Tensor,
                    grid: List[float]) -> Tensor:
    return pk.palette_sums_by_k_rgb_q1_plain(rgb, slot_of_cell,
                                             offset_of_cell,
                                             pk.grid_config(grid))


@palette_sums_q1.register_kernel("cuda")
def _(rgb, slot_of_cell, offset_of_cell, grid):
    cfg = pk.grid_config(grid)
    b, c = rgb.shape[0], cfg.num_cells
    sums = _empty(rgb, (b, c, 4), torch.float32)
    acc = _empty(rgb, (b, c, 4), torch.int64)
    _cuda.launch("ph_palette_sums_q1", rgb, *_rgb_args(rgb, cfg),
                 _cuda.ptr(slot_of_cell), _cuda.ptr(offset_of_cell),
                 _cuda.ptr(sums), _cuda.ptr(acc))
    _count_rgb("palette_sums_q1", rgb)
    return sums


@palette_sums_q1.register_fake
def _(rgb, slot_of_cell, offset_of_cell, grid):
    return rgb.new_empty((rgb.shape[0], _num_cells(grid), 4),
                         dtype=torch.float32)


@_define("palette_sums")
def palette_sums(rgb: Tensor, cand: Tensor, centers_by_k: Tensor,
                 grid: List[float]) -> Tensor:
    return pk.palette_sums_by_k_rgb_plain(rgb, cand, centers_by_k,
                                          pk.grid_config(grid))


@palette_sums.register_kernel("cuda")
def _(rgb, cand, centers_by_k, grid):
    cfg = pk.grid_config(grid)
    b, c, q = rgb.shape[0], cfg.num_cells, cand.shape[-1]
    sums = _empty(rgb, (b, c, 4), torch.float32)
    acc = _empty(rgb, (b, c, 4), torch.int64)
    _cuda.launch("ph_palette_sums", rgb, *_rgb_args(rgb, cfg),
                 _cuda.ptr(cand), q, _cuda.ptr(centers_by_k), _cuda.ptr(sums),
                 _cuda.ptr(acc))
    _count_rgb("palette_sums_q8" if q <= 8 else "palette_sums_qfull", rgb)
    return sums


@palette_sums.register_fake
def _(rgb, cand, centers_by_k, grid):
    return rgb.new_empty((rgb.shape[0], _num_cells(grid), 4),
                         dtype=torch.float32)


@_define("palette_sums_hsv")
def palette_sums_hsv(h: Tensor, s: Tensor, v: Tensor, cand: Tensor,
                     centers_by_k: Tensor, grid: List[float]) -> Tensor:
    return pk.palette_sums_by_k_plain(h, s, v, cand, centers_by_k,
                                      pk.grid_config(grid))


@palette_sums_hsv.register_kernel("cuda")
def _(h, s, v, cand, centers_by_k, grid):
    cfg = pk.grid_config(grid)
    q = cand.shape[-1]
    acc = _empty(h, (h.shape[0], cfg.num_cells, 4), torch.int64)
    _cuda.launch("ph_palette_sums_hsv", h, *_hsv_args(h, s, v, cfg),
                 _cuda.ptr(cand), q, _cuda.ptr(centers_by_k), _cuda.ptr(acc))
    _cuda.LAUNCHES["palette_sums_flat_q8" if q <= 8
                   else "palette_sums_flat_qfull"] += 1
    return acc


@palette_sums_hsv.register_fake
def _(h, s, v, cand, centers_by_k, grid):
    return h.new_empty((h.shape[0], _num_cells(grid), 4), dtype=torch.int64)


@_define("palette_sums_cwide")
def palette_sums_cwide(h: Tensor, s: Tensor, v: Tensor, allowed: Tensor,
                       centers_by_k: Tensor, grid: List[float]) -> Tensor:
    return pk.palette_sums_by_k_cwide_plain(h, s, v, allowed, centers_by_k,
                                            pk.grid_config(grid))


@palette_sums_cwide.register_kernel("cuda")
def _(h, s, v, allowed, centers_by_k, grid):
    cfg = pk.grid_config(grid)
    acc = _empty(h, (h.shape[0], cfg.num_cells, 4), torch.int64)
    _cuda.launch("ph_palette_sums_cwide", h, *_hsv_args(h, s, v, cfg),
                 _cuda.ptr(allowed), allowed.shape[-1],
                 _cuda.ptr(centers_by_k), _cuda.ptr(acc))
    _cuda.LAUNCHES["palette_sums_cwide"] += 1
    return acc


@palette_sums_cwide.register_fake
def _(h, s, v, allowed, centers_by_k, grid):
    return h.new_empty((h.shape[0], _num_cells(grid), 4), dtype=torch.int64)


# ----------------------------------------------------------------- K2 ---

@_define("margin_sort")
def margin_sort(sal: Tensor) -> Tensor:
    return ms.margin_insertion_argsort(sal)


@margin_sort.register_kernel("cuda")
def _(sal):
    b, c = sal.shape
    warps, regs = ms.sort_layout(c)
    out = _empty(sal, (b, c), torch.int32)
    _cuda.launch("ph_margin_sort", sal, _cuda.ptr(sal), b, c, warps, regs,
                 _cuda.ptr(out))
    _cuda.LAUNCHES["margin_sort"] += 1
    return out


@margin_sort.register_fake
def _(sal):
    return sal.new_empty(sal.shape, dtype=torch.int32)


# ----------------------------------------------------------------- K5 ---

@_define("sharpness_sums")
def sharpness_sums(pgm: Tensor, halo: Optional[Tensor], boxes: Tensor,
                   row_offset: int) -> Tensor:
    return sk.sums_plain(pgm, boxes, halo, row_offset)


@sharpness_sums.register_kernel("cuda")
def _(pgm, halo, boxes, row_offset):
    b, h, w = pgm.shape
    items = sk.max_items(b, h, w)
    partial = _empty(pgm, (items, 2), torch.float64)
    sums = _empty(pgm, (b, MAX_CROP_BOXES, 2), torch.float64)
    tickets = sk.tickets(pgm.device, b * MAX_CROP_BOXES)
    _cuda.launch("ph_sharpness_sums", pgm, _cuda.ptr(pgm), _cuda.ptr(halo), b,
                 h, w, row_offset, _cuda.ptr(boxes),
                 int(sk.vector_rows(pgm, halo)), items, _cuda.ptr(partial),
                 _cuda.ptr(tickets), _cuda.ptr(sums))
    _cuda.LAUNCHES["sharpness_sums"] += 1
    return sums


@sharpness_sums.register_fake
def _(pgm, halo, boxes, row_offset):
    return pgm.new_empty((pgm.shape[0], MAX_CROP_BOXES, 2),
                         dtype=torch.float64)


# ----------------------------------------- the masked sharpness route ---

@torch.library.custom_op("photohive::masked_sharpness", mutates_args=(),
                         device_types="cpu")
def masked_sharpness(pgm: Tensor, boxes: Tensor, valid: Tensor) -> Tensor:
    # Imported here: ops/sharpness.py imports this module.
    from .sharpness import _masked_sharpness

    _cuda.LAUNCHES["masked_sharpness"] += pgm.shape[0]
    return _masked_sharpness(pgm, boxes, valid)


@masked_sharpness.register_kernel("cuda")
def _(pgm, boxes, valid):
    from .sharpness import masked_sharpness_graphed

    _cuda.LAUNCHES["masked_sharpness"] += pgm.shape[0]
    return masked_sharpness_graphed(pgm, boxes, valid)


@masked_sharpness.register_fake
def _(pgm, boxes, valid):
    return pgm.new_empty((pgm.shape[0], boxes.shape[1]))


# ------------------------------------------ the off-gate blur route ---

@torch.library.custom_op("photohive::spectrum_bins", mutates_args=())
def spectrum_bins(pgm_dc: Tensor, bin_ids: Tensor, bin_counts: Tensor,
                  num_angle_bins: int, num_radius_bins: int) -> Tensor:
    """(B, A, R) normalised blur bins of the DC-free luma (B, H, W)
    float32: K7+K8 on the |X|^2 of ``torch.fft.rfft2``."""
    b = pgm_dc.shape[0]
    mag2 = magnitude_fft(pgm_dc).reshape(b, -1)
    return pol.polar_bin_means_lognorm(mag2, bin_ids, bin_counts).reshape(
        b, num_angle_bins, num_radius_bins)


@spectrum_bins.register_fake
def _(pgm_dc, bin_ids, bin_counts, num_angle_bins, num_radius_bins):
    return pgm_dc.new_empty((pgm_dc.shape[0], num_angle_bins,
                             num_radius_bins))


# -------------------------------------------------------------- K6a/b ---

def _stages(n: int, radices) -> ctypes.c_void_p:
    return ctypes.byref(_cuda.FftStages.for_plan(n, radices))


@_define("fft_rows")
def fft_rows(pgm: Tensor, radices: List[int], twiddles: Tensor,
             stage_twiddles: Tensor) -> Tensor:
    lp = LengthPlan(pgm.shape[-1], tuple(radices), twiddles, stage_twiddles)
    return fk.rows_plain(pgm, lp)


@fft_rows.register_kernel("cuda")
def _(pgm, radices, twiddles, stage_twiddles):
    b, h, w = pgm.shape
    spec = _empty(pgm, (b, h, w // 2 + 1, 2), torch.float32)
    _cuda.launch("ph_fft_rows", pgm, _cuda.ptr(pgm), b * h,
                 _stages(w, radices), _cuda.ptr(twiddles),
                 _cuda.ptr(stage_twiddles), _cuda.ptr(spec))
    _cuda.LAUNCHES["fft_rows"] += 1
    return spec


@fft_rows.register_fake
def _(pgm, radices, twiddles, stage_twiddles):
    b, h, w = pgm.shape
    return pgm.new_empty((b, h, w // 2 + 1, 2), dtype=torch.float32)


@_define("fft_cols")
def fft_cols(spec: Tensor, radices: List[int], twiddles: Tensor,
             stage_twiddles: Tensor) -> Tensor:
    lp = LengthPlan(spec.shape[1], tuple(radices), twiddles, stage_twiddles)
    return fk.cols_plain(spec, lp)


@fft_cols.register_kernel("cuda")
def _(spec, radices, twiddles, stage_twiddles):
    b, h, half, _ = spec.shape
    mag2 = _empty(spec, (b, h, half), torch.float32)
    tile = _cuda.ColTile(*col_tile(h))
    _cuda.launch("ph_fft_cols", spec, _cuda.ptr(spec), b, half,
                 _stages(h, radices), _cuda.ptr(twiddles),
                 _cuda.ptr(stage_twiddles), ctypes.byref(tile),
                 _cuda.ptr(mag2))
    _cuda.LAUNCHES["fft_cols"] += 1
    return mag2


@fft_cols.register_fake
def _(spec, radices, twiddles, stage_twiddles):
    return spec.new_empty(spec.shape[:3], dtype=torch.float32)


# -------------------------------------------------------------- K7+K8 ---

@_define("polar_lognorm")
def polar_lognorm(mag2: Tensor, bin_ids: Tensor, bin_counts: Optional[Tensor],
                  num_bins: int) -> Tuple[Tensor, Tensor, Tensor]:
    acc, mx = pol.polar_bin_sums_lognorm_plain(mag2, bin_ids, num_bins,
                                               fixed=True)
    sums = from_fixed(acc)
    out = sums if bin_counts is None else pol.mean_per_bin(
        sums * pol.lognorm_gain(mx)[:, None], bin_counts)
    return acc, mx, out


@polar_lognorm.register_kernel("cuda")
def _(mag2, bin_ids, bin_counts, num_bins):
    b, p = mag2.shape
    acc = _empty(mag2, (b, num_bins), torch.int64)
    # The kernel keeps each maximum as the int32 bits of a float >= 0.
    mx = _empty(mag2, (b,), torch.float32)
    out = _empty(mag2, (b, num_bins), torch.float32)
    _cuda.launch("ph_polar_lognorm", mag2, _cuda.ptr(mag2),
                 _cuda.ptr(bin_ids), b, p, num_bins, _cuda.ptr(bin_counts),
                 _cuda.ptr(acc), _cuda.ptr(mx), _cuda.ptr(out))
    _cuda.LAUNCHES["polar_bins"] += 1
    return acc, mx, out


@polar_lognorm.register_fake
def _(mag2, bin_ids, bin_counts, num_bins):
    b = mag2.shape[0]
    return (mag2.new_empty((b, num_bins), dtype=torch.int64),
            mag2.new_empty((b,), dtype=torch.float32),
            mag2.new_empty((b, num_bins), dtype=torch.float32))
