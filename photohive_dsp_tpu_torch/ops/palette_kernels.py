"""K1, K3, K4, K9-K15: the palette's pixel passes, their plain versions and
the per-image tables they read.

Counterparts of ``photohive_dsp_tpu/ops/pallas_kernels_bf16.py``
(``cell_counts_s_from_rgb``, ``palette_sums_by_k_rgb_q1``,
``palette_sums_by_k_rgb``), of the kernels of
``photohive_dsp_tpu/ops/pallas_kernels.py`` (the flat-HSV
``cell_counts_from_hsv`` and ``palette_sums_by_k``, the float32 "candidate"
RGB kernels of the same names as the bf16 ones, ``cell_counts_batched``)
and of its LUT builders (``palette_offset_lut``, ``palette_candidate_lut``),
and of ``photohive_dsp_tpu/ops/pallas_kernels_cwide.py``
(``palette_sums_by_k_cwide``, ``cwide_tables``).  The CUDA kernels are
csrc/palette.cu; each wrapper launches its kernel for CUDA tensors and
takes the plain PyTorch version for CPU tensors.

The RGB input is (B, 3, H, W), float32 in [0, 1] or uint8, any H and W.
Both forms give the same results: uint8 decodes to the correctly rounded
x/255 (colorspace.u8_to_unit_f32 here, ``__fdiv_rn`` in the kernels).  The
TPU's bf16 kernels (K1, K3, K4) and its float32 candidate kernels (K11,
K12, K13) are one kernel each here; the launch counters tell uint8 launches
(K1, K3, K4) from float32 ones (K11, K12, K13).  The flat-HSV input is
three (B, P) float32 planes; a hue below 0 marks a pixel that counts for
nothing (the row-sharded report's padded rows).

Saturation and palette sums are exact on 64-bit fixed point
(ops/fixed_point.py), in the kernels and in the plain versions alike.  The
flat-HSV wrappers return the int64 accumulators themselves, which the
row-sharded report adds across ranks before ``counts_s_from_fixed`` /
``palette_sums_from_fixed`` convert them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import MAX_NUM_PIXELS
from . import _cuda
from .colorspace import rgb_to_hsv, u8_to_unit_f32
from .fixed_point import from_fixed, to_fixed
from .quantize import ParentAssignment, OctreeTables, assign_cells, \
    candidate_slots

_RGB_DTYPES = (torch.float32, torch.uint8)
# Pixels per step of the plain K4/K10 tie-break (its (P, q) temporaries)
# and of the plain K14 (its (P, C) temporaries).
_CHUNK_PX = 1 << 22
_CWIDE_CHUNK_PX = 1 << 20
# K14's mask value for slots outside a cell's allowed row: finite, as in
# the JAX kernel (pallas_kernels._BIG), so an empty row picks slot 0.
_BIG = 3.0e38


def _check_rgb(rgb: torch.Tensor) -> None:
    _cuda.require(rgb, "rgb", _RGB_DTYPES, 4)
    if rgb.shape[1] != 3:
        raise ValueError(f"rgb: expected (B, 3, H, W), got {tuple(rgb.shape)}")
    if rgb.shape[2] * rgb.shape[3] > MAX_NUM_PIXELS:
        # The kernels' 64-bit fixed-point sums hold ~1.9e8 pixels per image.
        raise ValueError("rgb: image larger than config.MAX_NUM_PIXELS")


def _check_table(t: torch.Tensor, name: str, dtype, shape, rgb) -> None:
    _cuda.require(t, name, (dtype,), len(shape))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != rgb.device:
        raise ValueError(f"{name}: on {t.device}, rgb on {rgb.device}")


def _hsv_cells(rgb: torch.Tensor, cfg):
    """(B, 3, H, W) -> h, s, v (B, P) float32 and cells (B, P) int64."""
    if rgb.dtype == torch.uint8:
        rgb = u8_to_unit_f32(rgb)
    flat = rgb.reshape(rgb.shape[0], 3, -1)
    h, s, v = rgb_to_hsv(flat[:, 0], flat[:, 1], flat[:, 2])
    return h, s, v, assign_cells(h, s, v, cfg).long()


def _check_hsv(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("h", h), ("s", s), ("v", v)):
        _cuda.require(t, name, (torch.float32,), 2)
        if t.shape != h.shape or t.device != h.device:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, h "
                             f"{tuple(h.shape)} on {h.device}")
    if h.shape[1] > MAX_NUM_PIXELS:
        raise ValueError("hsv: more pixels per image than "
                         "config.MAX_NUM_PIXELS")


def _flat_hsv_cells(h, s, v, cfg):
    """Cells (B, P) int64 of flat HSV pixels, sentinel C where h < 0."""
    real = h >= 0.0
    cells = assign_cells(torch.where(real, h, 0.0), s, v, cfg).long()
    return torch.where(real, cells, cfg.num_cells), real


# ------------------------------------------------ cell-id thresholds ---

def _index_specs(cfg):
    """(base, step, clip) of quantize.assign_cells' v, s and h indices,
    each trunc(clip((x - base) / step, 0, clip)) in float32 (no base: x /
    step)."""
    return ((cfg.black_thresh, cfg.cell_Lv, cfg.v_partitions - 1e-6),
            (cfg.gray_thresh, cfg.cell_Ls, cfg.s_partitions - 1e-6),
            (None, cfg.cell_Lh, cfg.h_partitions - 1e-6))


def cell_index(x: np.ndarray, base, step, clip) -> np.ndarray:
    """One index of ``assign_cells`` on float32 ``x``, in numpy's float32
    (IEEE, round to nearest: the same bits as torch's and the kernels'
    division)."""
    f32 = np.float32
    with np.errstate(invalid="ignore", over="ignore"):
        y = x if base is None else x - f32(base)
        return np.clip(y / f32(step), f32(0), f32(clip)).astype(np.int64)


def _keys(x: np.ndarray) -> np.ndarray:
    """float32 -> int64 keys in the floats' order (+0 and -0 both 0)."""
    bits = x.view(np.int32).astype(np.int64)
    return np.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def _floats(keys: np.ndarray) -> np.ndarray:
    """Inverse of ``_keys`` (key 0 -> +0)."""
    bits = np.where(keys < 0, (-keys) | 0x80000000, keys)
    return bits.astype(np.uint32).view(np.float32)


@functools.lru_cache(maxsize=None)
def index_bounds(cfg):
    """The thresholds the kernels find the cell id with
    (csrc/hsv_cells.cuh bin_index): for each of assign_cells' v, s and h
    indices, ``(top, t)`` with top the largest index (trunc of the clip)
    and t = [-inf, t_1, ..., t_top, NaN] float32, t_k the least float32
    whose index is k or more.  An index never decreases as its input
    grows, so it is the number of t_k an input reaches, for every float32.
    Found by bisection over the float32 values."""
    out = []
    inf = np.array([np.inf], np.float32)
    for spec in _index_specs(cfg):
        top = int(cell_index(inf, *spec)[0])
        k = np.arange(1, top + 1)
        lo = np.full(top, _keys(-inf)[0])   # index 0 < k
        hi = np.full(top, _keys(inf)[0])    # index top >= k
        while bool((hi - lo > 1).any()):
            mid = (lo + hi) // 2
            up = cell_index(_floats(mid), *spec) >= k
            hi = np.where(up, mid, hi)
            lo = np.where(up, lo, mid)
        out.append((top, np.concatenate(
            [-inf, _floats(hi), np.array([np.nan], np.float32)])))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _device_bounds(cfg, device: torch.device):
    """(tops, [v | s | h] thresholds as one tensor on ``device``)."""
    bounds = index_bounds(cfg)
    return (tuple(top for top, _ in bounds),
            torch.as_tensor(np.concatenate([t for _, t in bounds]),
                            device=device))


def _cell_params(cfg, device: torch.device):
    tops, bounds = _device_bounds(cfg, device)
    return ctypes.byref(_cuda.CellParams.for_config(cfg, tops, bounds))


def _launch_args(rgb: torch.Tensor, cfg):
    b, _, hh, ww = rgb.shape
    return (_cuda.ptr(rgb), int(rgb.dtype == torch.uint8), b, hh * ww,
            _cell_params(cfg, rgb.device))


def _count(name: str, rgb: torch.Tensor) -> None:
    """Count a launch of an RGB palette kernel: K1/K3/K4 for uint8 input,
    K11/K12/K13 (``*_f32``) for float32, whatever the route (see
    ``_cuda``)."""
    _cuda.LAUNCHES[name if rgb.dtype == torch.uint8 else name + "_f32"] += 1


def _hsv_launch_args(h, s, v, cfg):
    return (_cuda.ptr(h), _cuda.ptr(s), _cuda.ptr(v), h.shape[0], h.shape[1],
            _cell_params(cfg, h.device))


# ----------------------------------------------------- K1 / K9 / K15 ---

def _counts_s_fixed(cells: torch.Tensor, s: torch.Tensor, c: int):
    """(B, C + 1) int64 [count per cell, fixed-point sum of s] over the
    pixels whose cell is < c."""
    b = cells.shape[0]
    acc = torch.zeros((b, c + 2), dtype=torch.int64, device=cells.device)
    acc.scatter_add_(1, cells, torch.ones_like(cells))
    s_fx = torch.where(cells < c, to_fixed(s), 0)
    acc[:, c + 1] = s_fx.sum(dim=1)
    return torch.cat([acc[:, :c], acc[:, c + 1:]], dim=1)


def counts_s_from_fixed(acc: torch.Tensor):
    """(B, C + 1) accumulator -> ((B, C) int32 counts, (B,) float32 sum
    of s)."""
    return acc[:, :-1].to(torch.int32), from_fixed(acc[:, -1])


def cell_counts_s_from_rgb_plain(rgb: torch.Tensor, cfg):
    """Plain version of K1: ((B, C) int32 cell counts, (B,) float32 sum of
    the saturation channel)."""
    _, s, _, cells = _hsv_cells(rgb, cfg)
    return counts_s_from_fixed(_counts_s_fixed(cells, s, cfg.num_cells))


def cell_counts_s_from_rgb(rgb: torch.Tensor, cfg):
    """K1: exact per-image cell histogram and saturation sum from planar
    RGB, HSV computed in-kernel."""
    _check_rgb(rgb)
    if rgb.device.type == "cpu":
        return cell_counts_s_from_rgb_plain(rgb, cfg)
    b, c = rgb.shape[0], cfg.num_cells
    counts = torch.empty((b, c), dtype=torch.int32, device=rgb.device)
    s_sum = torch.empty((b,), dtype=torch.float32, device=rgb.device)
    acc = torch.empty((b, c + 1), dtype=torch.int64, device=rgb.device)
    _cuda.launch("ph_cell_counts_s", rgb, *_launch_args(rgb, cfg),
                 _cuda.ptr(counts), _cuda.ptr(s_sum), _cuda.ptr(acc))
    _count("cell_counts_s", rgb)
    return counts, s_sum


def cell_counts_from_hsv_plain(h, s, v, cfg):
    """Plain version of K9 (its accumulator, see ``cell_counts_from_hsv``)."""
    cells, _ = _flat_hsv_cells(h, s, v, cfg)
    return _counts_s_fixed(cells, s, cfg.num_cells)


def cell_counts_from_hsv(h, s, v, cfg):
    """K9: exact per-image cell histogram of flat HSV pixels, hue < 0
    counting for nothing: (B, P) float32 x3 -> (B, C + 1) int64, the counts,
    then the fixed-point saturation sum of the real pixels
    (``counts_s_from_fixed`` converts it)."""
    _check_hsv(h, s, v)
    if h.device.type == "cpu":
        return cell_counts_from_hsv_plain(h, s, v, cfg)
    acc = torch.empty((h.shape[0], cfg.num_cells + 1), dtype=torch.int64,
                      device=h.device)
    _cuda.launch("ph_cell_counts_hsv", h, *_hsv_launch_args(h, s, v, cfg),
                 _cuda.ptr(acc))
    _cuda.LAUNCHES["cell_counts_hsv"] += 1
    return acc


def cell_counts_batched_plain(cells: torch.Tensor, num_cells: int):
    """Plain version of K15."""
    c = num_cells
    idx = torch.where((cells >= 0) & (cells < c), cells.long(), c)
    acc = torch.zeros((cells.shape[0], c + 1), dtype=torch.int64,
                      device=cells.device)
    acc.scatter_add_(1, idx, torch.ones_like(idx))
    return acc[:, :c].to(torch.int32)


def cell_counts_batched(cells: torch.Tensor, num_cells: int):
    """K15: histogram of precomputed cell ids, (B, P) int32 -> (B, C)
    int32; an id outside [0, C) counts for nothing.  Counts are 64-bit in
    the kernel, so the TPU kernel's 2^24-per-cell limit does not apply.
    No product path calls it (the JAX package's tests and tools do)."""
    _cuda.require(cells, "cells", (torch.int32,), 2)
    if cells.shape[1] >= 1 << 31:
        raise ValueError("cells: 2^31 or more ids per image")
    if cells.device.type == "cpu":
        return cell_counts_batched_plain(cells, num_cells)
    b, p = cells.shape
    counts = torch.empty((b, num_cells), dtype=torch.int32,
                         device=cells.device)
    acc = torch.empty((b, num_cells + 1), dtype=torch.int64,
                      device=cells.device)
    _cuda.launch("ph_cell_counts_ids", cells, _cuda.ptr(cells), b, p,
                 num_cells, _cuda.ptr(counts), _cuda.ptr(acc))
    _cuda.LAUNCHES["cell_counts_ids"] += 1
    return counts


# ------------------------------------------------------------ tables ----

def palette_offset_table(assign: ParentAssignment, tables: OctreeTables,
                         num_cells: int):
    """K3's per-image tables, valid on the q=1 tier (no populated cell
    tied): each cell's parent slot (B, C) int32 and the hue offset
    180 - centre_hue of that parent (B, C) float32."""
    c = num_cells
    slot = candidate_slots(assign, c, 1)[..., 0]
    hue_by_k = tables.centers[assign.order, 0]                # (B, C)
    offset = 180.0 - torch.gather(hue_by_k, 1,
                                  torch.clamp(slot, max=c - 1).long())
    return slot.contiguous(), offset.contiguous()


def palette_candidate_table(assign: ParentAssignment, tables: OctreeTables,
                            num_cells: int, q_pad: int):
    """K4's per-image tables: the candidate slots (B, C, q_pad) int32 and
    the cell centres in valid order (B, C, 3) float32."""
    return (candidate_slots(assign, num_cells, q_pad),
            tables.centers[assign.order].contiguous())


def allowed_bitmask(allowed: torch.Tensor) -> torch.Tensor:
    """(B, C, C) bool -> (B, C, ceil(C/32)) int32: bit k % 32 of word
    k // 32 of row ``cell`` is set when slot k is an allowed parent of the
    cell (K14's table)."""
    b, c, _ = allowed.shape
    words = -(-c // 32)
    bits = torch.zeros((b, c, words * 32), dtype=torch.int64,
                       device=allowed.device)
    bits[..., :c] = allowed
    weights = torch.ones(32, dtype=torch.int64,
                         device=allowed.device) << torch.arange(
                             32, device=allowed.device)
    packed = (bits.reshape(b, c, words, 32) * weights).sum(dim=-1)
    return torch.where(packed >= 1 << 31, packed - (1 << 32),
                       packed).to(torch.int32).contiguous()


def unpack_allowed(bits: torch.Tensor, num_cells: int) -> torch.Tensor:
    """Inverse of ``allowed_bitmask``: (B, C, words) int32 -> (B, C, C)
    bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    unpacked = (bits[..., None] >> shifts) & 1
    return unpacked.reshape(*bits.shape[:-1], -1)[..., :num_cells].bool()


def cwide_tables(assign: ParentAssignment, tables: OctreeTables):
    """K14's per-image tables (the JAX package's ``cwide_tables``): the
    allowed parents of each cell as a bitmask (B, C, ceil(C/32)) int32 and
    the cell centres in valid order (B, C, 3) float32."""
    return (allowed_bitmask(assign.allowed),
            tables.centers[assign.order].contiguous())


# ------------------------------------------------- K3 / K4 / K10 / K14 -

def _slot_sums_fixed(h, s, v, slot, offset, c: int) -> torch.Tensor:
    """[sum wrapped hue + offset, sum s, sum v, count] per slot, (B, C, 4)
    int64, the sums on the fixed point; slots >= c drop out."""
    temp = h + offset
    temp = torch.where(temp > 360.0, temp - 360.0,
                       torch.where(temp < 0.0, temp + 360.0, temp))
    b = h.shape[0]
    base = torch.arange(b, device=h.device)[:, None] * (c + 1)
    idx = (torch.where(slot < c, slot, c) + base).reshape(-1)
    vals = torch.stack([to_fixed(temp), to_fixed(s), to_fixed(v),
                        torch.ones_like(slot, dtype=torch.int64)], dim=-1)
    acc = torch.zeros((b * (c + 1), 4), dtype=torch.int64, device=h.device)
    acc.index_add_(0, idx, vals.reshape(-1, 4))
    return acc.reshape(b, c + 1, 4)[:, :c]


def palette_sums_from_fixed(acc: torch.Tensor) -> torch.Tensor:
    """(B, C, 4) int64 accumulator -> (B, C, 4) float32 sums, the
    conversion of the kernels' finish."""
    return torch.cat([from_fixed(acc[..., :3]), acc[..., 3:].float()],
                     dim=-1)


def _slot_sums(h, s, v, slot, offset, c: int) -> torch.Tensor:
    return palette_sums_from_fixed(_slot_sums_fixed(h, s, v, slot, offset, c))


def palette_sums_by_k_rgb_q1_plain(rgb, slot_of_cell, offset_of_cell, cfg):
    """Plain version of K3: (B, C, 4) per-slot sums."""
    h, s, v, cells = _hsv_cells(rgb, cfg)
    slot = torch.gather(slot_of_cell.long(), 1, cells)
    offset = torch.gather(offset_of_cell, 1, cells)
    return _slot_sums(h, s, v, slot, offset, cfg.num_cells)


def palette_sums_by_k_rgb_q1(rgb, slot_of_cell, offset_of_cell, cfg):
    """K3, the q=1 tier: every pixel's parent is a function of its cell, so
    the pass is a table lookup and a per-slot sum."""
    _check_rgb(rgb)
    b, c = rgb.shape[0], cfg.num_cells
    _check_table(slot_of_cell, "slot_of_cell", torch.int32, (b, c), rgb)
    _check_table(offset_of_cell, "offset_of_cell", torch.float32, (b, c), rgb)
    if rgb.device.type == "cpu":
        return palette_sums_by_k_rgb_q1_plain(rgb, slot_of_cell,
                                              offset_of_cell, cfg)
    sums = torch.empty((b, c, 4), dtype=torch.float32, device=rgb.device)
    acc = torch.empty((b, c, 4), dtype=torch.int64, device=rgb.device)
    _cuda.launch("ph_palette_sums_q1", rgb, *_launch_args(rgb, cfg),
                 _cuda.ptr(slot_of_cell), _cuda.ptr(offset_of_cell),
                 _cuda.ptr(sums), _cuda.ptr(acc))
    _count("palette_sums_q1", rgb)
    return sums


def _nearest_candidates(h, s, v, cells, cand, centers_by_k, c: int):
    """Per pixel, the float32 distance to each of its cell's candidates in
    the op order of the JAX package's pixel pass
    (quantize.palette_pixel_sums); the first minimum wins.  Returns the
    slot (B, P) and the hue offset 180 - centre hue of that slot."""
    slots, offsets = [], []
    # One image and _CHUNK_PX pixels at a time bound the (P, q) temporaries.
    for i in range(h.shape[0]):
        for j in range(0, h.shape[1], _CHUNK_PX):
            px = slice(j, j + _CHUNK_PX)
            cell = cells[i, px]
            cand_p = cand[i].long()[torch.clamp(cell, max=c - 1)]  # (P, q)
            ctr = centers_by_k[i][torch.clamp(cand_p, max=c - 1)]  # (P, q, 3)
            hd = torch.abs(h[i, px][:, None] - ctr[..., 0])
            hd = torch.where(hd > 180.0, 360.0 - hd, hd) * (1.0 / 360.0)
            sd = s[i, px][:, None] - ctr[..., 1]
            vd = v[i, px][:, None] - ctr[..., 2]
            d = hd * hd + sd * sd + vd * vd
            d = torch.where(cand_p < c, d, float("inf"))
            slot = torch.gather(cand_p, 1, d.argmin(dim=1, keepdim=True))[:, 0]
            slots.append(torch.where(cell < c, slot, c))
            safe = torch.clamp(slot, max=c - 1)
            offsets.append(180.0 - centers_by_k[i][safe, 0])
    return (torch.cat(slots).reshape(h.shape),
            torch.cat(offsets).reshape(h.shape))


def palette_sums_by_k_rgb_plain(rgb, cand, centers_by_k, cfg):
    """Plain version of K4 (see ``_nearest_candidates``)."""
    h, s, v, cells = _hsv_cells(rgb, cfg)
    c = cfg.num_cells
    slot, offset = _nearest_candidates(h, s, v, cells, cand, centers_by_k, c)
    return _slot_sums(h, s, v, slot, offset, c)


def palette_sums_by_k_rgb(rgb, cand, centers_by_k, cfg):
    """K4, q > 1: per-pixel tie-break among the cell's candidates, sums per
    valid-order slot, (B, C, 4) float32."""
    _check_rgb(rgb)
    b, c = rgb.shape[0], cfg.num_cells
    q = _check_candidates(cand, centers_by_k, b, c, rgb)
    if rgb.device.type == "cpu":
        return palette_sums_by_k_rgb_plain(rgb, cand, centers_by_k, cfg)
    sums = torch.empty((b, c, 4), dtype=torch.float32, device=rgb.device)
    acc = torch.empty((b, c, 4), dtype=torch.int64, device=rgb.device)
    _cuda.launch("ph_palette_sums", rgb, *_launch_args(rgb, cfg),
                 _cuda.ptr(cand), q, _cuda.ptr(centers_by_k), _cuda.ptr(sums),
                 _cuda.ptr(acc))
    _count("palette_sums_q8" if q <= 8 else "palette_sums_qfull", rgb)
    return sums


def _check_candidates(cand, centers_by_k, b: int, c: int, like) -> int:
    q = cand.shape[-1] if cand.dim() == 3 else 0
    _check_table(cand, "cand", torch.int32, (b, c, q), like)
    _check_table(centers_by_k, "centers_by_k", torch.float32, (b, c, 3), like)
    return q


def palette_sums_by_k_plain(h, s, v, cand, centers_by_k, cfg):
    """Plain version of K10: K4's plain version on flat HSV pixels, hue < 0
    dropped, on the fixed point."""
    c = cfg.num_cells
    cells, real = _flat_hsv_cells(h, s, v, cfg)
    h = torch.where(real, h, 0.0)
    slot, offset = _nearest_candidates(h, s, v, cells, cand, centers_by_k, c)
    return _slot_sums_fixed(h, s, v, slot, offset, c)


def palette_sums_by_k(h, s, v, cand, centers_by_k, cfg):
    """K10, q > 1 on flat HSV pixels: K4's per-pixel tie-break among the
    cell's candidates and sums per valid-order slot, hue < 0 adding
    nothing: -> (B, C, 4) int64 accumulator [hue, s, v on the fixed point,
    count] (``palette_sums_from_fixed`` converts it)."""
    _check_hsv(h, s, v)
    b, c = h.shape[0], cfg.num_cells
    q = _check_candidates(cand, centers_by_k, b, c, h)
    if h.device.type == "cpu":
        return palette_sums_by_k_plain(h, s, v, cand, centers_by_k, cfg)
    acc = torch.empty((b, c, 4), dtype=torch.int64, device=h.device)
    _cuda.launch("ph_palette_sums_hsv", h, *_hsv_launch_args(h, s, v, cfg),
                 _cuda.ptr(cand), q, _cuda.ptr(centers_by_k), _cuda.ptr(acc))
    _cuda.LAUNCHES["palette_sums_flat_q8" if q <= 8
                   else "palette_sums_flat_qfull"] += 1
    return acc


def palette_sums_by_k_cwide_plain(h, s, v, allowed, centers_by_k, cfg):
    """Plain version of K14, the JAX kernel's formulation
    (pallas_kernels_cwide.py:63-87): the float32 distance of each pixel to
    every slot's centre, masked by its cell's allowed row with a finite
    big value, first minimum (slot 0 for an empty row), sums on the fixed
    point; hue < 0 dropped."""
    c = cfg.num_cells
    cells, real = _flat_hsv_cells(h, s, v, cfg)
    h = torch.where(real, h, 0.0)
    mask = unpack_allowed(allowed, c)
    slots, offsets = [], []
    # One image and _CWIDE_CHUNK_PX pixels at a time bound the (P, C)
    # temporaries.
    for i in range(h.shape[0]):
        ctr = centers_by_k[i]
        for j in range(0, h.shape[1], _CWIDE_CHUNK_PX):
            px = slice(j, j + _CWIDE_CHUNK_PX)
            cell = cells[i, px]
            hd = torch.abs(h[i, px][:, None] - ctr[:, 0])
            hd = torch.where(hd > 180.0, 360.0 - hd, hd) * (1.0 / 360.0)
            sd = s[i, px][:, None] - ctr[:, 1]
            vd = v[i, px][:, None] - ctr[:, 2]
            d = hd * hd + sd * sd + vd * vd
            d = torch.where(mask[i][torch.clamp(cell, max=c - 1)], d, _BIG)
            slot = d.argmin(dim=1)
            slots.append(torch.where(cell < c, slot, c))
            offsets.append(180.0 - ctr[slot, 0])
    slot = torch.cat(slots).reshape(h.shape)
    offset = torch.cat(offsets).reshape(h.shape)
    return _slot_sums_fixed(h, s, v, slot, offset, c)


def palette_sums_by_k_cwide(h, s, v, allowed, centers_by_k, cfg):
    """K14, C-wide on flat HSV pixels: per pixel the first minimum distance
    over its cell's allowed parents (the bitmask of ``cwide_tables``), no
    candidate width, sums per valid-order slot, hue < 0 adding nothing:
    -> (B, C, 4) int64 accumulator, K10's layout (``palette_sums_from_fixed``
    converts it).  Equal to K10's wherever K10's candidates hold every
    allowed parent; a cell with an empty row sends its pixels to slot 0
    (K10 drops them)."""
    _check_hsv(h, s, v)
    b, c = h.shape[0], cfg.num_cells
    words = -(-c // 32)
    _check_table(allowed, "allowed", torch.int32, (b, c, words), h)
    _check_table(centers_by_k, "centers_by_k", torch.float32, (b, c, 3), h)
    if h.device.type == "cpu":
        return palette_sums_by_k_cwide_plain(h, s, v, allowed, centers_by_k,
                                             cfg)
    acc = torch.empty((b, c, 4), dtype=torch.int64, device=h.device)
    _cuda.launch("ph_palette_sums_cwide", h, *_hsv_launch_args(h, s, v, cfg),
                 _cuda.ptr(allowed), words, _cuda.ptr(centers_by_k),
                 _cuda.ptr(acc))
    _cuda.LAUNCHES["palette_sums_cwide"] += 1
    return acc
