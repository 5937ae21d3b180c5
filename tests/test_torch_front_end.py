"""The palette kernels' front end (csrc/hsv_cells.cuh) emulated on the CPU
in numpy float32, against the plain path (colorspace.u8_to_unit_f32,
rgb_to_hsv, quantize.assign_cells, fixed_point.to_fixed): the uint8 decode
table on all 256 inputs, the cell-index thresholds
(palette_kernels.index_bounds) on every float32 around them, and the whole
uint8 front end (one hue division, the cell id by thresholds) on all 2^24
RGB triples at the default 18x2x3 grid, 12x3x2 and 24x5x5 (whose v and s
indices take the guess-and-correct route).  The cell id is XLA's
``x * f32(1/L)``, like ``div_const``: the kernels' multiplier is
``CellParams``' reciprocal of each cell step.  Every comparison is bit for
bit.  The kernels themselves run on the card only: chip_smoke.py holds
them to the plain versions on the same triples."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch

from photohive_dsp_tpu_torch.config import ReportConfig
from photohive_dsp_tpu_torch.ops import palette_kernels as tpk
from photohive_dsp_tpu_torch.ops._cuda import CellParams
from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv, \
    u8_to_unit_f32
from photohive_dsp_tpu_torch.ops.fixed_point import to_fixed
from photohive_dsp_tpu_torch.ops.quantize import assign_cells

f32 = np.float32
CONFIGS = {"18x2x3": ReportConfig(),
           "12x3x2": ReportConfig(h_partitions=12, s_partitions=3,
                                  v_partitions=2),
           "36x4x4": ReportConfig(h_partitions=36, s_partitions=4,
                                  v_partitions=4),
           "360x2x3": ReportConfig(h_partitions=360),
           "24x5x5": ReportConfig(h_partitions=24, s_partitions=5,
                                  v_partitions=5)}


def unit_table() -> np.ndarray:
    """The kernels' decode table: x / 255 in float32 (__fdiv_rn)."""
    return np.arange(256, dtype=np.float32) / f32(255)


def bin_index(x, base, inv, top, t):
    """hsv_cells.cuh bin_index: the guess (x - base) * inv, inv the
    reciprocal of the cell step, rounded to an integer in [0, top] by the
    2^23 add, corrected by the thresholds around it."""
    with np.errstate(invalid="ignore", over="ignore"):
        q = (x - f32(base)) * f32(inv)
        q = np.minimum(np.fmax(q, f32(0)), f32(top))
        k = (q + f32(8388608.0)).view(np.int32) - 0x4B000000
    return k + (x >= t[k + 1]) - (x < t[k])


REG_BOUNDS = 3  # hsv_cells.cuh kRegBounds


def reg_index(x, top, t):
    """hsv_cells.cuh reg_index: the count of the first REG_BOUNDS
    thresholds (NaN past the top) that x reaches."""
    r = np.full(REG_BOUNDS, np.nan, np.float32)
    r[:top] = t[1:top + 1]
    return sum((x >= r[i]).astype(np.int64) for i in range(REG_BOUNDS))


def index_of(x, base, inv, top, t):
    """The kernels' index: in registers when it fits, else guessed."""
    if top <= REG_BOUNDS:
        return reg_index(x, top, t)
    return bin_index(x, base, inv, top, t)


def cell_params(cfg) -> CellParams:
    """The kernels' constants for cfg (no thresholds on a device)."""
    tops = [top for top, _ in tpk.index_bounds(cfg)]
    return CellParams.for_config(cfg, tops, torch.zeros(1))


def kernel_cells(h, s, v, cfg):
    """hsv_cells.cuh hsv_cell, emulated with CellParams' multipliers."""
    (vt, tv), (st, ts), (ht, th) = tpk.index_bounds(cfg)
    p = cell_params(cfg)
    vi = index_of(v, cfg.black_thresh, p.inv_lv, vt, tv)
    si = index_of(s, cfg.gray_thresh, p.inv_ls, st, ts)
    hi = bin_index(h, 0.0, p.inv_lh, ht, th)
    color = (hi * cfg.s_partitions + si) * cfg.v_partitions + vi
    return np.where(v < f32(cfg.black_thresh), cfg.black_id,
                    np.where(s < f32(cfg.gray_thresh), cfg.gray_start,
                             color))


def kernel_hsv(r, g, b):
    """hsv_cells.cuh rgb_hsv_cell's HSV, emulated: one division for the
    hue, its numerator and offset selected first."""
    with np.errstate(invalid="ignore", divide="ignore"):
        mx = np.fmax(np.fmax(r, g), b)
        mn = np.fmin(np.fmin(r, g), b)
        delta = mx - mn
        safe = np.where(delta == 0, f32(1), delta)
        is_r = mx == r
        is_g = ~is_r & (mx == g)
        num = np.where(is_r, g - b, np.where(is_g, b - r, r - g))
        q = num / safe
        hh = f32(60) * np.where(is_r, q, np.where(is_g, f32(2), f32(4)) + q)
        hh = np.where(delta == 0, f32(0), hh)
        hh = np.where(hh < 0, hh + f32(360), hh)
        hh = np.where(hh > 360, hh - f32(360), hh)
        v = np.where(mx == 1, f32(0.999999), mx)
        sq = delta / np.where(mx == 0, f32(1), mx)
        s = np.where(mx == 0, f32(0),
                     np.where(delta == mx, f32(0.999999), sq))
    return hh.astype(np.float32), s.astype(np.float32), v.astype(np.float32)


def test_unit_table_is_the_correctly_rounded_decode():
    x = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    want = u8_to_unit_f32(x).numpy()
    assert np.array_equal(unit_table().view(np.int32), want.view(np.int32))


def _near(t: np.ndarray, steps: int = 4) -> np.ndarray:
    """Every float32 within ``steps`` of each finite value of t."""
    t = t[np.isfinite(t)]
    out = [t]
    up, down = t.copy(), t.copy()
    for _ in range(steps):
        up = np.nextafter(up, f32(np.inf))
        down = np.nextafter(down, f32(-np.inf))
        out += [up, down]
    return np.concatenate(out)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_index_bounds_are_the_least_floats_of_each_index(name):
    """t_k is the least float32 whose index (the reciprocal multiply,
    ``cell_index``) is k or more: its index reaches k, the float below it
    does not, and top is the index of +inf.  An index never decreases, so
    counting the t_k an input reaches gives the index of every float32."""
    cfg = CONFIGS[name]
    for spec, (top, t) in zip(tpk._index_specs(cfg), tpk.index_bounds(cfg)):
        assert tpk.cell_index(np.array([np.inf], f32), *spec)[0] == top
        assert t[0] == -np.inf and np.isnan(t[-1]) and len(t) == top + 2
        inner = t[1:-1]
        k = np.arange(1, top + 1)
        assert (np.diff(inner) > 0).all()
        assert (tpk.cell_index(inner, *spec) >= k).all()
        below = np.nextafter(inner, f32(-np.inf))
        assert (tpk.cell_index(below, *spec) < k).all()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bin_index_equals_the_division(name):
    """The kernels' guess-and-correct index, with CellParams' multiplier,
    and the register count where the index fits it, against the index
    (XLA's lowering of the division: x * f32(1/L)), around every
    threshold, on the specials and on random floats."""
    cfg = CONFIGS[name]
    rng = np.random.default_rng(5)
    bases = (cfg.black_thresh, cfg.gray_thresh, 0.0)
    p = cell_params(cfg)
    invs = (p.inv_lv, p.inv_ls, p.inv_lh)
    for spec, (top, t), base, inv in zip(tpk._index_specs(cfg),
                                         tpk.index_bounds(cfg), bases, invs):
        assert f32(inv) == f32(1) / f32(spec[1])
        x = np.concatenate([
            _near(t), _near(np.array([0.0, 1.0, 360.0, base], f32)),
            np.array([np.inf, -np.inf, 3e38, -3e38, -0.0], f32),
            (rng.random(200000) * 420 - 30).astype(f32),
            rng.random(200000).astype(f32)])
        want = tpk.cell_index(x, *spec)
        assert np.array_equal(bin_index(x, base, inv, top, t), want)
        if top <= REG_BOUNDS:
            assert np.array_equal(reg_index(x, top, t), want)


def test_front_end_on_every_uint8_triple():
    """h and s bit for bit, the fixed-point s and the cell id at each grid
    equal, over all 2^24 RGB triples in chunks."""
    unit = unit_table()
    grids = [CONFIGS[k] for k in ("18x2x3", "12x3x2", "24x5x5")]
    chunk = 1 << 22
    for start in range(0, 1 << 24, chunk):
        i = np.arange(start, start + chunk, dtype=np.uint32)
        rgb = np.stack([i >> 16, (i >> 8) & 255, i & 255]).astype(np.uint8)
        h, s, v = kernel_hsv(*unit[rgb])
        planes = u8_to_unit_f32(torch.from_numpy(rgb))
        h0, s0, v0 = rgb_to_hsv(planes[0], planes[1], planes[2])
        for got, want in ((h, h0), (s, s0), (v, v0)):
            assert np.array_equal(got.view(np.int32),
                                  want.numpy().view(np.int32))
        fixed = np.round(s.astype(np.float64) * 2.0 ** 28).astype(np.int64)
        assert np.array_equal(fixed, to_fixed(s0).numpy())
        for cfg in grids:
            want = assign_cells(h0, s0, v0, cfg).numpy()
            assert np.array_equal(kernel_cells(h, s, v, cfg), want)
