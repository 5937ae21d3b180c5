"""Invariant checkers, the counterpart of the reference's src/debug.c
developer validators (and of ``photohive_dsp_tpu/utils/debug.py``).

The reference shipped manual verify-functions instead of unit tests
(SURVEY.md §4): verify_arm_octree (bin bounds + pixel conservation,
src/debug.c:64-131), validate_octree_parents (sort monotonicity, :134-157),
report_color_palette (range checks, sum of percentages, :219-255), plus a
synthetic image generator (:53-61).  These run on host arrays (numpy, or
CPU tensors) and raise AssertionError with a diagnostic; the tests use them
as property checks, and they can be applied to production outputs when
debugging.  ``nan_checks`` stops at the first operator that makes a NaN.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..config import ReportConfig
from ..ops.geometry import octree_geometry


def verify_cell_assignment(h, s, v, cells, cfg: ReportConfig) -> None:
    """Every pixel's cell must contain it (reference verify_arm_octree).

    Checks the color-cell bounds for color pixels and the gray/black
    routing rules, plus total-count conservation.
    """
    h = np.asarray(h).ravel()
    s = np.asarray(s).ravel()
    v = np.asarray(v).ravel()
    cells = np.asarray(cells).ravel()
    assert cells.shape == h.shape, "pixel/cell count mismatch"
    assert cells.min() >= 0 and cells.max() < cfg.num_cells

    black = v < cfg.black_thresh
    gray = ~black & (s < cfg.gray_thresh)
    color = ~black & ~gray
    assert (cells[black] == cfg.black_id).all(), "black pixels misrouted"
    # premature-int-cast quirk: all grays in the first gray cell
    assert (cells[gray] == cfg.gray_start).all(), "gray pixels misrouted"

    cc = cells[color]
    hi = cc // (cfg.s_partitions * cfg.v_partitions)
    si = (cc // cfg.v_partitions) % cfg.s_partitions
    vi = cc % cfg.v_partitions
    lh, ls, lv = cfg.cell_Lh, cfg.cell_Ls, cfg.cell_Lv
    eps = 1e-4
    hcol = h[color]
    assert (hcol >= hi * lh - eps).all() and \
        (hcol <= (hi + 1) * lh + eps).all(), "hue outside cell bounds"
    scol = s[color] - cfg.gray_thresh
    assert (scol >= si * ls - eps).all() and \
        (scol <= (si + 1) * ls + eps).all(), "saturation outside cell bounds"
    vcol = v[color] - cfg.black_thresh
    assert (vcol >= vi * lv - eps).all() and \
        (vcol <= (vi + 1) * lv + eps).all(), "value outside cell bounds"


def validate_parent_order(counts, order, cfg: ReportConfig) -> None:
    """Sorted saliencies must be non-increasing beyond the margin.

    The margin comparator tolerates inversions smaller than 1.0 saliency
    unit (reference validate_octree_parents checked plain monotonicity of
    the quantity sort; the exact sort admits bounded inversions by design).
    """
    geom = octree_geometry(cfg)
    counts = np.asarray(counts).astype(np.float32)
    sal = counts * (np.float32(cfg.quantity_weight)
                    + np.float32(cfg.saturation_value_weight)
                    * geom.s_v_f32) * np.float32(1000.0)
    so = sal[np.asarray(order)]
    inversions = so[1:] - so[:-1]
    assert (inversions < 1.0).all(), \
        f"sort inversion beyond margin: {inversions.max()}"


def report_color_palette(report) -> None:
    """Range checks on a host Report (reference report_color_palette)."""
    n = report.color_palette.N
    assert n >= 1
    total = 0.0
    for (hh, ss, vv), pct in zip(report.color_palette.hsv,
                                 report.color_palette.quantities):
        assert 0.0 <= hh <= 360.0, f"hue out of range: {hh}"
        assert 0.0 <= ss <= 1.0, f"saturation out of range: {ss}"
        assert 0.0 <= vv <= 1.0, f"value out of range: {vv}"
        assert 0.0 <= pct <= 1.0
        total += pct
    assert total <= 1.0 + 1e-4, f"percentages sum to {total}"


def verify_report(report) -> None:
    """Full-report sanity: finite stats, in-range fields, 10 vector slots."""
    rs = report.rgb_stats
    for name in ("Br", "Bg", "Bb", "Cr", "Cg", "Cb"):
        val = getattr(rs, name)
        assert np.isfinite(val), f"{name} not finite"
        assert -1e-6 <= val <= 1.0 + 1e-6
    assert 0.0 <= report.average_saturation <= 1.0
    assert len(report.blur_vectors) == 10
    for bv in report.blur_vectors:
        assert -90 <= bv.angle <= 90
        assert 0.0 <= bv.magnitude <= 1.0
    report_color_palette(report)


def create_test_rgb(height: int = 400, width: int = 400, seed: int = 0)\
        -> np.ndarray:
    """Synthetic (3, H, W) float32 RGB test image (reference
    create_test_rgb, src/debug.c:53)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    rgb = np.stack([
        0.5 + 0.4 * np.sin(x / 23.0),
        0.5 + 0.4 * np.cos(y / 17.0),
        0.5 + 0.3 * np.sin((x + y) / 31.0),
    ]).astype(np.float32)
    rgb += rng.normal(0, 0.02, rgb.shape).astype(np.float32)
    return np.clip(rgb, 0.0, 1.0)


class _NanCheck(TorchDispatchMode):
    """Raises FloatingPointError at the first operator whose floating
    output holds a NaN: an ATen operator, or a kernel's registered
    operator (``torch.ops.photohive.*``), which this mode sees as one
    call.  In an exported program (serving.load_report) it follows the
    branch each ``cond`` takes."""

    supports_higher_order_operators = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.higher_order.cond:
            pred, true_fn, false_fn, operands = args
            with self:
                return (true_fn if pred else false_fn)(*operands)
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_NAN_CHECK = []


def nan_checks(enable: bool = True) -> None:
    """Turn NaN detection on or off for the calling thread (the
    counterpart of ``jax_debug_nans``).

    With checks on, any NaN an operator produces raises at that operator,
    instead of surfacing as a scrubbed 0.0 in the report's NaN-tolerant
    fields.  It reads every floating output back, one device sync an
    operator: a debugging aid, not a serving mode.  The report's own
    ``torch.where`` guards compute masked-out quotients (an invalid crop
    box's 0/0, for one), so a report with boxes raises under it."""
    if enable and not _NAN_CHECK:
        mode = _NanCheck()
        mode.__enter__()
        _NAN_CHECK.append(mode)
    elif not enable and _NAN_CHECK:
        _NAN_CHECK.pop().__exit__(None, None, None)
