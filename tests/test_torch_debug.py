"""The port's invariant checkers (photohive_dsp_tpu_torch/utils/debug.py)
as tests/test_debug_and_4k.py:19,35 uses the JAX package's: they pass on a
valid report and catch a misrouted pixel.  And ``nan_checks``: it stops at
the operator that makes a NaN, a kernel's registered operator included,
also inside an exported program's ``cond``, and is silent when off."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch

from photohive_dsp_tpu.utils import debug as jdebug

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.ops import palette_kernels as tpk
from photohive_dsp_tpu_torch.ops import polar_kernels as tpol
from photohive_dsp_tpu_torch.ops import quantize as tq
from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv
from photohive_dsp_tpu_torch.ops.margin_sort import margin_sort
from photohive_dsp_tpu_torch.utils import debug

CFG = pt.ReportConfig()


def hsv_cells(img: np.ndarray):
    h, s, v = rgb_to_hsv(*(torch.from_numpy(c) for c in img))
    return h, s, v, tq.assign_cells(h, s, v, CFG)


def test_create_test_rgb_is_the_jax_packages():
    assert np.array_equal(debug.create_test_rgb(40, 52, seed=3),
                          jdebug.create_test_rgb(40, 52, seed=3))


def test_invariant_checkers_pass_on_valid_report():
    img = debug.create_test_rgb(400, 420)
    h, s, v, cells = hsv_cells(img)
    debug.verify_cell_assignment(h, s, v, cells, CFG)
    counts = tpk.cell_counts_batched(cells.reshape(1, -1), CFG.num_cells)
    sal = tq.saliency_f32(counts, tq.OctreeTables.for_config(CFG).s_v_f32,
                          CFG)
    debug.validate_parent_order(counts[0], margin_sort(sal)[0], CFG)

    img8 = np.moveaxis((img * 255).round(), 0, -1).astype(np.uint8)
    debug.verify_report(pt.get_report(img8, device="cpu"))


def test_invariant_checkers_catch_corruption():
    img = debug.create_test_rgb(400, 400)
    h, s, v, cells = hsv_cells(img)
    bad = cells.numpy().copy()
    bad[0, 0] = (bad[0, 0] + 1) % CFG.num_cells  # misroute one pixel
    with pytest.raises(AssertionError):
        debug.verify_cell_assignment(h, s, v, bad, CFG)


def test_nan_checks_stop_at_the_kernel_operator():
    mag2 = torch.tensor([[1.0, float("nan"), 4.0]])
    ids = torch.tensor([0, 1, 1], dtype=torch.int32)
    debug.nan_checks(True)
    try:
        with pytest.raises(FloatingPointError, match="photohive.polar"):
            tpol.polar_bin_sums_lognorm(mag2, ids, 2)
    finally:
        debug.nan_checks(False)
    _, mx = tpol.polar_bin_sums_lognorm(mag2, ids, 2)   # silent when off
    assert bool(torch.isnan(mx).all())


def test_nan_checks_follow_an_exported_cond():
    class Program(torch.nn.Module):
        def forward(self, x, p):
            return torch.cond(p.any(), lambda x: x / x, lambda x: x + 1,
                              (x,))

    fn = torch.export.export(Program(), (torch.ones(3),
                                         torch.tensor([True]))).module()
    zero, yes, no = torch.zeros(3), torch.tensor([True]), torch.tensor([False])
    debug.nan_checks(True)
    try:
        assert torch.equal(fn(zero, no), torch.ones(3))
        with pytest.raises(FloatingPointError, match="div"):
            fn(zero, yes)
    finally:
        debug.nan_checks(False)
    assert bool(torch.isnan(fn(zero, yes)).all())
