"""The port's row-sharded report at 2 gloo ranks against the port's own
single-device CPU path, on the cases of tests/test_torch_spatial.py: the
palette, its counts and mean saturation are equal bit for bit (the ranks
add the kernels' fixed-point accumulators before converting them), the
rest meets tests/test_sharding.py's bars."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import photohive_dsp_tpu_torch as pt

from .test_sharding import _assert_reports_match
from .test_torch_spatial import SPATIAL_CASES, _assert_replicated, \
    _case_inputs
from .torch_spatial_ranks import run_ranks


@pytest.mark.parametrize("name", list(SPATIAL_CASES))
def test_spatial_report_2_ranks_matches_single_device(name, tmp_path):
    """Palette ids, counts, percentages, averages and mean saturation equal
    the single-device path's bit for bit; the rest at the sharded bars."""
    img, boxes, valid, cfg = _case_inputs(name)
    h, w = img.shape[1:]
    reports = run_ranks(2, tmp_path, cfg, img, boxes, valid)
    _assert_replicated(reports)
    ours = reports[0]
    ref = pt.full_report_batched(torch.from_numpy(img)[None], boxes[None],
                                 valid[None], pt.ReportTables.build(h, w, cfg),
                                 cfg)
    ref = {k: v[0].numpy() for k, v in ref._asdict().items()}
    for k in ("palette_n", "palette_ids", "palette_pct", "palette_hsv",
              "average_saturation"):
        assert np.array_equal(ours[k], ref[k]), k
    _assert_reports_match(SimpleNamespace(**ref), SimpleNamespace(**ours))
