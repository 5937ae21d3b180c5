"""The serving artifact (photohive_dsp_tpu_torch/serving.py) with a crop
box under TINY_BOX_PX, on the CPU: its masked sharpness branch is the one
operator ``photohive::masked_sharpness``, and its report equals the live
``full_report_batched``'s bit for bit."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import io

import numpy as np
import torch

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.ops import _cuda
from photohive_dsp_tpu_torch.serving import export_report, load_report

H, W = 360, 480
CFG = pt.ReportConfig()


def test_thin_box_artifact_equals_live_path():
    blob = export_report(H, W, CFG, batch_size=1, device="cpu")
    program = torch.export.load(io.BytesIO(blob))
    graphs = [[str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
              for gm in program.graph_module.modules()
              if isinstance(gm, torch.fx.GraphModule)]
    (branch,) = [g for g in graphs
                 if "photohive.masked_sharpness.default" in g]
    # The branch holds the boxes' copies and the operator, none of the
    # route's per-slot arithmetic.
    assert branch[-1] == "photohive.masked_sharpness.default"
    assert not [t for t in branch if "arange" in t or "pad" in t]
    assert len(branch) < 12

    u8 = np.random.default_rng(6).integers(0, 256, (1, H, W, 3),
                                           dtype=np.uint8)
    boxes, valid = pt.set_bounding_boxes([
        dict(top=20, bottom=200, left=30, right=300),
        dict(top=180, bottom=182, left=24, right=360)])     # 2 px
    boxes, valid = (torch.from_numpy(a[None]) for a in (boxes, valid))
    _cuda.reset_launch_counts()
    got = load_report(blob)(torch.from_numpy(u8), boxes, valid)
    assert _cuda.LAUNCHES["masked_sharpness"] == 1
    want = pt.full_report_batched(
        torch.from_numpy(u8).permute(0, 3, 1, 2).contiguous(), boxes, valid,
        pt.ReportTables.build(H, W, CFG, "cpu"), CFG)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
    assert bool((got.sharpness[0, :2] != 0).all())
