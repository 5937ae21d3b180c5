"""The masked sharpness route on the CPU: uploads whose crop boxes include
one under TINY_BOX_PX, held by ``get_report`` to the benchmark's plain
reference (``portbench/reference``) under ``portbench/limits.json``; the
route taken only through its operator ``photohive::masked_sharpness``,
which counts its images, equals ``_masked_sharpness`` bit for bit (on the
card too, where it replays a CUDA graph), and runs inside its span."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.ops import _cuda
from photohive_dsp_tpu_torch.ops import sharpness as sh
from photohive_dsp_tpu_torch.utils import profiling
from portbench import check, frames
from portbench.reference.report import Reference
from portbench.spec import ROOT

H, W = 360, 512
RC = json.loads((ROOT / "portbench/configs/photo_1080p_thin_box.json")
                .read_text())["report_config"]
CFG = pt.ReportConfig(**RC)
# Two boxes of K5's size (the upload cell's first two at this shape).
K5 = [dict(top=H // 10, bottom=H * 2 // 3, left=W // 10, right=W * 5 // 8),
      dict(top=H * 3 // 10, bottom=H * 5 // 6, left=W // 2, right=W - 20)]
BOX_SETS = {
    "strip": K5 + [dict(top=H // 2, bottom=H // 2 + 2, left=W // 20,
                        right=W * 3 // 4)],
    "right_edge_column": K5[:1] + [dict(top=40, bottom=300, left=W - 1,
                                        right=W)],
    "top_row": [dict(top=0, bottom=3, left=100, right=400)],
}


@pytest.fixture(scope="module")
def photos():
    return frames.frames(2**31 + 21, [(H, W)], 2, "cpu")


class PhotohiveOps(TorchDispatchMode):
    """The ``photohive::`` operators a block calls."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name.startswith("photohive."):
            self.seen.append(name.split(".", 1)[1])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("box_set", list(BOX_SETS))
def test_thin_box_reports_meet_the_reference(photos, box_set):
    boxes = BOX_SETS[box_set]
    ref = Reference(RC, "cpu")
    limits = check.limits()
    for frame in photos:
        _cuda.reset_launch_counts()
        with PhotohiveOps() as ops:
            rep = pt.get_report(frame, pt.set_bounding_boxes(boxes),
                                config=CFG, device="cpu")
        assert "masked_sharpness" in ops.seen
        assert "sharpness_sums" not in ops.seen
        assert _cuda.LAUNCHES["masked_sharpness"] == 1
        want = ref.report(frame, [(b["top"], b["bottom"], b["left"],
                                   b["right"]) for b in boxes])
        got = check.from_report(rep, rep.to_json(), len(boxes))
        gaps = check.gaps(got, want, H * W, RC)
        assert set(gaps) == set(limits)
        for name, value in gaps.items():
            assert value <= limits[name], (name, value)
        assert np.all(got["sharpness"] != 0)


def slots(*boxes):
    """(2, 10, 4) boxes and (2, 10) validity: (box, valid) pairs in the
    first slots of both images."""
    bx = np.zeros((2, 10, 4), np.int32)
    ok = np.zeros((2, 10), bool)
    for k, (box, valid) in enumerate(boxes):
        bx[:, k], ok[:, k] = box, valid
    return bx, ok


BIG, THIN = (10, 50, 10, 60), (20, 22, 5, 55)


@pytest.mark.parametrize("boxes, images, op", [
    (slots(), 0, None),
    (slots((BIG, True)), 0, "sharpness_sums"),
    (slots((BIG, True), (THIN, False)), 0, "sharpness_sums"),
    (slots((BIG, True), (THIN, True)), 2, "masked_sharpness"),
    (slots((THIN, True)), 2, "masked_sharpness"),
])
def test_route_counter_counts_images_on_the_masked_route(boxes, images, op):
    pgm = torch.rand((2, 64, 80), generator=torch.Generator().manual_seed(4))
    _cuda.reset_launch_counts()
    with PhotohiveOps() as ops:
        sh.variance_sharpness_batched(pgm, *boxes)
    assert _cuda.LAUNCHES["masked_sharpness"] == images
    assert ops.seen == ([op] if op else [])
    assert _cuda.LAUNCHES["sharpness_sums"] == 0
    _cuda.reset_launch_counts()
    assert _cuda.LAUNCHES["masked_sharpness"] == 0


def test_operator_equals_masked_sharpness_bit_for_bit():
    gen = torch.Generator().manual_seed(7)
    pgm = torch.rand((3, 90, 120), generator=gen) * 0.9 + 0.05
    boxes = torch.zeros((3, 10, 4), dtype=torch.int32)
    valid = torch.zeros((3, 10), dtype=torch.bool)
    for k, box in enumerate([(0, 2, 0, 120), (40, 41, 3, 90),
                             (10, 80, 119, 120), (5, 60, 7, 100),
                             (87, 90, 30, 33)]):
        boxes[:, k] = torch.tensor(box)
        valid[:, k] = True
    valid[1, 3] = valid[2, 0] = False
    got = torch.ops.photohive.masked_sharpness(pgm, boxes, valid)
    want = sh._masked_sharpness(pgm, boxes, valid)
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    assert torch.equal(got, want)
    assert bool((got[valid] != 0).all()) and bool((got[~valid] == 0).all())


def test_masked_span_holds_the_operator_inside_the_sharpness_stage(
        tmp_path, photos):
    with profiling.trace(str(tmp_path)):
        pt.get_report(photos[0], pt.set_bounding_boxes(BOX_SETS["strip"]),
                      config=CFG, device="cpu")
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]

    def ranges(name):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e.get("name") == name
                and e.get("ph") == "X"]

    (stage,) = ranges("photohive.stage.sharpness")
    (masked,) = ranges("photohive.stage.sharpness.masked")
    (op,) = ranges("photohive::masked_sharpness")
    eps = 0.01      # us: the Chrome trace's rounding
    assert stage[0] - eps <= masked[0] and masked[1] <= stage[1] + eps
    assert masked[0] - eps <= op[0] and op[1] <= masked[1] + eps


@pytest.mark.cuda
def test_cuda_graph_replays_equal_the_eager_route_bit_for_bit(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the route's CUDA graph")
    monkeypatch.setattr(sh, "MASKED_GRAPHS", 2)
    monkeypatch.setattr(sh, "_graphs", type(sh._graphs)())
    gen = torch.Generator().manual_seed(11)
    boxes = torch.zeros((2, 10, 4), dtype=torch.int32)
    valid = torch.zeros((2, 10), dtype=torch.bool)
    for k, box in enumerate([(0, 2, 0, 120), (5, 60, 7, 100)]):
        boxes[:, k], valid[:, k] = torch.tensor(box), True
    _cuda.reset_launch_counts()
    for call in range(4):   # eager, capture and replay, then replays
        pgm = (torch.rand((2, 90, 120), generator=gen) + 0.05).cuda()
        bx, ok = boxes.cuda(), valid.cuda()
        bx[1, 0, 1] = 2 + call
        got = torch.ops.photohive.masked_sharpness(pgm, bx, ok)
        assert torch.equal(got, sh._masked_sharpness(pgm, bx, ok)), call
    assert _cuda.LAUNCHES["masked_sharpness"] == 8
    assert isinstance(list(sh._graphs.values())[0], sh._MaskedGraph)
    for h in (40, 50):      # two more shapes drop the first graph
        pgm = torch.rand((2, h, 120), device="cuda") + 0.05
        torch.ops.photohive.masked_sharpness(pgm, bx, ok)
    assert len(sh._graphs) == 2 and None in sh._graphs.values()
