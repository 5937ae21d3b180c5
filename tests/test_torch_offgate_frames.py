"""Frames whose sides fall outside the FFT kernels' gate
(``fft_plan.fft_kernel_eligible``), as the 8256 x 5504 frames of 45.4 MP
bodies do (both sides carry the prime 43), here at (387, 516) and its
portrait, whose sides carry 43 too: their blur route is the operator
``photohive::spectrum_bins``, bit-equal to torch's |X|^2 binned by the
polar kernel (K7+K8) and within float32 rounding of the JAX package's
gather route; ``get_report`` meets the benchmark's plain reference
(``portbench/reference``) under ``portbench/limits.json``; the operator's
range opens once a batch inside the blur stage's span at those shapes and
never at an on-gate one; the report tables hold no gather table; the
serving artifact traces through the operator's fake.  On the card the
single-image graph route captures the operator (cuFFT and K7+K8
included) and replays it bit for bit."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import io
import json

import numpy as np
import pytest
import torch

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.models import pipeline
from photohive_dsp_tpu_torch.ops import _cuda
from photohive_dsp_tpu_torch.ops.blur import (PolarTables, blur_profile_bins,
                                             lognorm_bin_means)
from photohive_dsp_tpu_torch.ops.fft import (magnitude_fft,
                                            magnitude_fft_normalized)
from photohive_dsp_tpu_torch.ops.fft_plan import fft_kernel_eligible
from photohive_dsp_tpu_torch.serving import export_report, load_report
from photohive_dsp_tpu_torch.utils import profiling
from portbench import check, frames, run
from portbench.reference.report import Reference
from portbench.spec import ROOT

CONFIG = json.loads((ROOT / "portbench/configs/race_z9_45mp.json")
                    .read_text())
RC = CONFIG["report_config"]
CFG = pt.ReportConfig(**RC)
# 387 = 3^2 * 43 and 516 = 2^2 * 3 * 43: the Z9's factor 43 on both sides.
OFF_GATE = [(387, 516), (516, 387)]
ON_GATE = (384, 512)
STAGE = "photohive.stage.blur"
OP = "photohive::spectrum_bins"
# The polar kernel's exact fixed-point sums against the gather's float32
# row sums: a few ulps of each bin.
GATHER_RTOL = 2e-6


def luma(b, h, w, seed):
    gen = torch.Generator().manual_seed(seed)
    pgm = torch.rand((b, h, w), generator=gen)
    return pgm - pgm.mean(dim=(1, 2), keepdim=True)


def boxes_for(h, w):
    return run.box_dicts(CONFIG["boxes"], h, w)


def test_the_full_size_frames_are_off_the_gate():
    for h, w in CONFIG["shapes"]:
        assert not fft_kernel_eligible(h, w)
    for h, w in OFF_GATE:
        assert not fft_kernel_eligible(h, w)
    assert fft_kernel_eligible(*ON_GATE)


def op_bins(x, polar):
    return torch.ops.photohive.spectrum_bins(
        x, polar.bin_ids, polar.bin_counts, CFG.angle_partitions,
        CFG.radius_partitions)


def route_bins(x, polar):
    """What the operator composes: torch's |X|^2, then K7+K8."""
    mag2 = magnitude_fft(x)
    return lognorm_bin_means(mag2.reshape(mag2.shape[0], -1), polar,
                             CFG.angle_partitions, CFG.radius_partitions)


@pytest.mark.parametrize("shape", OFF_GATE, ids=str)
def test_operator_is_the_fft_and_the_polar_kernel(shape):
    """Bit-equal to what it composes, and within a few ulps a bin of the
    JAX package's gather route (normalised spectrum, padded gather)."""
    polar = PolarTables.for_shape(*shape, CFG, gather=True)
    x = luma(2, *shape, seed=3)
    got = op_bins(x, polar)
    assert got.dtype == torch.float32
    assert got.shape == (2, CFG.angle_partitions, CFG.radius_partitions)
    assert torch.equal(got, route_bins(x, polar))
    assert not torch.equal(got[0], got[1])
    gather = blur_profile_bins(magnitude_fft_normalized(x), polar,
                               CFG.angle_partitions, CFG.radius_partitions)
    assert torch.equal(got == 0, gather == 0)
    assert bool(((got - gather).abs() <= GATHER_RTOL * gather.abs()).all())


def test_report_tables_hold_no_gather_table():
    tables = pipeline.ReportTables.build(*OFF_GATE[0], CFG)
    assert tables.polar.pad_index is None
    assert tables.polar.bin_ids.dtype == torch.int32
    assert PolarTables.for_shape(*OFF_GATE[0], CFG,
                                 gather=True).pad_index is not None


@pytest.mark.parametrize("shape", OFF_GATE, ids=str)
def test_get_report_meets_the_reference(shape):
    h, w = shape
    ref = Reference(RC, "cpu")
    limits = check.limits()
    boxes = boxes_for(h, w)
    for frame in frames.frames(2**31 + 43, [shape], 2, "cpu",
                               CONFIG["camera_shake"]):
        rep = pt.get_report(frame, pt.set_bounding_boxes(boxes), config=CFG,
                            device="cpu")
        want = ref.report(frame, [(b["top"], b["bottom"], b["left"],
                                   b["right"]) for b in boxes])
        got = check.from_report(rep, rep.to_json(), len(boxes))
        gaps = check.gaps(got, want, h * w, RC)
        assert set(gaps) == set(limits)
        for name, value in gaps.items():
            assert value <= limits[name], (name, value)
        assert np.any(got["blur_bins"] != 0)


def ranges(events, name):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("name") == name and e.get("ph") == "X"]


@pytest.mark.parametrize("shape, batches", [
    (OFF_GATE[0], 2), (OFF_GATE[1], 1), (ON_GATE, 0)], ids=str)
def test_operator_range_once_a_batch_inside_the_blur_stage(
        tmp_path, shape, batches):
    tables = pipeline.ReportTables.build(*shape, CFG)
    rng = np.random.default_rng(5)
    sizes = (2, 1) if batches != 1 else (2,)
    with profiling.trace(str(tmp_path)):
        for b in sizes:
            u8 = torch.from_numpy(rng.integers(0, 256, (b, 3, *shape),
                                               dtype=np.uint8))
            pt.full_report_batched(u8, np.zeros((b, 10, 4), np.int32),
                                   np.zeros((b, 10), bool), tables, CFG)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ops, stages = ranges(events, OP), ranges(events, STAGE)
    assert len(stages) == len(sizes)
    if not batches:
        assert ops == []
        assert len(ranges(events, "photohive::fft_rows")) == len(sizes)
        return
    assert len(ops) == batches
    polar = ranges(events, "photohive::polar_lognorm")
    assert len(polar) == batches
    eps = 0.01      # us: the Chrome trace's rounding
    for stage, op, inner in zip(stages, ops, polar):
        assert stage[0] - eps <= op[0] and op[1] <= stage[1] + eps
        assert op[0] - eps <= inner[0] and inner[1] <= op[1] + eps


def test_serving_artifact_traces_through_the_operator():
    h, w = OFF_GATE[0]
    blob = export_report(h, w, CFG, batch_size="dynamic", device="cpu")
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("photohive.spectrum_bins.default") == 1
    assert not [t for t in targets if "fft" in t]
    u8 = np.random.default_rng(8).integers(0, 256, (2, h, w, 3),
                                           dtype=np.uint8)
    boxes, valid = (torch.from_numpy(np.stack([a, a])) for a in
                    pt.set_bounding_boxes(boxes_for(h, w)))
    got = load_report(blob)(torch.from_numpy(u8), boxes, valid)
    want = pt.full_report_batched(
        torch.from_numpy(u8).permute(0, 3, 1, 2).contiguous(), boxes, valid,
        pt.ReportTables.build(h, w, CFG, "cpu"), CFG)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", OFF_GATE + [tuple(s) for s in
                                              CONFIG["shapes"]], ids=str)
def test_cuda_graph_route_equals_the_batch_path_bit_for_bit(shape):
    """On the card the operator equals what it composes (cuFFT's |X|^2
    and K7+K8), and get_report (the single-image graph route: eager,
    capture and replay, then a replay) equals full_report_batched, every
    field; every blur runs K7+K8 once and no FFT kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: cuFFT and the graph route")
    h, w = shape
    dev = pipeline.resolve_device("cuda")
    tables = pipeline.cached_tables(h, w, CFG, dev)
    assert tables.polar.pad_index is None
    x = luma(2, h, w, seed=9).to(dev)
    _cuda.reset_launch_counts()
    assert torch.equal(op_bins(x, tables.polar), route_bins(x, tables.polar))
    del x
    boxes = pt.set_bounding_boxes(boxes_for(h, w))
    gen = frames.generator(2**31 + 45, dev)
    for call in range(4):
        frame = frames.photo(gen, h, w, CONFIG["camera_shake"])
        rgb = frame.permute(2, 0, 1).contiguous()
        got = pipeline.full_report(rgb, *boxes, tables, CFG)
        want = pt.full_report_batched(rgb[None], boxes[0][None],
                                      boxes[1][None], tables, CFG)
        for name, a, b in zip(want._fields, got, want):
            assert torch.equal(a, b[0]), (call, name)
        rep = pt.get_report(frame.cpu().numpy(), boxes, config=CFG,
                            device="cuda")
        assert rep.to_json() == pt.Report(
            pipeline.ReportData(*(f[0] for f in want)), h, w,
            len(boxes_for(h, w)), CFG).to_json(), call
    assert _cuda.LAUNCHES["report_graph_captures"] >= 1
    # the two direct calls, then 3 reports a call
    assert _cuda.LAUNCHES["polar_bins"] == 2 + 3 * 4
    assert _cuda.LAUNCHES["fft_rows"] == _cuda.LAUNCHES["fft_cols"] == 0
