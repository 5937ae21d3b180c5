"""The 45.4 MP race-photo cell (``race_z9_45mp.device``): it resolves to
the device loop with its own metrics and no others; both of its frame
shapes lie outside the FFT kernels' gate; a small run of it at off-gate
shapes on the CPU comes out correct; the off-gate blur route's two
readers read None on a trace without the route's operator, as on a tree
without it, and the right numbers on one with it."""

import collections
import json
import math

import pytest

from photohive_dsp_tpu_torch.ops.fft_plan import fft_kernel_eligible
from portbench import roofline, run
from portbench.loops import Window
from portbench.spec import ROOT, load_cell
from portbench.trace import TraceView

from .helpers import small_root
from .test_portbench_metrics import Run, _event, read, synthetic_trace

CELL = "race_z9_45mp.device"
READERS = ("blur.spectrum_ms_per_image",
           "kernels.spectrum_bins_roofline_pct")
Z9 = [(5504, 8256), (8256, 5504)]


def config():
    return json.loads((ROOT / "portbench/configs/race_z9_45mp.json")
                      .read_text())


def test_the_cell_binds_exactly_its_metrics():
    cell = load_cell(CELL)
    assert cell.chips == 1
    assert cell.traffic == load_cell("corpus_mixed.device").traffic
    assert {m.name for m in cell.end_to_end} == {"throughput_mps", "setup_s"}
    assert {m.name for m in cell.per_layer} == {
        "device.idle_pct.throughput",
        "pipeline.launches_per_image.throughput",
        "pipeline.idle_ms_per_image.throughput",
        "stages.sync_wait_ms_per_image", "kernels.palette_roofline_pct",
        *READERS}
    assert [tuple(s) for s in cell.config["shapes"]] == Z9
    assert cell.config["reduced"] == ["chips", "frames"]
    assert cell.config["batch_size"] == 2 and cell.config["frames"] == 8
    upload = json.loads((ROOT / "portbench/configs/photo_1080p.json")
                        .read_text())
    for key in ("report_config", "boxes", "palette_kernel"):
        assert cell.config[key] == upload[key], key


def test_both_orientations_are_off_the_gate_and_boxes_take_k5():
    for h, w in Z9:
        assert not fft_kernel_eligible(h, w)
        for b in run.box_dicts(config()["boxes"], h, w):
            assert min(b["bottom"] - b["top"], b["right"] - b["left"]) >= 4


def test_small_run_is_correct(tmp_path):
    root = small_root(tmp_path)
    path = root / "portbench/configs/race_z9_45mp.json"
    cfg = json.loads(path.read_text())
    cfg.update(shapes=[[387, 516], [516, 387]], frames=4)
    path.write_text(json.dumps(cfg))
    out = run.run_cell(load_cell(CELL, root), 2**31 + 43, 0.5, False,
                       device="cpu")
    assert out["correct"], out["check"]
    # both positions of a batch of 2, however few batches the window ran
    assert out["check"]["sampled"]["value"] >= 2
    assert "throughput_mps" in out["metrics"]


@pytest.mark.parametrize("name", READERS)
def test_readers_read_none_without_the_route(name):
    shapes = collections.Counter({Z9[0]: 2})
    r = Run(Window(reports=2, shapes=shapes), trace=synthetic_trace(),
            config=config())
    assert read(name, r) is None
    assert read(name, Run(Window(reports=2, shapes=shapes), trace=None,
                          config=r.config)) is None


def spectrum_trace():
    """A 1000 us window: the operator (100 .. 700) launches a cuFFT kernel
    of 300 us, and inside it the polar operator launches the polar kernel
    (80 us) and its finish (20 us), which the outer operator owns; an aten
    kernel of 50 us launched outside it does not count."""
    ev = [
        _event("user_annotation", "portbench.window", 0, 1000),
        _event("cpu_op", "photohive::spectrum_bins", 100, 600),
        _event("cuda_runtime", "cudaLaunchKernel", 110, 5, correlation=1),
        _event("kernel", "regular_fft_factor_43", 150, 300, correlation=1),
        _event("cpu_op", "photohive::polar_lognorm", 280, 100),
        _event("cuda_runtime", "cudaLaunchKernel", 300, 5, correlation=2),
        _event("kernel", "polar_lognorm_kernel<true>", 450, 80,
               correlation=2),
        _event("cuda_runtime", "cudaLaunchKernel", 310, 5, correlation=4),
        _event("kernel", "polar_finish", 530, 20, correlation=4),
        _event("cpu_op", "aten::mul", 800, 10),
        _event("cuda_runtime", "cudaLaunchKernel", 802, 5, correlation=3),
        _event("kernel", "at::native::mul_kernel", 850, 50, correlation=3),
    ]
    return TraceView(ev)


def test_readers_on_a_trace_with_the_route():
    cfg = config()
    shapes = collections.Counter({Z9[0]: 1, Z9[1]: 1})
    r = Run(Window(reports=2, shapes=shapes), trace=spectrum_trace(),
            config=cfg)
    assert read("blur.spectrum_ms_per_image", r) == pytest.approx(0.2)
    least = 2 * roofline.blur_s(5504, 8256, 72, 40)
    assert roofline.blur_s(8256, 5504, 72, 40) == pytest.approx(
        roofline.blur_s(5504, 8256, 72, 40))
    assert read("kernels.spectrum_bins_roofline_pct", r) == \
        pytest.approx(100 * least / 400e-6)
    assert r.attribution == {
        "blur.spectrum_ms_per_image": "operator range",
        "kernels.spectrum_bins_roofline_pct": "operator range"}


def test_blur_bound_at_45_mp_by_hand():
    px = 8256 * 5504
    assert px == 45_441_024
    # the bytes bound: the float32 luma read once, 2880 bins written once
    nbytes = 4 * px + 4 * 72 * 40
    ops = 2.5 * px * math.log2(px) + 6 * 5504 * (8256 // 2 + 1)
    assert nbytes / 3.35e12 > ops / 67e12
    assert roofline.blur_s(5504, 8256, 72, 40) == pytest.approx(
        nbytes / 3.35e12)
