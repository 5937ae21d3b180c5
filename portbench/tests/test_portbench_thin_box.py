"""The thin-box upload cell (``photo_1080p_thin_box.upload``): it resolves
with the upload cell's frame and settings and a 2 px third box; a small
run of it on the CPU comes out correct; the masked route's roofline
matches a hand count; its three readers read None on a trace without the
route's operator and span, as on a tree without them, and the right
numbers on one with them."""

import collections
import json

import pytest

from portbench import roofline, roofline_sharpness, run
from portbench.loops import Window
from portbench.spec import ROOT, load_cell
from portbench.trace import TraceView

from .helpers import small_root
from .test_portbench_metrics import Run, _event, read, synthetic_trace

CELL = "photo_1080p_thin_box.upload"
READERS = ("sharpness.masked_ms_per_image",
           "sharpness.masked_idle_ms_per_image",
           "kernels.masked_sharpness_roofline_pct")


def config(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())


def test_the_cell_resolves_to_the_upload_cell_with_a_thin_third_box():
    cell = load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["loop"] == "closed_loop"
    assert cell.traffic == load_cell("photo_1080p.upload").traffic
    assert {m.name for m in cell.end_to_end} == {
        "latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert {m.name for m in cell.per_layer} == {
        "pipeline.launches_per_image.latency",
        "pipeline.idle_ms_per_image.latency", "device.idle_pct.latency",
        *READERS}
    upload = config("photo_1080p")
    for key in ("report_config", "palette_kernel", "shapes", "frames"):
        assert cell.config[key] == upload[key], key
    assert cell.config["reduced"] == []
    assert cell.config["boxes"][:2] == upload["boxes"][:2]
    boxes = run.box_dicts(cell.config["boxes"], 1080, 1920)
    assert boxes[2] == dict(top=540, bottom=542, left=96, right=1440)
    assert [b["bottom"] - b["top"] < 4 or b["right"] - b["left"] < 4
            for b in boxes] == [False, False, True]


def test_small_run_is_correct(tmp_path):
    root = small_root(tmp_path)
    path = root / "portbench/configs/photo_1080p_thin_box.json"
    cfg = json.loads(path.read_text())
    cfg.update(shapes=[[360, 512]], frames=2)
    path.write_text(json.dumps(cfg))
    out = run.run_cell(load_cell(CELL, root), 2**31 + 91, 0.5, False,
                       device="cpu")
    assert out["correct"], out["check"]
    assert out["check"]["sharpness_rel"]["value"] <= \
        out["check"]["sharpness_rel"]["limit"]


def test_roofline_matches_a_hand_count_for_one_frame():
    spec = config("photo_1080p_thin_box")["boxes"]
    # [108, 720) x [192, 1200), [324, 900) x [960, 1900), [540, 542) x
    # [96, 1440) at 1080x1920
    px = 612 * 1008 + 576 * 940 + 2 * 1344
    assert px == 1_161_024
    want = max((4 * px + 3 * 4) / 3.35e12, 20 * px / 67e12)   # bytes bound
    assert roofline_sharpness.masked_sharpness_s(spec, 1080, 1920) == \
        pytest.approx(want)
    assert roofline_sharpness.masked_sharpness_s(spec, 1080, 1920) == \
        roofline.bound_s(4 * px + 12, 20 * px)
    # A box past the frame's edge counts the pixels inside it.
    assert roofline_sharpness.crop_px(
        dict(top=-2, bottom=3, left=10, right=30), 2, 20) == 2 * 10


@pytest.mark.parametrize("name", READERS)
def test_readers_read_none_without_the_route(name):
    run_ = Run(Window(reports=2, shapes=collections.Counter({(1080, 1920):
                                                             2})),
               trace=synthetic_trace(), config=config("photo_1080p_thin_box"))
    assert read(name, run_) is None
    assert read(name, Run(Window(reports=2), trace=None,
                          config=run_.config)) is None


def masked_trace():
    """A 1000 us window: the masked span (100 .. 700) holding the operator
    (110 .. 690), which launches two kernels of 200 and 100 us; the device
    idles 0 .. 150, 350 .. 500 and 600 .. 1000."""
    ev = [
        _event("user_annotation", "portbench.window", 0, 1000),
        _event("user_annotation", "photohive.stage.sharpness", 90, 620),
        _event("user_annotation", "photohive.stage.sharpness.masked", 100,
               600),
        _event("cpu_op", "photohive::masked_sharpness", 110, 580),
        _event("cuda_runtime", "cudaLaunchKernel", 120, 5, correlation=1),
        _event("kernel", "at::native::vectorized_elementwise_kernel", 150,
               200, correlation=1),
        _event("cuda_runtime", "cudaLaunchKernel", 400, 5, correlation=2),
        _event("kernel", "at::native::reduce_kernel", 500, 100,
               correlation=2),
    ]
    return TraceView(ev)


def test_readers_on_a_trace_with_the_route():
    cfg = config("photo_1080p_thin_box")
    r = Run(Window(reports=2, shapes=collections.Counter({(1080, 1920): 2})),
            trace=masked_trace(), config=cfg)
    assert read("sharpness.masked_ms_per_image", r) == pytest.approx(0.15)
    # idle inside the span: 100 .. 150, 350 .. 500, 600 .. 700 = 300 us
    assert read("sharpness.masked_idle_ms_per_image", r) == \
        pytest.approx(0.15)
    least = 2 * roofline_sharpness.masked_sharpness_s(cfg["boxes"], 1080,
                                                      1920)
    assert read("kernels.masked_sharpness_roofline_pct", r) == \
        pytest.approx(100 * least / 300e-6)
    assert r.attribution == {
        "sharpness.masked_ms_per_image": "operator range",
        "kernels.masked_sharpness_roofline_pct": "operator range"}
