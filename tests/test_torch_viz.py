"""The PyTorch port's visualisations (utils/viz.py and Report's generate_*
methods) against the JAX package's, as tests/test_viz.py holds those: both
packages draw from the same report's values (a JAX ``Report`` built from
the port's ReportData), and the images must be pixel-equal (the
frequency-response plot: the same size and mode).  Host-side, no display
needed."""

from . import torch_threads  # noqa: F401 (this worker's cores)

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.models import pipeline as jpipe
from photohive_dsp_tpu.utils import viz as jviz

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.models import pipeline as tpipe
from photohive_dsp_tpu_torch.utils import viz

from .util import structured_image

H, W = 400, 520
BOXES = [dict(top=40, bottom=200, left=60, right=300)]


@pytest.fixture(scope="module")
def reports():
    """(the port's Report, a JAX Report of the same values, the frame, the
    boxes)."""
    img8 = np.moveaxis((structured_image(H, W, seed=9) * 255).round(), 0,
                       -1).astype(np.uint8)
    boxes = pt.set_bounding_boxes(BOXES)
    cfg = pt.ReportConfig()
    fn, tables = tpipe.jitted_full_report(H, W, cfg, device="cpu")
    data = fn(torch.from_numpy(np.ascontiguousarray(np.moveaxis(img8, -1,
                                                                0))),
              *boxes, tables)
    rep = pt.Report(data, H, W, num_boxes=len(BOXES), config=cfg)
    assert rep.to_dict() == pt.get_report(img8, boxes,
                                          device="cpu").to_dict()
    jrep = ph.Report(jpipe.ReportData(*(x.numpy() for x in data)), H, W,
                     num_boxes=len(BOXES), config=ph.ReportConfig())
    return rep, jrep, img8, boxes


def same_pixels(a, b) -> bool:
    return a.size == b.size and a.mode == b.mode and \
        np.array_equal(np.asarray(a), np.asarray(b))


def test_palette_image(reports):
    rep, jrep, _, _ = reports
    img = rep.generate_color_palette_image()
    n = len(rep.color_palette.colors)
    per_row = int(np.ceil(np.sqrt(n)))
    assert img.width == per_row * 50
    # the first block is the top palette colour
    r, _, _ = rep.color_palette.colors[0]
    assert abs(int(np.asarray(img)[10, 10][0]) - r) <= 1
    assert rep.color_palette_image is img
    assert same_pixels(img, jrep.generate_color_palette_image())
    assert same_pixels(viz.palette_image([(10, 200, 30)], [1.0], 20),
                       jviz.palette_image([(10, 200, 30)], [1.0], 20))


def test_blur_profile_visual_semantics(reports):
    rep, jrep, _, _ = reports
    bins = np.asarray(rep.blur_profile.bins)
    vis = viz.blur_profile_visual(bins, H, W)
    assert vis.shape == (H, W // 2)
    # corner (0, 0): r = 0, phi = 0 -> phi_bin (A-1)/2 truncated, r_bin 0
    a = bins.shape[0]
    phi_bin = int((0 + 3.14159265 * 0.5) / 3.14159265 * (a - 1))
    assert vis[0, 0] == bins[phi_bin, 0]
    assert np.array_equal(vis, jviz.blur_profile_visual(bins, H, W))
    # odd sizes reach the C integer division under the sqrt
    assert np.array_equal(viz.blur_profile_visual(bins, 361, 517),
                          jviz.blur_profile_visual(bins, 361, 517))
    img = rep.generate_blur_profile_image()
    assert img.size == (W // 2, H)
    assert same_pixels(img, jrep.generate_blur_profile_image())


def test_frequency_response_plot(reports):
    rep, _, _, _ = reports
    bins = np.asarray(rep.blur_profile.bins)
    vectors = [SimpleNamespace(angle=35, magnitude=0.4), (-60, 0.2),
               SimpleNamespace(angle=10, magnitude=0.0)]
    img = viz.frequency_response_plot(vectors, bins, 0.3, 1.2, 2)
    want = jviz.frequency_response_plot(vectors, bins, 0.3, 1.2, 2)
    assert img.width > 100 and img.height > 100
    assert (img.size, img.mode) == (want.size, want.mode)


def test_generate_blur_direction_frequency_response(reports):
    rep, jrep, _, _ = reports
    img = rep.generate_blur_direction_frequency_response()
    want = jrep.generate_blur_direction_frequency_response()
    assert rep.blur_vector_plot is img
    assert (img.size, img.mode) == (want.size, want.mode)


def test_report_card(reports):
    rep, jrep, img8, boxes = reports
    card = rep.generate_report_card(image=img8, bounding_boxes=boxes)
    assert card.width > img8.shape[1]
    assert card.height >= img8.shape[0]
    assert same_pixels(card, jrep.generate_report_card(image=img8,
                                                       bounding_boxes=boxes))
    # duck-typed: the port's report_card draws a JAX Report the same way
    assert same_pixels(viz.report_card(jrep, image=img8,
                                       bounding_boxes=boxes), card)
    planar = np.moveaxis(img8, -1, 0).astype(np.float32) / 255
    assert same_pixels(viz.report_card(rep, image=planar),
                       jviz.report_card(rep, image=planar))
    assert same_pixels(viz.report_card(rep), jviz.report_card(rep))


def test_report_has_every_visualisation_method():
    names = [m for m in vars(ph.Report)
             if m.startswith(("generate_", "display_"))]
    assert len(names) == 7
    for m in names:
        assert callable(getattr(pt.Report, m)), m
