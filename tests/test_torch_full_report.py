"""The single-image API of the PyTorch port against the JAX package on the
CPU: full_report and jitted_full_report on the 360x512 frames of
test_torch_pipeline.py (float32 planes in [0, 1]), with and without crop
boxes (one set with a thin box), at the port's acceptance bars; full_report
against full_report_batched at B=1 bit for bit; empty_boxes and the public
names."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.models import pipeline as jpipe

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.models import pipeline as tpipe

from .test_torch_pipeline import BOXES, H, IMAGES, THIN, W, assert_match

# Flat frames are left out: their palettes sit on cell edges, where XLA's
# reciprocal-multiply cell ids and IEEE division part (ROADMAP Queue 3).
CASES = [("noise", None), ("noise", BOXES), ("structured", BOXES),
         ("structured", THIN)]
IDS = ["noise", "noise_boxes", "structured_boxes", "structured_thin_box"]


def planar_f32(name: str) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(IMAGES[name], -1, 0)).astype(
        np.float32) / np.float32(255)


def box_arrays(boxes):
    if boxes is None:
        return tuple(t.numpy() for t in tpipe.empty_boxes())
    return pt.set_bounding_boxes(boxes)


def fields(data) -> dict:
    """One unbatched report's values, as assert_match compares them."""
    row = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
           for k, v in data._asdict().items()}
    n = int(row["palette_n"])
    return dict(row, palette_n=n, palette_ids=row["palette_ids"][:n],
                palette_pct=row["palette_pct"][:n],
                palette_hsv=row["palette_hsv"][:n])


@pytest.fixture(scope="module")
def jax_report():
    """The JAX package's compiled single-image report (one compile)."""
    return jpipe.jitted_full_report(H, W, ph.ReportConfig())


@pytest.mark.parametrize("name,boxes", CASES, ids=IDS)
def test_full_report_matches_jax(name, boxes, jax_report):
    rgb = planar_f32(name)
    bx, vd = box_arrays(boxes)
    jfn, jtables = jax_report
    want = jfn(jnp.asarray(rgb), jnp.asarray(bx), jnp.asarray(vd), jtables)
    fn, tables = tpipe.jitted_full_report(H, W, pt.ReportConfig(),
                                          device="cpu")
    got = fn(torch.from_numpy(rgb), bx, vd, tables)
    assert_match(fields(got), fields(want))
    assert got.sharpness.shape == (10,)
    assert got.blur_bins.shape == (72, 40)


@pytest.mark.parametrize("name,boxes", CASES, ids=IDS)
def test_full_report_is_batched_at_b1(name, boxes):
    cfg = pt.ReportConfig()
    tables = tpipe.cached_tables(H, W, cfg, torch.device("cpu"))
    rgb = torch.from_numpy(planar_f32(name))
    bx, vd = box_arrays(boxes)
    got = pt.full_report(rgb, torch.from_numpy(bx), torch.from_numpy(vd),
                         tables, cfg)
    want = pt.full_report_batched(rgb[None], bx[None], vd[None], tables, cfg)
    for field, x, y in zip(got._fields, got, want):
        assert x.shape == y.shape[1:], field
        assert torch.equal(x, y[0]), field


def test_empty_boxes_like_jax():
    jb, jv = jpipe.empty_boxes()
    tb, tv = tpipe.empty_boxes()
    assert tb.device.type == tv.device.type == "cpu"
    for t, j in ((tb, jb), (tv, jv)):
        assert tuple(t.shape) == j.shape
        assert t.numpy().dtype == np.asarray(j).dtype
        assert not t.any()


def test_jitted_full_report_is_cached():
    cfg = pt.ReportConfig()
    a = tpipe.jitted_full_report(H, W, cfg, device="cpu")
    b = tpipe.jitted_full_report(H, W, cfg, device=torch.device("cpu"))
    assert a is b
    fn, tables = a
    assert fn.func is tpipe.full_report and fn.keywords == {"cfg": cfg}
    assert tables is tpipe.cached_tables(H, W, cfg, torch.device("cpu"))
    assert tables.polar.bin_ids.device.type == "cpu"


def test_jitted_full_report_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.jitted_full_report(H, W, pt.ReportConfig())


def test_single_image_names_are_public():
    for name in ("full_report", "crop_pgm", "crop_image"):
        assert name in pt.__all__ and name in ph.__all__
    assert set(ph.__all__) <= set(pt.__all__)
    assert pt.full_report is tpipe.full_report
    from photohive_dsp_tpu_torch.ops import colorspace

    assert pt.crop_pgm is colorspace.crop_pgm
    assert pt.crop_image is colorspace.crop_image
