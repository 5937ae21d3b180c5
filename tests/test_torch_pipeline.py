"""The PyTorch port end to end against the JAX package on the CPU:
get_report and full_report_batched at a tile-aligned 360x512, with and
without crop boxes (one of them thin), at the port's acceptance bars."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.models import pipeline as jpipe

import photohive_dsp_tpu_torch as pt

from .util import directional_blur_image, snr_db, structured_image

H, W = 360, 512
BOXES = [dict(top=10, bottom=200, left=20, right=300),
         dict(top=50, bottom=300, left=100, right=500)]
THIN = BOXES + [dict(top=120, bottom=122, left=30, right=480)]


def _images():
    rng = np.random.default_rng(0)
    structured = np.round(np.moveaxis(structured_image(H, W, seed=3), 0, -1)
                          * 255).astype(np.uint8)
    blurred = np.round(np.moveaxis(directional_blur_image(H, W, seed=2),
                                   0, -1) * 255).astype(np.uint8)
    return {"noise": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            "structured": structured, "blurred": blurred}


IMAGES = _images()


def report_fields(rep) -> dict:
    cp, st = rep.color_palette, rep.rgb_stats
    return dict(
        palette_ids=np.array(cp.cell_ids), palette_n=cp.N,
        palette_pct=np.array(cp.quantities, np.float32),
        palette_hsv=np.array(cp.hsv, np.float32).reshape(-1, 3),
        average_saturation=np.float32(rep.average_saturation),
        rgb_stats=np.array([st.Br, st.Bg, st.Bb, st.Cr, st.Cg, st.Cb]),
        sharpness=np.array(rep.sharpnesses),
        blur_bins=np.array(rep.blur_profile.bins),
        blur_vector_angles=np.array([v.angle for v in rep.blur_vectors]),
        blur_vector_mags=np.array([v.magnitude for v in rep.blur_vectors]))


def data_fields(data, i) -> dict:
    row = {k: np.asarray(v[i]) if not isinstance(v, torch.Tensor)
           else v[i].numpy() for k, v in data._asdict().items()}
    n = int(row["palette_n"])
    return dict(row, palette_n=n, palette_ids=row["palette_ids"][:n],
                palette_pct=row["palette_pct"][:n],
                palette_hsv=row["palette_hsv"][:n])


def assert_match(got: dict, want: dict) -> None:
    """The port's acceptance bars against the JAX package."""
    assert np.array_equal(got["palette_ids"], want["palette_ids"])
    assert got["palette_n"] == want["palette_n"]
    assert np.array_equal(got["palette_pct"], want["palette_pct"])
    assert np.abs(got["palette_hsv"] - want["palette_hsv"]).max() < 5e-3
    assert np.isclose(got["average_saturation"], want["average_saturation"],
                      rtol=1e-6, atol=0)
    assert np.abs(got["rgb_stats"] / want["rgb_stats"] - 1).max() < 1e-5
    assert np.allclose(got["sharpness"], want["sharpness"], rtol=1e-4,
                       atol=0)
    assert snr_db(want["blur_bins"], got["blur_bins"]) >= 60
    assert np.array_equal(got["blur_vector_angles"],
                          want["blur_vector_angles"])
    assert np.array_equal(got["blur_vector_mags"], want["blur_vector_mags"])


CASES = [("noise", None), ("structured", BOXES), ("structured", THIN),
         ("blurred", THIN)]


@pytest.mark.parametrize("name,boxes", CASES,
                         ids=["noise", "boxes", "thin_box", "blurred_thin"])
def test_get_report_matches_jax(name, boxes):
    img = IMAGES[name]
    jb = ph.set_bounding_boxes(boxes) if boxes else None
    tb = pt.set_bounding_boxes(boxes) if boxes else None
    want = ph.get_report(img, jb)
    got = pt.get_report(img, tb, device="cpu")
    assert_match(report_fields(got), report_fields(want))
    assert len(got.sharpnesses) == len(boxes or [])
    got_json, want_json = json.loads(got.to_json()), json.loads(want.to_json())
    assert len(got_json) == 439
    assert list(got_json) == list(want_json)
    assert got.text_report().count("\n") == want.text_report().count("\n")


@pytest.mark.parametrize("knobs", [
    dict(downsample_rate=2),
    dict(h_partitions=36, s_partitions=4, v_partitions=4,
         radius_partitions=10, angle_partitions=24)],
    ids=["downsample2", "581_cells"])
def test_get_report_nondefault_config_matches_jax(knobs):
    """C=581 takes K2 past the JAX Pallas sort's 512-cell limit.  (Grids
    whose cell sizes make XLA's reciprocal-multiply cell ids differ from
    IEEE division on u8 pixels, e.g. 12x3x2, are left out: see ROADMAP.md
    Queue 3.)"""
    img = IMAGES["structured"]
    want = ph.get_report(img, ph.set_bounding_boxes(BOXES), **knobs)
    got = pt.get_report(img, pt.set_bounding_boxes(BOXES), device="cpu",
                        **knobs)
    assert_match(report_fields(got), report_fields(want))
    assert np.array(got.blur_profile.bins).shape == \
        (knobs.get("angle_partitions", 72), knobs.get("radius_partitions", 40))


def test_full_report_batched_with_jax_tables_matches_jax():
    """Both packages fed the same host tables (ReportTables.from_numpy)."""
    cfg_j, cfg_t = ph.ReportConfig(), pt.ReportConfig()
    jt = jpipe.ReportTables.build(H, W, cfg_j)
    tt = pt.ReportTables.from_numpy(jt)
    rgb = np.stack([np.moveaxis(IMAGES[k], -1, 0) for k in
                    ("noise", "structured")]).astype(np.float32) / 255
    boxes, valid = pt.set_bounding_boxes(BOXES)
    bx, vd = np.stack([boxes] * 2), np.stack([valid] * 2)
    want = jax.jit(lambda r, b, v: jpipe.full_report_batched(
        r, b, v, jt, cfg_j, False))(jnp.asarray(rgb), jnp.asarray(bx),
                                    jnp.asarray(vd))
    got = pt.full_report_batched(torch.from_numpy(rgb), bx, vd, tt, cfg_t)
    for i in range(2):
        assert_match(data_fields(got, i), data_fields(want, i))


def test_uint8_and_float_input_give_the_same_report():
    cfg = pt.ReportConfig()
    tables = pt.ReportTables.build(H, W, cfg)
    u8 = np.stack([np.moveaxis(IMAGES[k], -1, 0) for k in
                   ("noise", "structured")])
    f32 = u8.astype(np.float32) / np.float32(255)
    boxes, valid = pt.set_bounding_boxes(THIN)
    bx, vd = np.stack([boxes] * 2), np.stack([valid] * 2)
    a = pt.full_report_batched(torch.from_numpy(u8), bx, vd, tables, cfg)
    b = pt.full_report_batched(torch.from_numpy(f32), bx, vd, tables, cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_invalid_inputs_like_jax():
    small = np.zeros((300, 512, 3), np.uint8)
    assert pt.get_report(small, device="cpu") is None
    assert ph.get_report(small) is None
    with pytest.raises(ValueError):
        pt.set_bounding_boxes([BOXES[0]] * 11)
    with pytest.raises(ValueError):
        pt.get_report(IMAGES["noise"], device="cpu", h_partitions=7)
    with pytest.raises(ValueError):
        pt.get_report(np.zeros((400, 400), np.uint8), device="cpu")


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.get_report(IMAGES["noise"])
