"""The plain reference against the port's CPU path on every report field,
at a small size, and its float32 arithmetic helpers."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import photohive_dsp_tpu_torch as pt
from portbench import check, frames
from portbench.reference.report import Reference, f32_round, fma_f32
from portbench.run import box_dicts
from portbench.spec import ROOT
import json

CFG = json.loads((ROOT / "portbench" / "configs" /
                  "photo_1080p.json").read_text())


def port_fields(img, boxes, cfg):
    rep = pt.get_report(img, pt.set_bounding_boxes(boxes), device="cpu",
                        config=pt.ReportConfig(**cfg))
    return check.from_report(rep, rep.to_json(), len(boxes))


@pytest.mark.parametrize("seed,grid,shake", [
    (11, {}, None), (12, {}, None), (2**31 + 5, {}, None),
    (15, {}, (0.004, 0.02)), (16, {}, (0.004, 0.02)),
    (13, dict(h_partitions=12, s_partitions=3, v_partitions=2), None),
    (14, dict(h_partitions=24, s_partitions=5, v_partitions=5), None)])
def test_reference_agrees_with_the_port_on_every_field(seed, grid, shake):
    cfg = dict(CFG["report_config"], **grid)
    img = frames.frames(seed, [(360, 512)], 1, "cpu", shake)[0]
    boxes = box_dicts(CFG["boxes"], 360, 512)
    got = port_fields(img, boxes, cfg)
    want = Reference(cfg, "cpu").report(
        img, [(b["top"], b["bottom"], b["left"], b["right"])
              for b in boxes])
    gaps = check.gaps(got, want, 360 * 512, cfg)
    assert check.verdict(check.combine([gaps]), 1, 0, 1,
                         check.required(True)), gaps
    assert gaps["palette_ids_differ"] == 0
    assert gaps["blur_vectors_differ"] == 0
    assert got["blur_vectors"] == want["blur_vectors"]
    if shake:       # camera shake gives the profile a streak
        assert any(v != (0, 0.0) for v in want["blur_vectors"])


def test_frames_are_the_seeds_and_photo_like():
    a = frames.frames(7, [(360, 512), (384, 640)], 3, "cpu")
    b = frames.frames(7, [(360, 512), (384, 640)], 3, "cpu")
    c = frames.frames(8, [(360, 512), (384, 640)], 3, "cpu")
    assert [f.shape for f in a] == [(360, 512, 3), (384, 640, 3),
                                    (360, 512, 3)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.uint8 and 20 < a[0].std() < 120


def test_fma_rounds_once():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(4000).astype(np.float32) for _ in range(3))
    # near-cancelling sums and float32 midpoints stress the double rounding
    c[:2000] = (-(a[:2000].astype(np.float64) * b[:2000])).astype(np.float32)
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([f32_round(Fraction(float(x)) * Fraction(float(y))
                               + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)


def test_f32_round_ties_to_even():
    one = Fraction(1)
    ulp = Fraction(2) ** -23
    assert f32_round(one + ulp / 2) == np.float32(1.0)
    assert f32_round(one + 3 * ulp / 2) == np.float32(1 + 2 * 2.0 ** -23)
    assert f32_round(Fraction(1, 3)) == np.float32(1) / np.float32(3)
