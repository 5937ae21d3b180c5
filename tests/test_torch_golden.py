"""The port's report on flat frames against the float64 golden
(tests/golden_ref.full_report) on the CPU: one colour, a hue wheel with a
gray band, black and white, 360x512 with two crop boxes.

On such frames the port's exact fixed-point sums keep it at the golden's
bars, where jitted JAX, which adds its palette sums and statistics in
float32, is not held here (ROADMAP Queue 3)."""

import warnings

import numpy as np
import pytest

import photohive_dsp_tpu_torch as pt

from . import golden_ref as gold
from .util import snr_db

H, W = 360, 512
BOXES = [(10, 200, 20, 300), (50, 300, 100, 500)]


def _wheel() -> np.ndarray:
    """Every hue across the width at one (s, v), with a gray band on
    top."""
    hue = np.broadcast_to(np.arange(W)[None, :] / W * 360.0, (H, W))
    c = 0.64
    xx = c * (1 - np.abs((hue / 60) % 2 - 1))
    sec = (hue // 60).astype(int) % 6
    rgb = np.stack([np.choose(sec, [c, xx, 0, 0, xx, c]),
                    np.choose(sec, [xx, c, c, xx, 0, 0]),
                    np.choose(sec, [0, 0, xx, c, c, xx])]) + 0.16
    rgb[:, : H // 32] = 0.5
    return np.round(np.moveaxis(rgb, 0, -1) * 255).astype(np.uint8)


FRAMES = {
    "one colour": np.broadcast_to(np.array([200, 30, 90], np.uint8),
                                  (H, W, 3)).copy(),
    "hue wheel": _wheel(),
    "black": np.zeros((H, W, 3), np.uint8),
    "white": np.full((H, W, 3), 255, np.uint8),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_flat_frame_report_meets_golden_bars(name):
    img = FRAMES[name]
    boxes = pt.set_bounding_boxes([dict(top=t, bottom=b, left=l, right=r)
                                   for t, b, l, r in BOXES])
    rep = pt.get_report(img, boxes, device="cpu")
    with warnings.catch_warnings():
        # The golden's black frame divides 0 by 0 for its sharpness.
        warnings.simplefilter("ignore", RuntimeWarning)
        want = gold.full_report(np.moveaxis(img, -1, 0).astype(np.float64)
                                / 255.0, boxes=BOXES)
    cp, st = rep.color_palette, rep.rgb_stats

    # Palette (tests/test_pallas_interpret.py:43-46): the same parents; a
    # percentage is count * float32(1 / total), jitted JAX's division, so
    # it is the golden's within one float32 step; HSV within 5e-3.
    assert list(cp.cell_ids) == [int(i) for i in want["palette_ids"]]
    pct = np.array(cp.quantities, np.float32)
    ref = np.float32(want["palette_pct"])
    assert (np.abs(pct - ref) <= np.spacing(ref)).all()
    assert np.abs(np.array(cp.hsv).reshape(-1, 3)
                  - np.array(want["palette_hsv"])).max() < 5e-3
    # Golden bars (tests/test_pipeline.py:32-33, 39, 56) and the port's
    # mean-saturation bar against JAX (tests/test_torch_pipeline.py).
    stats = [st.Br, st.Bg, st.Bb, st.Cr, st.Cg, st.Cb]
    assert snr_db(want["rgb_stats"], stats) > 60
    assert abs(rep.average_saturation - want["average_saturation"]) < 1e-4
    assert np.isclose(rep.average_saturation, want["average_saturation"],
                      rtol=1e-6, atol=0)
    assert snr_db(want["blur_bins"], np.array(rep.blur_profile.bins)) > 35
    np.testing.assert_allclose(rep.sharpnesses, want["sharpness"],
                               rtol=1e-4, equal_nan=True)
    for (angle, mag), v in zip(want["blur_vectors"], rep.blur_vectors):
        assert v.angle == angle
        assert abs(v.magnitude - mag) < 1e-5
