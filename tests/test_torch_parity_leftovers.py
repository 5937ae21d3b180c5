"""The reference's dev-only utilities in the PyTorch port, as
tests/test_parity_leftovers.py holds the JAX package's, and each against
the JAX function (eager, as that file calls it) on the same inputs:
fft_shift (src/fft_processing.c:111-157), filter_image and the filtering
alternates sharpness_avg / average_sharpness / create_filtered_rgb
(src/filtering.c:58,81,110,186), pgm_to_rgb and hsv_to_rgb
(src/image_processing.c:423,515), the standalone crops (:213-268) and
print_full_report's layout (src/utilities.c:229-256)."""

from __future__ import annotations

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photohive_dsp_tpu.ops import colorspace as jcs
from photohive_dsp_tpu.ops import fft as jfft
from photohive_dsp_tpu.ops import filtering as jfilt

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.ops import colorspace, fft, filtering

from .util import structured_image

LAPLACIAN = [[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]]
# filter_image: the port adds the fh*fw products in row-major tap order,
# XLA's convolution in its own order; float32 reassociation of 15 terms.
FILTER_RTOL, FILTER_ATOL = 1e-5, 1e-5


def half_spectrum(h: int, w: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((h, w))
    return (np.abs(np.fft.rfft2(x)) ** 2).astype(np.float32)


def test_fft_shift_matches_numpy_fftshift_odd_sizes():
    h, w = 31, 45  # odd x odd: 180-degree rotation == exact symmetry
    rng = np.random.default_rng(0)
    x = rng.standard_normal((h, w))
    half = np.abs(np.fft.rfft2(x)) ** 2
    ours = fft.fft_shift(torch.from_numpy(half)).numpy()
    golden = np.fft.fftshift(np.abs(np.fft.fft2(x)) ** 2)
    assert ours.shape == (h, 2 * half.shape[1] - 1) == golden.shape
    np.testing.assert_allclose(ours, golden, rtol=1e-5)


def test_fft_shift_even_shape_and_center():
    h, w = 16, 20
    x = np.random.default_rng(1).standard_normal((h, w))
    x += 10.0  # a large DC, so the global max is the DC bin
    half = np.abs(np.fft.rfft2(x)) ** 2
    ours = fft.fft_shift(torch.from_numpy(half)).numpy()
    assert ours.shape == (h, 2 * half.shape[1] - 1)
    r, c = np.unravel_index(np.argmax(ours), ours.shape)
    assert (r, c) == (h // 2, half.shape[1] - 1)


@pytest.mark.parametrize("h,w", [(31, 45), (16, 20), (15, 64)],
                         ids=["odd", "even", "odd_rows_even_cols"])
def test_fft_shift_equals_jax(h, w):
    half = half_spectrum(h, w, seed=h)
    got = fft.fft_shift(torch.from_numpy(half)).numpy()
    want = np.asarray(jfft.fft_shift(jnp.asarray(half)))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_filter_image_matches_naive_correlation():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((9, 11)).astype(np.float32)
    taps = rng.standard_normal((3, 5)).astype(np.float32)
    ours = filtering.filter_image(torch.from_numpy(x), taps).numpy()
    golden = np.zeros_like(x)
    fh, fw = taps.shape
    for y in range(9):
        for xx in range(11):
            acc = 0.0
            for fy in range(fh):
                for fx in range(fw):
                    iy, ix = y + fy - fh // 2, xx + fx - fw // 2
                    if 0 <= iy < 9 and 0 <= ix < 11:
                        acc += x[iy, ix] * taps[fy, fx]
            golden[y, xx] = acc
    np.testing.assert_allclose(ours, golden, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 5), (4, 2), (1, 1)])
def test_filter_image_equals_jax(shape):
    """Random taps (even sizes too: the padding is fh//2 before and
    (fh-1)//2 after) and nested-list taps."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((23, 37)).astype(np.float32)
    taps = rng.standard_normal(shape).astype(np.float32)
    got = filtering.filter_image(torch.from_numpy(x), taps.tolist()).numpy()
    want = np.asarray(jfilt.filter_image(jnp.asarray(x), taps))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=FILTER_RTOL, atol=FILTER_ATOL)


def test_filter_image_laplacian_is_laplacian_3x3():
    """On an integer-valued plane every partial sum is exact, so the
    shifted-product form equals the separable Laplacian bit for bit."""
    x = np.random.default_rng(5).integers(0, 256, (40, 52)).astype(
        np.float32)
    t = torch.from_numpy(x)
    assert torch.equal(filtering.filter_image(t, LAPLACIAN),
                       filtering.laplacian_3x3(t))


def test_create_filtered_rgb_and_pgm_roundtrip():
    rgb = torch.from_numpy(structured_image(32, 48).astype(np.float32))
    out = filtering.create_filtered_rgb(rgb, LAPLACIAN)
    assert out.shape == rgb.shape
    for c in range(3):
        assert torch.equal(out[c], filtering.filter_image(rgb[c], LAPLACIAN))
    want = np.asarray(jfilt.create_filtered_rgb(jnp.asarray(rgb.numpy()),
                                                LAPLACIAN))
    np.testing.assert_allclose(out.numpy(), want, rtol=FILTER_RTOL,
                               atol=FILTER_ATOL)
    rgb3 = colorspace.pgm_to_rgb(rgb[0])
    assert rgb3.shape == (3,) + tuple(rgb[0].shape)
    assert np.array_equal(rgb3.numpy(),
                          np.asarray(jcs.pgm_to_rgb(jnp.asarray(rgb[0]))))


def test_hsv_to_rgb_equals_jax():
    """A dense hue grid over [0, 360] with every multiple of 60 and its
    neighbouring floats (the sector edges), s and v in [0, 1]: bit-equal,
    since both divide by 60 in IEEE and take Python's remainder."""
    edges = np.arange(7, dtype=np.float32) * 60
    h = np.concatenate([
        np.linspace(0, 360, 200_001, dtype=np.float32), edges,
        np.nextafter(edges, np.float32(-1)), np.nextafter(edges,
                                                          np.float32(400))])
    rng = np.random.default_rng(6)
    s = rng.random(h.shape, dtype=np.float32)
    v = rng.random(h.shape, dtype=np.float32)
    s[:7], v[:7] = 1.0, 1.0
    got = colorspace.hsv_to_rgb(*(torch.from_numpy(a) for a in (h, s, v)))
    want = jcs.hsv_to_rgb(*(jnp.asarray(a) for a in (h, s, v)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # h = 360 is sector 5 (x = 0): (v, v - c, v - c)
    one = colorspace.hsv_to_rgb(*(torch.tensor([a]) for a in (360.0, 1.0,
                                                              1.0)))
    assert [float(c) for c in one] == [1.0, 0.0, 0.0]


def test_hsv_to_rgb_inverts_rgb_to_hsv():
    rng = np.random.default_rng(8)
    rgb = torch.from_numpy(rng.integers(0, 256, (3, 64, 64)).astype(
        np.float32) / np.float32(255))
    back = colorspace.hsv_to_rgb(*colorspace.rgb_to_hsv(*rgb))
    assert float((torch.stack(back) - rgb).abs().max()) < 1e-5


def test_sharpness_avg_threshold_semantics():
    resp = torch.tensor([0.1, 0.3, 0.5, -2.0])
    # mean of the values strictly above 0.2 (reference src/filtering.c:64)
    assert float(filtering.sharpness_avg(resp)) == pytest.approx(0.4)
    assert filtering.SHARPNESS_AVG_THRESHOLD == \
        jfilt.SHARPNESS_AVG_THRESHOLD == 0.2
    # nothing above the threshold -> NaN, like the reference's 0/0
    empty = filtering.sharpness_avg(torch.full((4,), -1.0))
    assert torch.isnan(empty)
    assert np.isnan(np.asarray(jfilt.sharpness_avg(
        jnp.full((4,), -1.0, jnp.float32))))


@pytest.mark.parametrize("seed", [0, 1])
def test_sharpness_avg_and_average_sharpness_equal_jax(seed):
    pgm = structured_image(64, 80, seed=seed)[0].astype(np.float32)
    resp = np.random.default_rng(seed).standard_normal((50, 70)).astype(
        np.float32)
    got = float(filtering.sharpness_avg(torch.from_numpy(resp)))
    want = float(jfilt.sharpness_avg(jnp.asarray(resp)))
    assert got == pytest.approx(want, rel=1e-6)
    got = float(filtering.average_sharpness(torch.from_numpy(pgm)))
    want = float(jfilt.average_sharpness(jnp.asarray(pgm)))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-5)


def test_crop_pgm_and_crop_image_parity(capsys):
    """Exact slices in the reference's argument order (right, left, bottom,
    top), None with the reference's message on out-of-range or negative
    bounds, an empty slice on a degenerate box; the same as the JAX
    package's."""
    rng = np.random.default_rng(7)
    pgm = rng.random((40, 60)).astype(np.float32)
    rgb = rng.random((3, 40, 60)).astype(np.float32)
    tp, tr = torch.from_numpy(pgm), torch.from_numpy(rgb)
    got = colorspace.crop_pgm(tp, right=50, left=10, bottom=30, top=5)
    assert np.array_equal(got.numpy(), pgm[5:30, 10:50])
    got3 = colorspace.crop_image(tr, 60, 0, 40, 0)  # full-image bounds OK
    assert np.array_equal(got3.numpy(), rgb)
    for args in ((50, 10, 30, 5), (60, 0, 40, 0), (10, 20, 30, 5),
                 (50, 10, 5, 30)):
        want = np.asarray(jcs.crop_image(jnp.asarray(rgb), *args))
        assert np.array_equal(colorspace.crop_image(tr, *args).numpy(), want)
    assert colorspace.crop_pgm(tp, 10, 20, 30, 5).shape == (25, 0)
    capsys.readouterr()
    for bad in ((61, 0, 40, 0), (50, -1, 30, 5), (60, 0, 41, 0),
                (60, 61, 40, 0), (60, 0, 40, -2)):
        assert colorspace.crop_pgm(tp, *bad) is None
        assert colorspace.crop_image(tr, *bad) is None
        assert jcs.crop_pgm(jnp.asarray(pgm), *bad) is None
    err = capsys.readouterr().err
    assert err.count("Error: crop boundaries outside of image boundaries.") \
        == 15
    assert pt.crop_pgm is colorspace.crop_pgm


def test_text_report_layout():
    img8 = np.moveaxis((structured_image(400, 520, seed=9) * 255).round(),
                       0, -1).astype(np.uint8)
    rep = pt.get_report(img8, device="cpu")
    lines = rep.text_report().splitlines()
    assert lines[0] == "FULL REPORT:"
    assert lines[1].startswith("Average Saturation: ")
    assert sum(1 for ln in lines if ln.startswith("angle:")) == 72 * 40
    n_palette = sum(1 for ln in lines if "Portion of image" in ln)
    assert n_palette == rep.color_palette.N
    assert lines[-1] == "END OF REPORT."
