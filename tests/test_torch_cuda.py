"""The CUDA kernels (K1-K4, K6a/K6b, K7+K8) against their plain PyTorch
versions on an NVIDIA GPU.  Every test here needs the card and nvcc and
skips without them; this file imports no JAX, so the machine with the card
runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The image generators are shared with tests/test_torch_palette.py."""

import numpy as np
import pytest
import torch

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.config import ReportConfig
from photohive_dsp_tpu_torch.ops import _cuda
from photohive_dsp_tpu_torch.ops import fft_kernels as tfk
from photohive_dsp_tpu_torch.ops import palette_kernels as tpk
from photohive_dsp_tpu_torch.ops import polar_kernels as tpolar
from photohive_dsp_tpu_torch.ops import quantize as tq
from photohive_dsp_tpu_torch.ops.blur import PolarTables, blur_bins_lognorm
from photohive_dsp_tpu_torch.ops.fft_plan import FftPlan
from photohive_dsp_tpu_torch.ops.margin_sort import (
    margin_insertion_argsort, margin_sort)

TCFG = ReportConfig()
C = TCFG.num_cells


def noise_rgb(b, h, w, seed=0):
    return np.random.default_rng(seed).random((b, 3, h, w)).astype(
        np.float32)


def smooth_rgb(b, h, w, seed=4):
    """The low-colour pattern of test_pallas_interpret.py:300-306: no
    populated cell is tied, so the palette takes the q=1 tier."""
    rng = np.random.default_rng(seed)
    yg, xg = np.mgrid[0:h, 0:w].astype(np.float32)
    one = np.stack([0.25 + 0.5 * (xg / w), 0.25 + 0.5 * (yg / h),
                    0.4 + 0 * xg])
    rgb = np.stack([one] * b)
    return np.clip(rgb + rng.normal(0, 0.005, rgb.shape), 0, 1).astype(
        np.float32)


def wheel_rgb(b, h, w):
    """All 18 hues at one (s, v) plus a gray band: the populated gray cell
    ties across the hues, so the palette needs the full candidate width."""
    hue = np.broadcast_to(np.arange(w)[None, :] / w * 360.0, (h, w))
    c = 0.64
    xx = c * (1 - np.abs((hue / 60) % 2 - 1))
    sec = (hue // 60).astype(int) % 6
    r = np.choose(sec, [c, xx, 0, 0, xx, c])
    g = np.choose(sec, [xx, c, c, xx, 0, 0])
    bl = np.choose(sec, [0, 0, xx, c, c, xx])
    one = np.stack([r, g, bl]) + 0.16
    one[:, : max(1, h // 32)] = 0.5
    return np.stack([one] * b).astype(np.float32)


# name -> (B, 3, H, W) float32 image, the palette tier it takes
IMAGES = {"noise": (noise_rgb(2, 16, 256), 8),
          "smooth": (smooth_rgb(2, 64, 384), 1),
          "wheel": (wheel_rgb(2, 32, 256), 40)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(IMAGES))
@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_cuda_kernels_match_plain(name, dtype, cuda_device):
    rgb, _ = IMAGES[name]
    x = torch.from_numpy(np.round(rgb * 255).astype(np.uint8)
                         if dtype == "u8" else rgb).to(cuda_device)
    tt = tq.OctreeTables.for_config(TCFG, cuda_device)
    counts, s_sum = tpk.cell_counts_s_from_rgb(x, TCFG)
    counts0, s_sum0 = tpk.cell_counts_s_from_rgb_plain(x, TCFG)
    assert torch.equal(counts, counts0)
    assert float(((s_sum - s_sum0) / s_sum0).abs().max()) < 1e-6
    sal = tq.saliency_f32(counts, tt.s_v_f32, TCFG)
    order = margin_sort(sal)
    assert torch.equal(order, margin_insertion_argsort(sal))
    assign = tq.parent_assignment_from_order(
        counts, order, x.shape[2] * x.shape[3], TCFG, tt)
    slot, off = tpk.palette_offset_table(assign, tt, C)
    runs = [(tpk.palette_sums_by_k_rgb_q1, tpk.palette_sums_by_k_rgb_q1_plain,
             (slot, off))]
    for q in (8, 40):
        runs.append((tpk.palette_sums_by_k_rgb,
                     tpk.palette_sums_by_k_rgb_plain,
                     tpk.palette_candidate_table(assign, tt, C, q)))
    for kern, plain, tabs in runs:
        got, want = kern(x, *tabs, TCFG), plain(x, *tabs, TCFG)
        assert torch.equal(got[..., 3], want[..., 3])
        assert bool(((got - want).abs() <= 1e-5 * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [C, 2164])
def test_cuda_margin_sort_any_c(c, cuda_device):
    rng = np.random.default_rng(5)
    sal = torch.tensor(np.round(rng.random((3, c)) * 30)
                       + rng.random((3, c)) * 0.6, dtype=torch.float32,
                       device=cuda_device)
    assert torch.equal(margin_sort(sal), margin_insertion_argsort(sal))


def _snr_db(want: torch.Tensor, got: torch.Tensor) -> float:
    want, got = want.double().cpu(), got.double().cpu()
    err = float(torch.linalg.vector_norm(want - got))
    sig = float(torch.linalg.vector_norm(want))
    return float("inf") if err == 0 else 20 * np.log10(sig / err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 1080, 1920), (2, 1092, 1001),
                                   (1, 91, 375)])
def test_cuda_fft_kernels_match_plain(b, h, w, cuda_device):
    """K6a and K6b repeat their plain versions' float32 operations in the
    same order: they agree to the rounding of the peak, and both hold the
    JAX package's 90 dB bar against float64 rfft2."""
    x = np.random.default_rng(11).standard_normal((b, h, w)).astype(
        np.float32)
    xd = torch.from_numpy(x).to(cuda_device)
    plan = FftPlan.for_shape(h, w, cuda_device)
    spec, spec0 = tfk.fft_rows(xd, plan), tfk.fft_rows_plain(xd, plan)
    assert float((spec - spec0).abs().max()) <= 1e-6 * float(
        spec0.abs().max())
    mag, mag0 = tfk.fft_cols(spec0, plan), tfk.fft_cols_plain(spec0, plan)
    assert float((mag - mag0).abs().max()) <= 1e-6 * float(mag0.max())
    want = torch.from_numpy(np.abs(np.fft.rfft2(x.astype(np.float64))) ** 2)
    assert _snr_db(want, tfk.magnitude2(xd, plan)) >= 90


@pytest.mark.cuda
@pytest.mark.parametrize("a,r", [(72, 40), (360, 100)],
                         ids=["shared_table", "global_atomics"])
def test_cuda_polar_kernel_matches_plain_and_repeats(a, r, cuda_device):
    """Exact fixed-point sums: the kernel differs from the plain version
    only by logf's rounding (<= 1e-6 relative), and two launches are
    bit-identical.  360x100 bins overflow the shared table."""
    h, w = 360, 512
    cfg = ReportConfig(angle_partitions=a, radius_partitions=r)
    x = np.random.default_rng(3).standard_normal((2, h, w)).astype(
        np.float32)
    plan = FftPlan.for_shape(h, w, cuda_device)
    mag2 = tfk.magnitude2(torch.from_numpy(x).to(cuda_device),
                          plan).reshape(2, -1)
    ids = PolarTables.for_shape(h, w, cfg, cuda_device).bin_ids
    got = tpolar.polar_bin_sums_lognorm(mag2, ids, a * r)
    again = tpolar.polar_bin_sums_lognorm(mag2, ids, a * r)
    want = tpolar.polar_bin_sums_lognorm_plain(mag2, ids, a * r)
    assert torch.equal(got, again)
    assert bool(((got - want).abs() <= 1e-6 * want.abs()).all())


@pytest.mark.cuda
def test_cuda_blur_bins_zero_frame(cuda_device):
    h, w = 360, 512
    cfg = ReportConfig()
    bins = blur_bins_lognorm(
        torch.zeros((2, h, w), device=cuda_device),
        FftPlan.for_shape(h, w, cuda_device),
        PolarTables.for_shape(h, w, cfg, cuda_device),
        cfg.angle_partitions, cfg.radius_partitions)
    assert bool(torch.isfinite(bins).all()) and not bool(bins.any())


@pytest.mark.cuda
def test_cuda_blur_route_matches_cpu(cuda_device):
    """full_report_batched on the card goes through the FFT and polar
    kernels and gives the CPU path's blur bins (>= 60 dB) and vectors."""
    h, w = 360, 512
    cfg = ReportConfig()
    u8 = np.round(noise_rgb(2, h, w, seed=7) * 255).astype(np.uint8)
    boxes = np.zeros((2, 10, 4), np.int32)
    valid = np.zeros((2, 10), bool)
    _cuda.reset_launch_counts()
    got = pt.full_report_batched(torch.from_numpy(u8).to(cuda_device), boxes,
                                 valid, pt.ReportTables.build(h, w, cfg,
                                                              cuda_device),
                                 cfg)
    for name in ("fft_rows", "fft_cols", "polar_bins"):
        assert _cuda.LAUNCHES[name] == 1, name
    want = pt.full_report_batched(torch.from_numpy(u8), boxes, valid,
                                  pt.ReportTables.build(h, w, cfg), cfg)
    assert _snr_db(want.blur_bins, got.blur_bins) >= 60
    assert torch.equal(want.blur_vector_angles, got.blur_vector_angles.cpu())
    assert torch.equal(want.blur_vector_mags, got.blur_vector_mags.cpu())
