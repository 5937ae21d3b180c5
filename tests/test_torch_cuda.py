"""The CUDA kernels (K1-K5, K6a/K6b, K7+K8, K9, K10) against their plain
PyTorch versions on an NVIDIA GPU, and the row-sharded report at world
size 1 (NCCL) against the single-device path.  Every test here needs the card and nvcc and
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
from photohive_dsp_tpu_torch.ops import sharpness_kernels as tsk
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


@pytest.mark.cuda
def test_cuda_sharpness_kernel_matches_plain(cuda_device):
    """K5 against its plain version within 1e-5 relative (the kernel's
    float32 per-thread sums), bit-identical over two launches, with and
    without a halo, at 1080 rows (not a multiple of the 32-row tile)."""
    rng = np.random.default_rng(9)
    b, h, w = 2, 1080, 1000
    pgm = torch.from_numpy(rng.random((b, h, w), dtype=np.float32))
    halo = torch.from_numpy(rng.random((b, 2, w), dtype=np.float32))
    boxes = torch.zeros((b, 10, 4), dtype=torch.int32)
    boxes[:, 0] = torch.tensor([0, 1080, 0, 1000])     # the whole frame
    boxes[:, 1] = torch.tensor([31, 65, 127, 129 + 4])  # across tile seams
    boxes[:, 4] = torch.tensor([1040, 1080, 900, 1000])
    boxes[1, 9] = torch.tensor([-3, 20, 5, 400])       # spans the halo row
    for hl in (None, halo):
        for row_offset in (0, 3):
            args = (boxes.to(cuda_device), None if hl is None
                    else hl.to(cuda_device), row_offset)
            got = tsk.sharpness_sums(pgm.to(cuda_device), *args)
            again = tsk.sharpness_sums(pgm.to(cuda_device), *args)
            want = tsk.sharpness_sums_plain(pgm, boxes, hl, row_offset)
            for g, a, wt in zip(got, again, want):
                assert torch.equal(g, a)
                g = g.cpu()
                assert bool(((g - wt).abs() <= 1e-5 * wt.abs()).all())
                assert torch.equal(g == 0, wt == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(IMAGES))
def test_cuda_flat_hsv_kernels_match_plain(name, cuda_device):
    """K9 and K10 on flat HSV with a sentinel tail: their int64
    accumulators equal their plain versions' bit for bit, K9's counts equal
    K1's on the same pixels, and the tail changes nothing."""
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv

    rgb, _ = IMAGES[name]
    x = torch.from_numpy(rgb).to(cuda_device)
    b, p = x.shape[0], x.shape[2] * x.shape[3]
    flat = x.reshape(b, 3, p)
    real = list(rgb_to_hsv(flat[:, 0], flat[:, 1], flat[:, 2]))
    tail = torch.rand((3, b, 777), device=cuda_device)
    tail[0] = -1.0
    hsv = [torch.cat([r, t], dim=1).contiguous() for r, t in zip(real, tail)]
    real = [r.contiguous() for r in real]
    acc = tpk.cell_counts_from_hsv(*hsv, TCFG)
    assert torch.equal(acc, tpk.cell_counts_from_hsv_plain(*hsv, TCFG))
    assert torch.equal(acc, tpk.cell_counts_from_hsv(*real, TCFG))
    counts, _ = tpk.counts_s_from_fixed(acc)
    assert torch.equal(counts, tpk.cell_counts_s_from_rgb(x, TCFG)[0])
    tt = tq.OctreeTables.for_config(TCFG, cuda_device)
    assign = tq.parent_assignment_from_order(
        counts, margin_sort(tq.saliency_f32(counts, tt.s_v_f32, TCFG)), p,
        TCFG, tt)
    for q in (8, 40):
        tabs = tpk.palette_candidate_table(assign, tt, C, q)
        got = tpk.palette_sums_by_k(*hsv, *tabs, TCFG)
        assert torch.equal(got, tpk.palette_sums_by_k_plain(*hsv, *tabs,
                                                            TCFG))
        assert torch.equal(got, tpk.palette_sums_by_k(*real, *tabs, TCFG))


@pytest.mark.cuda
def test_cuda_spatial_report_world_size_1(cuda_device, tmp_path):
    """build_spatial_report on one rank (NCCL) launches K5, K9 and K10 and
    gives the single-device report: the palette bit for bit."""
    import torch.distributed as dist

    from photohive_dsp_tpu_torch.parallel import mesh, spatial

    h, w = 487, 640
    cfg = ReportConfig()
    img = np.round(smooth_rgb(1, h, w)[0] * 255).astype(np.uint8)
    boxes, valid = pt.set_bounding_boxes([
        dict(top=40, bottom=200, left=60, right=300),
        dict(top=300, bottom=487, left=100, right=630)])
    group = mesh.init_spatial_group(0, 1, f"file://{tmp_path}/rendezvous",
                                    device=cuda_device)
    try:
        _cuda.reset_launch_counts()
        got = spatial.build_spatial_report(group, h, w, cfg, cuda_device)(
            img, boxes, valid)
        torch.cuda.synchronize()
        for name in ("sharpness_sums", "cell_counts_hsv",
                     "palette_sums_flat_q8", "polar_bins"):
            assert _cuda.LAUNCHES[name] == 1, name
    finally:
        dist.destroy_process_group()
    ref = pt.full_report_batched(
        torch.from_numpy(img)[None].to(cuda_device), boxes[None], valid[None],
        pt.ReportTables.build(h, w, cfg, cuda_device), cfg)
    for k in ("palette_n", "palette_ids", "palette_pct", "palette_hsv",
              "average_saturation", "blur_vector_angles"):
        assert torch.equal(got._asdict()[k], getattr(ref, k)[0]), k
    assert torch.allclose(got.sharpness, ref.sharpness[0], rtol=1e-5, atol=0)
    assert torch.allclose(got.rgb_stats, ref.rgb_stats[0], rtol=2e-5,
                          atol=1e-6)
    assert _snr_db(ref.blur_bins[0], got.blur_bins) >= 55
