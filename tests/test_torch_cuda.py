"""The CUDA kernels (K1-K15) against their plain PyTorch versions on an
NVIDIA GPU, the row-sharded report at world size 1 (NCCL) against the
single-device path, and BatchRunner on the card against the CPU path.  Every test here needs the card and nvcc and
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
    """Exact fixed-point sums: the kernel equals the plain version bit for
    bit (the same logf), with each image's maximum, and two launches are
    bit-identical.  360x100 bins overflow the shared table."""
    h, w = 360, 512
    cfg = ReportConfig(angle_partitions=a, radius_partitions=r)
    x = np.random.default_rng(3).standard_normal((2, h, w)).astype(
        np.float32)
    plan = FftPlan.for_shape(h, w, cuda_device)
    mag2 = tfk.magnitude2(torch.from_numpy(x).to(cuda_device),
                          plan).reshape(2, -1)
    ids = PolarTables.for_shape(h, w, cfg, cuda_device).bin_ids
    got, mx = tpolar.polar_bin_sums_lognorm(mag2, ids, a * r)
    again, mx_again = tpolar.polar_bin_sums_lognorm(mag2, ids, a * r)
    want, mx_want = tpolar.polar_bin_sums_lognorm_plain(mag2, ids, a * r)
    assert torch.equal(got, again) and torch.equal(mx, mx_again)
    assert torch.equal(got, want) and torch.equal(mx, mx_want)


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


def _flat_hsv_with_tail(rgb, device, tail=777):
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv

    x = torch.from_numpy(rgb).to(device)
    b, p = x.shape[0], x.shape[2] * x.shape[3]
    flat = x.reshape(b, 3, p)
    real = rgb_to_hsv(flat[:, 0], flat[:, 1], flat[:, 2])
    pad = torch.rand((3, b, tail), device=device)
    pad[0] = -1.0
    return [torch.cat([r, t], dim=1).contiguous() for r, t in zip(real, pad)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(IMAGES))
def test_cuda_cwide_kernel_matches_plain_and_k10(name, cuda_device):
    """K14's accumulator equals its plain version's and K10's at q_full
    bit for bit; with a populated cell's row emptied it still equals its
    plain version (that cell's pixels go to slot 0)."""
    hsv = _flat_hsv_with_tail(IMAGES[name][0], cuda_device)
    p = IMAGES[name][0].shape[2] * IMAGES[name][0].shape[3]
    tt = tq.OctreeTables.for_config(TCFG, cuda_device)
    counts, _ = tpk.counts_s_from_fixed(tpk.cell_counts_from_hsv(*hsv, TCFG))
    assign = tq.parent_assignment_from_order(
        counts, margin_sort(tq.saliency_f32(counts, tt.s_v_f32, TCFG)), p,
        TCFG, tt)
    bits, ctr = tpk.cwide_tables(assign, tt)
    got = tpk.palette_sums_by_k_cwide(*hsv, bits, ctr, TCFG)
    assert torch.equal(got, tpk.palette_sums_by_k_cwide_plain(*hsv, bits,
                                                              ctr, TCFG))
    _, q_full = tq.palette_widths(TCFG)
    assert torch.equal(got, tpk.palette_sums_by_k(
        *hsv, *tpk.palette_candidate_table(assign, tt, C, q_full), TCFG))
    allowed = assign.allowed.clone()
    allowed[0, int(counts[0].argmax())] = False
    bits = tpk.allowed_bitmask(allowed)
    assert torch.equal(tpk.palette_sums_by_k_cwide(*hsv, bits, ctr, TCFG),
                       tpk.palette_sums_by_k_cwide_plain(*hsv, bits, ctr,
                                                         TCFG))


@pytest.mark.cuda
def test_cuda_cwide_kernel_global_table(cuda_device):
    """At C=2164 (h_partitions=360, s 2, v 3) K14's bitmask (585 KB) does
    not fit in shared memory and is read from device memory."""
    cfg = ReportConfig(h_partitions=360)
    c = cfg.num_cells
    hsv = _flat_hsv_with_tail(noise_rgb(1, 64, 256, seed=2), cuda_device)
    tt = tq.OctreeTables.for_config(cfg, cuda_device)
    counts, _ = tpk.counts_s_from_fixed(tpk.cell_counts_from_hsv(*hsv, cfg))
    assign = tq.parent_assignment_from_order(
        counts, margin_sort(tq.saliency_f32(counts, tt.s_v_f32, cfg)),
        64 * 256, cfg, tt)
    bits, ctr = tpk.cwide_tables(assign, tt)
    assert bits.shape == (1, c, -(-c // 32))
    assert torch.equal(tpk.palette_sums_by_k_cwide(*hsv, bits, ctr, cfg),
                       tpk.palette_sums_by_k_cwide_plain(*hsv, bits, ctr,
                                                         cfg))


@pytest.mark.cuda
def test_cuda_cell_id_histogram_matches_plain(cuda_device):
    """K15 against its plain version, ids outside [0, C) included, and
    against K9's counts on the same pixels' cell ids."""
    rng = np.random.default_rng(6)
    cells = torch.from_numpy(rng.integers(-3, C + 3, (3, 100_003)).astype(
        np.int32)).to(cuda_device)
    got = tpk.cell_counts_batched(cells, C)
    assert torch.equal(got, tpk.cell_counts_batched_plain(cells, C))
    hsv = _flat_hsv_with_tail(IMAGES["noise"][0], cuda_device)
    real = hsv[0] >= 0
    ids = tq.assign_cells(torch.where(real, hsv[0], 0.0), hsv[1], hsv[2],
                          TCFG)
    ids = torch.where(real, ids, C).contiguous()
    k9, _ = tpk.counts_s_from_fixed(tpk.cell_counts_from_hsv(*hsv, TCFG))
    assert torch.equal(tpk.cell_counts_batched(ids, C), k9)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["bf16", "candidate", "cwide"])
def test_cuda_batch_runner_matches_cpu(variant, cuda_device, monkeypatch):
    """BatchRunner.run_u8 on the card (and with prefetch) against the CPU
    path, under each palette variant, with the variant's kernels
    launched."""
    from photohive_dsp_tpu_torch.models import batch as tbatch

    monkeypatch.setenv("PHOTOHIVE_PALETTE_KERNEL", variant)
    u8 = np.round(np.concatenate([wheel_rgb(1, 360, 512),
                                  noise_rgb(2, 360, 512, seed=8)])
                  * 255).astype(np.uint8)
    images = np.ascontiguousarray(np.moveaxis(u8, 1, -1))
    boxes, valid = pt.set_bounding_boxes([dict(top=10, bottom=300, left=20,
                                               right=480)])
    bx, vd = np.stack([boxes] * 3), np.stack([valid] * 3)
    _cuda.reset_launch_counts()
    got = tbatch.BatchRunner(TCFG).run_u8(images, bx, vd)
    torch.cuda.synchronize()
    want = {"bf16": "palette_sums_qfull", "candidate": "palette_sums_qfull_f32",
            "cwide": "palette_sums_cwide"}[variant]
    assert _cuda.LAUNCHES[want] == 1
    ref = tbatch.BatchRunner(TCFG, "cpu").run_u8(images, bx, vd)
    for k in ("palette_n", "palette_ids", "palette_pct", "blur_vector_angles",
              "blur_vector_mags"):
        assert torch.equal(getattr(got, k).cpu(), getattr(ref, k)), k
    assert float((got.palette_hsv.cpu() - ref.palette_hsv).abs().max()) < 5e-3
    assert torch.allclose(got.average_saturation.cpu(),
                          ref.average_saturation, rtol=1e-6, atol=0)
    stream = tbatch.BatchRunner(TCFG).run_stream_u8(
        iter([(images, bx, vd)] * 2), prefetch=1)
    for out in stream:
        for x, y in zip(out, got):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(1, 3, 1920), (3, 5, 1001), (1, 7, 3840),
                                   (1, 3, 14520), (4, 1080, 1920),
                                   (1, 3, 1080), (1, 3, 480), (1, 3, 12),
                                   (1, 3, 10), (1, 3, 14), (1, 3, 9),
                                   (1, 3, 64), (1, 3, 5), (1, 3, 3),
                                   (1, 3, 2), (1, 3, 1)])
def test_cuda_row_fft_bit_equal(b, h, w, cuda_device):
    """K6a equals fft_rows_plain bit for bit: an odd row count (the last
    row pairs with zeros), 1001 = 7 * 11 * 13 (single stages), 3840,
    14520 = 2^3 * 3 * 5 * 11^2 (the stage twiddles in device memory), the
    1080p batch, and lengths whose passes (fft_plan.row_passes) are each
    fused pair and single stage not met above: 1080 (4x2, 3x3, 3x5), 480
    (2x3), 12 (4x3), 10 (2x5), 14 (2x7), 9, 64 (4x4, then 4 alone), 5,
    3, 2 and 1 (no stage)."""
    x = torch.from_numpy(np.random.default_rng(w).standard_normal(
        (b, h, w)).astype(np.float32)).to(cuda_device)
    x[0, 0, ::7] = 0.0
    plan = FftPlan.for_shape(h, w, cuda_device)
    assert torch.equal(tfk.fft_rows(x, plan), tfk.fft_rows_plain(x, plan))


def _one_colour(b, h, w):
    rgb = np.empty((b, 3, h, w), np.uint8)
    rgb[:, 0], rgb[:, 1], rgb[:, 2] = 201, 77, 30
    return rgb


def _stripes(b, h, w):
    """Two colours in vertical stripes 5 px wide."""
    rgb = _one_colour(b, h, w)
    rgb[..., (np.arange(w) // 5) % 2 == 1] = np.array(
        [20, 90, 180], np.uint8)[:, None, None]
    return rgb


def _assert_palette_sums_all_routes(u8, cfg, device):
    """Every route of the palette-sums kernel against its plain version, bit
    for bit: K3 (q=1) and K4 (q=8, q_full) on uint8 and float32 RGB, K10
    (q=8, q_full) and K14 on flat HSV with a sentinel tail."""
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv, \
        u8_to_unit_f32

    c = cfg.num_cells
    x = torch.from_numpy(u8).to(device)
    b, _, h, w = x.shape
    tt = tq.OctreeTables.for_config(cfg, device)
    counts, _ = tpk.cell_counts_s_from_rgb(x, cfg)
    assign = tq.parent_assignment_from_order(
        counts, margin_sort(tq.saliency_f32(counts, tt.s_v_f32, cfg)), h * w,
        cfg, tt)
    _, q_full = tq.palette_widths(cfg)
    f32 = u8_to_unit_f32(x).contiguous()
    flat = f32.reshape(b, 3, -1)
    pad = torch.rand((3, b, 777), device=device)
    pad[0] = -1.0
    hsv = [torch.cat([t, p], dim=1).contiguous() for t, p in
           zip(rgb_to_hsv(flat[:, 0], flat[:, 1], flat[:, 2]), pad)]
    runs = [(tpk.palette_sums_by_k_rgb_q1, tpk.palette_sums_by_k_rgb_q1_plain,
             rgb, tpk.palette_offset_table(assign, tt, c)) for rgb in (x, f32)]
    for q in (8, q_full):
        tabs = tpk.palette_candidate_table(assign, tt, c, q)
        runs += [(tpk.palette_sums_by_k_rgb, tpk.palette_sums_by_k_rgb_plain,
                  rgb, tabs) for rgb in (x, f32)]
        runs.append((tpk.palette_sums_by_k, tpk.palette_sums_by_k_plain, hsv,
                     tabs))
    runs.append((tpk.palette_sums_by_k_cwide,
                 tpk.palette_sums_by_k_cwide_plain, hsv,
                 tpk.cwide_tables(assign, tt)))
    for kern, plain, px, tabs in runs:
        px = px if isinstance(px, list) else [px]
        assert torch.equal(kern(*px, *tabs, cfg), plain(*px, *tabs, cfg)), \
            kern.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_one_colour, _stripes, noise_rgb])
@pytest.mark.parametrize("b,h,w", [(2, 61, 67), (1, 360, 512)])
def test_cuda_palette_sums_routes_bit_equal(make, b, h, w, cuda_device):
    """The palette-sums kernel on a one-colour frame (one slot for every
    lane), two-colour stripes (two slots a warp) and noise, at 61x67 (a
    pixel count that is no multiple of the 4-pixel loads or of a block's
    run) and 360x512."""
    u8 = make(b, h, w)
    if u8.dtype != np.uint8:
        u8 = np.round(u8 * 255).astype(np.uint8)
    _assert_palette_sums_all_routes(u8, TCFG, cuda_device)


@pytest.mark.cuda
def test_cuda_palette_sums_routes_c2164(cuda_device):
    """At C=2164 (h_partitions=360) K4's candidate table and K14's bitmask
    are read from device memory."""
    u8 = np.round(noise_rgb(1, 64, 255, seed=13) * 255).astype(np.uint8)
    _assert_palette_sums_all_routes(u8, ReportConfig(h_partitions=360),
                                    cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_one_colour, _stripes, noise_rgb])
@pytest.mark.parametrize("b,h,w", [(2, 61, 67), (4, 360, 512)])
def test_cuda_cell_counts_routes_bit_equal(make, b, h, w, cuda_device):
    """The cell histogram bit for bit against its plain versions on a
    one-colour frame (one run of lanes a warp), stripes and noise: K1 on
    uint8, K11 on its float32 planes, K9 on its flat HSV with a sentinel
    tail, K15 on those pixels' cell ids (sentinels -> C)."""
    from photohive_dsp_tpu_torch.ops.colorspace import u8_to_unit_f32

    u8 = make(b, h, w)
    if u8.dtype != np.uint8:
        u8 = np.round(u8 * 255).astype(np.uint8)
    x = torch.from_numpy(u8).to(cuda_device)
    f32 = u8_to_unit_f32(x).contiguous()
    for rgb in (x, f32):
        for got, want in zip(tpk.cell_counts_s_from_rgb(rgb, TCFG),
                             tpk.cell_counts_s_from_rgb_plain(rgb, TCFG)):
            assert torch.equal(got, want), rgb.dtype
    hsv = _flat_hsv_with_tail(f32.cpu().numpy(), cuda_device)
    assert torch.equal(tpk.cell_counts_from_hsv(*hsv, TCFG),
                       tpk.cell_counts_from_hsv_plain(*hsv, TCFG))
    real = hsv[0] >= 0
    ids = torch.where(real, tq.assign_cells(torch.where(real, hsv[0], 0.0),
                                            hsv[1], hsv[2], TCFG), C)
    ids = ids.to(torch.int32).contiguous()
    assert torch.equal(tpk.cell_counts_batched(ids, C),
                       tpk.cell_counts_batched_plain(ids, C))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one bin", "below the gate",
                                  "ids out of range", "odd length"])
def test_cuda_polar_edges_bit_equal(case, cuda_device):
    """K7+K8's sums, maxima and means bit for bit against the plain
    versions: every pixel in one bin (one run a warp), a spectrum below the
    gate everywhere, ids outside [0, A*R), and a pixel count that is no
    multiple of the 4-pixel loads."""
    h, w = 360, 512
    cfg = ReportConfig()
    x = np.random.default_rng(11).standard_normal((2, h, w)).astype(
        np.float32)
    mag2 = tfk.magnitude2(torch.from_numpy(x).to(cuda_device),
                          FftPlan.for_shape(h, w, cuda_device)).reshape(2, -1)
    tables = PolarTables.for_shape(h, w, cfg, cuda_device)
    ids, counts = tables.bin_ids, tables.bin_counts
    nb = counts.shape[0]
    if case == "one bin":
        ids = torch.full_like(ids, 7)
    elif case == "below the gate":
        mag2 = mag2 / (mag2.amax() * 1.01)
    elif case == "ids out of range":
        ids = ids.clone()
        ids[::3] = -1
        ids[1::7] = nb + 5
    else:
        mag2 = mag2[:, :-3].contiguous()
        ids = ids[:-3].contiguous()
    got, mx = tpolar.polar_bin_sums_lognorm(mag2, ids, nb)
    want, mx0 = tpolar.polar_bin_sums_lognorm_plain(mag2, ids, nb)
    assert torch.equal(got, want) and torch.equal(mx, mx0)
    assert torch.equal(tpolar.polar_bin_means_lognorm(mag2, ids, counts),
                       tpolar.polar_bin_means_lognorm_plain(mag2, ids,
                                                            counts))
