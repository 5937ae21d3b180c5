"""The CUDA kernels (K1-K15) against their plain PyTorch versions on an
NVIDIA GPU, the row-sharded report at world size 1 (NCCL) against the
single-device path, the data-parallel and dp x spatial steps at world
size 1, the single-image full_report on float32 frames, get_report's
reused staging block, BatchRunner on the card against the CPU path, each
kernel's registered operator under torch.library.opcheck, and a serving
artifact exported for the card against the live path.  Every test here
needs the card and nvcc and skips without them; this file imports no JAX,
so the machine with the card runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The image generators are shared with tests/test_torch_palette.py."""

from . import torch_threads  # noqa: F401 (this worker's cores)

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

from tests.test_torch_margin_sort import KINDS, SORT_CS, sort_data
from tests.test_torch_library import CASES as LIBRARY_CASES, op_cases

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
@pytest.mark.parametrize("c", SORT_CS + [2500, 9000])
def test_cuda_margin_sort_any_c(c, cuda_device):
    """K2 bit-equal to its plain version on each side of every bucket's
    edge (tests/test_torch_margin_sort.py), on each data kind."""
    for kind in KINDS:
        sal = torch.from_numpy(sort_data(kind, 3, c)).to(cuda_device)
        assert torch.equal(margin_sort(sal), margin_insertion_argsort(sal)), \
            kind


def _snr_db(want: torch.Tensor, got: torch.Tensor) -> float:
    want, got = want.double().cpu(), got.double().cpu()
    err = float(torch.linalg.vector_norm(want - got))
    sig = float(torch.linalg.vector_norm(want))
    return float("inf") if err == 0 else 20 * np.log10(sig / err)


# chip_smoke.COL_FFT_EDGES: heights that reach each of K6b's passes and
# tile layouts, half widths that are no multiple of the tile.
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [
    (2, 1080, 1920), (2, 1092, 1001), (1, 91, 375),
    (1, 1080, 30), (1, 2160, 10), (1, 4320, 6), (1, 7000, 6), (1, 14520, 4),
    (1, 720, 9), (1, 480, 9), (1, 143, 9), (1, 1001, 9), (1, 64, 9),
    (1, 12, 9), (1, 10, 9), (1, 14, 9), (1, 15, 9), (1, 9, 9), (1, 7, 9),
    (1, 11, 9), (1, 13, 9), (1, 5, 9), (1, 3, 9), (1, 2, 9), (1, 1, 9)])
def test_cuda_fft_kernels_match_plain(b, h, w, cuda_device):
    """K6a and K6b repeat their plain versions' float32 operations in the
    same order: K6a agrees to the rounding of the peak, K6b bit for bit,
    and both hold the JAX package's 90 dB bar against float64 rfft2."""
    x = np.random.default_rng(11).standard_normal((b, h, w)).astype(
        np.float32)
    xd = torch.from_numpy(x).to(cuda_device)
    plan = FftPlan.for_shape(h, w, cuda_device)
    spec, spec0 = tfk.fft_rows(xd, plan), tfk.fft_rows_plain(xd, plan)
    assert float((spec - spec0).abs().max()) <= 1e-6 * float(
        spec0.abs().max())
    mag, mag0 = tfk.fft_cols(spec0, plan), tfk.fft_cols_plain(spec0, plan)
    assert torch.equal(mag, mag0)
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
    without a halo, at row offsets 0 and 3, on 1080x1000 frames."""
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
def test_cuda_sharpness_kernel_box_sets(cuda_device):
    """K5, one launch a call, on rows that are 16-byte aligned and rows that
    are not (width 1001), with box sets that change from call to call (its
    tickets are zero again after every launch): within 1e-5 relative of
    plain, zero where plain is zero."""
    rng = np.random.default_rng(21)
    for b, h, w in ((3, 1092, 1001), (2, 300, 512)):
        pgm = torch.from_numpy(rng.random((b, h, w), dtype=np.float32))
        for n in (10, 1, 4):
            boxes = torch.zeros((b, 10, 4), dtype=torch.int32)
            for i in range(b):
                for k in range(n):
                    y0, x0 = rng.integers(-5, h - 4), rng.integers(-5, w - 4)
                    boxes[i, k] = torch.tensor([
                        y0, y0 + rng.integers(4, h), x0,
                        x0 + rng.integers(4, w)])
            _cuda.reset_launch_counts()
            got = tsk.sharpness_sums(pgm.to(cuda_device),
                                     boxes.to(cuda_device))
            assert _cuda.LAUNCHES["sharpness_sums"] == 1
            want = tsk.sharpness_sums_plain(pgm, boxes)
            for g, wt in zip(got, want):
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
def test_cuda_full_report_float32_frames(cuda_device):
    """The single-image API on the card: jitted_full_report's default
    device is the card; full_report on float32 frames (a structured frame:
    q=1, noise: q=8, a hue wheel: q_full) launches the float32 palette
    kernels (K11-K13), K2, K5 and the blur kernels and no uint8 kernel, and
    equals full_report_batched at B=1 bit for bit and the CPU path's ids,
    counts and blur vectors."""
    from photohive_dsp_tpu_torch.models import pipeline as tpipe

    from tests.util import structured_image

    h, w = 360, 512
    cfg = ReportConfig()
    cached = tpipe.jitted_full_report(h, w, cfg)
    assert tpipe.jitted_full_report(h, w, cfg) is cached
    fn, tables = cached
    assert tables.polar.bin_ids.is_cuda
    frames = [structured_image(h, w, seed=3).astype(np.float32),
              noise_rgb(1, h, w, seed=9)[0], wheel_rgb(1, h, w)[0]]
    boxes = [tpipe.empty_boxes(), pt.set_bounding_boxes([
        dict(top=40, bottom=200, left=60, right=300),
        dict(top=0, bottom=90, left=384, right=512)])]
    _cuda.reset_launch_counts()
    got = [fn(torch.from_numpy(f).to(cuda_device), *b, tables)
           for f in frames for b in boxes]
    torch.cuda.synchronize()
    for name in ("cell_counts_s_f32", "margin_sort", "palette_sums_q1_f32",
                 "palette_sums_q8_f32", "palette_sums_qfull_f32",
                 "sharpness_sums", "fft_rows", "fft_cols", "polar_bins"):
        assert _cuda.LAUNCHES[name] >= 1, name
    for name in ("cell_counts_s", "palette_sums_q1", "palette_sums_q8",
                 "palette_sums_qfull"):
        assert _cuda.LAUNCHES[name] == 0, name
    cpu_tables = pt.ReportTables.build(h, w, cfg)
    for (f, b), rep in zip([(f, b) for f in frames for b in boxes], got):
        x = torch.from_numpy(f).to(cuda_device)
        batched = pt.full_report_batched(x[None], b[0][None], b[1][None],
                                         tables, cfg)
        for name, a, c in zip(rep._fields, rep, batched):
            assert torch.equal(a, c[0]), name
        ref = pt.full_report(torch.from_numpy(f), *b, cpu_tables, cfg)
        for k in ("palette_n", "palette_ids", "palette_pct",
                  "blur_vector_angles", "blur_vector_mags"):
            assert torch.equal(getattr(rep, k).cpu(), getattr(ref, k)), k
        assert float((rep.palette_hsv.cpu() - ref.palette_hsv).abs().max()) \
            < 5e-3
        assert torch.allclose(rep.sharpness.cpu(), ref.sharpness, rtol=1e-4,
                              atol=0)
        assert _snr_db(ref.blur_bins, rep.blur_bins) >= 60


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


@pytest.mark.cuda
def test_cuda_mesh_world_size_1(cuda_device):
    """On one NCCL rank: the data-parallel report equals
    full_report_batched and the dp x spatial step equals
    build_spatial_report image by image, bit for bit, with the deferred
    palette pass's K9 and K10 launched once for the batch."""
    import torch.distributed as dist

    from photohive_dsp_tpu_torch.parallel import mesh, sharding, spatial

    h, w = 487, 640
    cfg = ReportConfig()
    imgs = np.round(np.concatenate([smooth_rgb(1, h, w), noise_rgb(1, h, w)])
                    * 255).astype(np.uint8)
    one = pt.set_bounding_boxes([
        dict(top=40, bottom=200, left=60, right=300),
        dict(top=300, bottom=487, left=100, right=630)])
    boxes, valid = np.stack([one[0]] * 2), np.stack([one[1]] * 2)
    mesh.initialize_distributed(num_processes=1, device=cuda_device)
    try:
        m = mesh.make_mesh()
        u8 = torch.from_numpy(imgs).to(cuda_device).permute(0, 2, 3, 1)
        fn, tables = sharding.data_parallel_report_u8(h, w, cfg, m,
                                                      cuda_device)
        dp = fn(u8, boxes, valid, tables)
        single = spatial.build_spatial_report(m.spatial_group, h, w, cfg,
                                              cuda_device)
        alone = [single(imgs[i], boxes[i], valid[i]) for i in range(2)]
        dps_fn = spatial.build_dp_spatial_report(m, 2, h, w, cfg,
                                                 cuda_device)
        _cuda.reset_launch_counts()
        dps = dps_fn(imgs, boxes, valid)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["cell_counts_hsv"] == 1
        assert _cuda.LAUNCHES["palette_sums_flat_q8"] \
            + _cuda.LAUNCHES["palette_sums_flat_qfull"] == 1
        assert _cuda.LAUNCHES["sharpness_sums"] == 2
    finally:
        dist.destroy_process_group()
    ref = pt.full_report_batched(torch.from_numpy(imgs).to(cuda_device),
                                 boxes, valid, tables, cfg)
    for k in ref._fields:
        assert torch.equal(getattr(dp, k), getattr(ref, k)), k
        for i in range(2):
            assert torch.equal(getattr(dps, k)[i], getattr(alone[i], k)), \
                (i, k)


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
def test_cuda_get_report_reuses_its_staging_block(cuda_device):
    """Three different uint8 frames (RGB, RGBA, a flipped RGB frame)
    through get_report in a row, each staged in the pinned block the
    caching host allocator hands back and made planar on the card: each
    report equals full_report's on its own host planar frame sent by a
    pageable copy, bit for bit, and its own CPU report at the port's bars,
    so no frame's copy read a block the next frame had refilled."""
    from tests.util import structured_image

    h, w = 360, 512
    u8 = [np.ascontiguousarray(np.moveaxis(np.round(x * 255), 0, -1)
                               ).astype(np.uint8)
          for x in (noise_rgb(1, h, w, seed=8)[0], wheel_rgb(1, h, w)[0],
                    structured_image(h, w, seed=3))]
    frames = [u8[0], np.dstack([u8[1], np.full((h, w), 7, np.uint8)]),
              u8[2][::-1]]
    boxes = pt.set_bounding_boxes([dict(top=10, bottom=300, left=20,
                                        right=480)])
    cfg = ReportConfig()
    _cuda.reset_launch_counts()
    reps = [pt.get_report(f, boxes, config=cfg) for f in frames]
    assert _cuda.LAUNCHES["entry_hwc"] == 3
    tables = pt.cached_tables(h, w, cfg, cuda_device)
    for f, rep in zip(frames, reps):
        planar = np.ascontiguousarray(np.moveaxis(f[:, :, :3], -1, 0))
        old = pt.full_report(torch.from_numpy(planar).to(cuda_device),
                             *boxes, tables, cfg)
        assert rep.to_json() == pt.Report(old, h, w, 1, cfg).to_json()
        ref = pt.get_report(f, boxes, config=cfg, device="cpu")
        assert rep.color_palette.cell_ids == ref.color_palette.cell_ids
        assert rep.color_palette.quantities == ref.color_palette.quantities
        assert np.abs(np.subtract(rep.color_palette.hsv,
                                  ref.color_palette.hsv)).max() < 5e-3
        assert np.isclose(rep.average_saturation, ref.average_saturation,
                          rtol=1e-6, atol=0)
        assert np.allclose(rep.sharpnesses, ref.sharpnesses, rtol=1e-4,
                           atol=0)
        assert [(v.angle, v.magnitude) for v in rep.blur_vectors] == \
            [(v.angle, v.magnitude) for v in ref.blur_vectors]
        assert _snr_db(torch.tensor(ref.blur_profile.bins),
                       torch.tensor(rep.blur_profile.bins)) >= 60


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
    ref = tbatch.BatchRunner(TCFG, device="cpu").run_u8(images, bx, vd)
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", LIBRARY_CASES)
def test_cuda_opcheck_and_plain(name, cuda_device):
    """Each kernel's registered operator on the card under
    torch.library.opcheck (the fake implementation against the launch, a
    symbolic batch through AOT dispatch), and its CUDA implementation
    against its CPU one (the plain version) on the same inputs: K5 and the
    masked sharpness route (float32 sums in another order on the card)
    within 1e-5 relative, the rest bit for bit (K7+K8 against its plain
    version on the card's tensors)."""
    op, args = op_cases(cuda_device)[name]
    torch.library.opcheck(op, args)
    got = op(*args)
    if name.startswith("polar"):
        # log differs by an ulp between the CPU and the card: the plain
        # version on the card's tensors.
        mag2, ids, counts, nb = args
        acc, mx = tpolar.polar_bin_sums_lognorm_plain(mag2, ids, nb,
                                                      fixed=True)
        want = (acc, mx, tpolar.polar_bin_sums_lognorm_plain(mag2, ids, nb)[0]
                if counts is None else
                tpolar.polar_bin_means_lognorm_plain(mag2, ids, counts))
    else:
        want = op(*(a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args))
    for g, w in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        g, w = g.cpu(), w.cpu()
        if "sharpness" in name:
            assert bool(((g - w).abs() <= 1e-5 * w.abs()).all()), name
        else:
            assert torch.equal(g, w), name


@pytest.mark.cuda
def test_cuda_serving_artifact_equals_live(cuda_device):
    """A dynamic-batch artifact exported for the card runs the kernels
    (each of the main path's counted) and equals the live path bit for
    bit at B=1 and 3, with boxes, a thin box and none."""
    from photohive_dsp_tpu_torch.serving import export_report, load_report

    h, w = 360, 480
    cfg = ReportConfig()
    fn = load_report(export_report(h, w, cfg, batch_size="dynamic",
                                   device=cuda_device))
    tables = pt.ReportTables.build(h, w, cfg, cuda_device)
    u8 = np.round(np.concatenate([smooth_rgb(1, h, w), wheel_rgb(1, h, w),
                                  noise_rgb(1, h, w)]) * 255).astype(np.uint8)
    boxes = np.zeros((3, 10, 4), np.int32)
    valid = np.zeros((3, 10), bool)
    boxes[1:, 0] = (20, 200, 30, 300)
    boxes[2, 1] = (100, 102, 0, 480)
    valid[1:, 0] = valid[2, 1] = True
    _cuda.reset_launch_counts()
    for b, rows in ((1, slice(0, 1)), (3, slice(0, 3)), (2, slice(1, 2))):
        x = torch.from_numpy(u8[rows]).to(cuda_device).permute(
            0, 2, 3, 1).contiguous()
        bx = torch.from_numpy(boxes[rows])
        vd = torch.from_numpy(valid[rows])
        got = fn(x, bx, vd)
        want = pt.full_report_batched(x.permute(0, 3, 1, 2).contiguous(), bx,
                                      vd, tables, cfg)
        for k, g, wnt in zip(want._fields, got, want):
            assert torch.equal(g, wnt), (b, k)
    for counter in ("cell_counts_s", "margin_sort", "palette_sums_q1",
                    "palette_sums_qfull", "sharpness_sums", "fft_rows",
                    "fft_cols", "polar_bins"):
        assert _cuda.LAUNCHES[counter] > 0, counter
