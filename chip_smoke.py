"""Smoke test of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Drives photohive_dsp_tpu_torch's paths through their CUDA kernels — the
main path (get_report on 1080x1920 frames and full_report_batched on a
batch of 8, with and without crop boxes) and the row-sharded report
(parallel/spatial.build_spatial_report, one NCCL rank, a 4320x7680 frame)
— and checks every result against a reference.  Phases, each of which
raises on failure:

  1. device: a CUDA device must be present; prints its name and power limit;
  2. build: compiles the kernels from photohive_dsp_tpu_torch/csrc;
  3. kernels against their plain versions on the card: the palette kernels
     (K1-K4) at 1080x1920, B=4, float32 and uint8 input; the crop-box
     sharpness kernel (K5) at 1080x1920 B=4 with three boxes, one on the
     image's edge (twice, bit-identical); the flat-HSV palette kernels (K9,
     K10) at 1080x1920 B=4 with a sentinel tail (which must change
     nothing); the FFT kernels (K6a, K6b) and the polar kernel (K7+K8) at
     1080x1920 B=4, 2160x3840 B=1 and 1092x1001 B=2, the FFT also against
     float64 rfft2 (>= 90 dB), the polar sums twice (bit-identical), a zero
     frame, and a 360x100-bin table (the polar kernel's global-atomics
     branch);
  4. main path against the CPU path, with the kernel launch counts of that
     run (each of its kernels at least once, K5 included);
  5. spatial path: build_spatial_report at world size 1 on 4320x7680 frames
     (boxes, a thin box, a full-width tie tier) against the single-device
     full_report_batched on the card, with the launch counts of that run
     (K9 and K10 at both widths at least once); then K5, K7+K8, K9 and K10
     against their plain versions on the inputs the rank hands them there
     (33 MP of flat HSV, the luma with its halo, the rank's |X|^2);
  6. timing: warm get_report latency, batch-8 throughput, the spatial
     call's wall time, the blur and sharpness stages by their plain routes
     and by the kernels at B=1 and B=8, and each kernel's time beside its
     plain version's, its bound and a library call's.

Prints the kernels' JSON line, the card's name and power limit, and, last,
{"ok": true, "device": {...}}.  Exits nonzero without that line when a
phase fails or no CUDA device is present.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 1080, 1920
SH, SW = 4320, 7680       # the spatial path's frame: 33 MP
SEED = 0
DEVICE = "cuda"
K1_S_RTOL = 1e-6          # saturation sum vs its plain version
SUMS_RTOL = 1e-5          # palette hue/s/v sums vs their plain versions
# The FFT kernels equal their plain versions bit for bit (the same float32
# operations in the same order); both meet the JAX package's bar against
# float64 rfft2 (tests/test_pallas_fft.py).
FFT_SNR_DB = 90.0
POLAR_RTOL = 1e-6         # polar sums vs plain: logf rounding only
# K5's s1, s2 vs plain: float32 per-thread sums there, float64 here.
SHARP_RTOL = 1e-5
SENTINEL_TAIL = 4096      # hue-sentinel pixels after K9/K10's real ones
BLUR_SHAPES = [(1080, 1920, 4), (2160, 3840, 1), (1092, 1001, 2)]
# Peak rates of an H100 SXM (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations per pixel of the palette kernels' front end
# (csrc/hsv_cells.cuh pixel_hsv_cell, counted from the source: 3 decodes,
# 4 max/min, 5 for the hue, 1 for s, 12 for the cell id), of one slot
# update (wrapped hue, 3 fixed-point conversions) and of one K4 candidate
# distance (3 differences, abs, fold, scale, 3 squares, 2 adds, compare).
OPS_CELL_PX = 25
OPS_CELL_ID = 12
OPS_SLOT_PX = 6
OPS_CANDIDATE = 13
# float32 operations of K5 per pixel of box area (csrc/sharpness.cu: three
# masked row triples and the column sum 8, 9x - box 2, the square and its
# sum 2, rows_in/cols_in 4, the weight 2, its product and sum 2).
OPS_SHARP_PX = 20


def main_boxes(h: int, w: int):
    """Three crop boxes, none thin, the last on the image's top and right
    edges."""
    return [dict(top=h // 10, bottom=h * 2 // 3, left=w // 10,
                 right=w * 5 // 8),
            dict(top=h * 3 // 10, bottom=h * 5 // 6, left=w // 2,
                 right=w - 20),
            dict(top=0, bottom=h // 4, left=w * 3 // 4, right=w)]


def thin_box(h: int, w: int):
    return dict(top=h // 2, bottom=h // 2 + 2, left=w // 20,
                right=w * 3 // 4)                                # 2 px


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- inputs ---

def noise_image(rng, h=H, w=W) -> np.ndarray:
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def structured_image(rng) -> np.ndarray:
    """Gradient + four flat colour blobs + mild noise: few populated cells,
    none of them tied, so the palette takes the q=1 tier."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    r = 0.25 + 0.5 * (x / W)
    g = 0.25 + 0.5 * (y / H)
    b = 0.35 + 0.25 * np.sin(2 * np.pi * x / 97) * np.cos(2 * np.pi * y / 61)
    for cy, cx, rad, col in [(0.3, 0.3, 0.11, (0.9, 0.1, 0.1)),
                             (0.7, 0.6, 0.15, (0.1, 0.8, 0.2)),
                             (0.4, 0.8, 0.09, (0.15, 0.2, 0.9)),
                             (0.8, 0.2, 0.07, (0.95, 0.85, 0.1))]:
        m = (y - cy * H) ** 2 + (x - cx * W) ** 2 < (rad * H) ** 2
        r[m], g[m], b[m] = col
    rgb = np.stack([r, g, b], axis=-1) + rng.normal(0, 0.01, (H, W, 3))
    return np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def hue_wheel_image(rng, h=H, w=W) -> np.ndarray:
    """All 18 hues at one (s, v) plus a gray band: the gray cell is
    populated but not a parent and ties across every hue, so the palette
    needs the full candidate width."""
    hue = np.broadcast_to(np.arange(w)[None, :] / w * 360.0, (h, w))
    s, v = 0.8, 0.8
    c = v * s
    xx = c * (1 - np.abs((hue / 60) % 2 - 1))
    sec = (hue // 60).astype(int) % 6
    r = np.choose(sec, [c, xx, 0, 0, xx, c])
    g = np.choose(sec, [xx, c, c, xx, 0, 0])
    b = np.choose(sec, [0, 0, xx, c, c, xx])
    rgb = np.stack([r, g, b], axis=-1) + (v - c)
    rgb[: h // 40] = 0.5
    rgb = rgb + rng.normal(0, 0.002, rgb.shape).astype(np.float32)
    return np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def planar(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(img, -1, 0))


# --------------------------------------------------------------- checks ---

def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())


def snr_db(want: torch.Tensor, got: torch.Tensor) -> float:
    want, got = want.double().cpu(), got.double().cpu()
    err = float(torch.linalg.vector_norm(want - got))
    sig = float(torch.linalg.vector_norm(want))
    return float("inf") if err == 0 else 20 * float(np.log10(sig / err))


def luma_dc(images) -> torch.Tensor:
    """(B, H, W) luma of uint8 frames on the card, mean removed."""
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_pgm, \
        u8_to_unit_f32

    rgb = u8_to_unit_f32(torch.as_tensor(
        np.stack([planar(im) for im in images]), device=DEVICE))
    pgm = rgb_to_pgm(rgb[:, 0], rgb[:, 1], rgb[:, 2])
    return (pgm - pgm.mean(dim=(1, 2), keepdim=True)).contiguous()


def report_fields(rep) -> dict:
    """The report values compared, from a Report (one get_report call)."""
    cp, st = rep.color_palette, rep.rgb_stats
    return dict(
        palette_ids=np.array(cp.cell_ids), palette_n=cp.N,
        palette_pct=np.array(cp.quantities),
        palette_hsv=np.array(cp.hsv).reshape(-1, 3),
        average_saturation=np.array(rep.average_saturation),
        rgb_stats=np.array([st.Br, st.Bg, st.Bb, st.Cr, st.Cg, st.Cb]),
        sharpness=np.array(rep.sharpnesses),
        blur_bins=np.array(rep.blur_profile.bins),
        blur_vector_angles=np.array([v.angle for v in rep.blur_vectors]),
        blur_vector_mags=np.array([v.magnitude for v in rep.blur_vectors]))


def data_fields(data, i: int) -> dict:
    """The same values from row i of a batched ReportData."""
    row = {k: v[i].detach().cpu().numpy() for k, v in data._asdict().items()}
    n = int(row["palette_n"])
    out = dict(row, palette_n=n)
    for k in ("palette_ids", "palette_pct", "palette_hsv"):
        out[k] = row[k][:n]
    return out


def compare_reports(gpu: dict, cpu: dict, label: str,
                    against: str = "the CPU path") -> None:
    """A report of the port on the card against a reference report (by
    default the same call on the CPU), at the bars the port is held to
    against the JAX package."""
    for f in ("palette_ids", "palette_n", "palette_pct"):
        if not np.array_equal(gpu[f], cpu[f]):
            raise AssertionError(f"{label}: {f} differs from {against}")
    hsv = np.abs(gpu["palette_hsv"] - cpu["palette_hsv"]).max()
    if not hsv < 5e-3:
        raise AssertionError(f"{label}: palette_hsv off by {hsv}")
    sat = np.abs(gpu["average_saturation"] / cpu["average_saturation"]
                 - 1).max()
    if not sat < 1e-6:
        raise AssertionError(f"{label}: average_saturation rel err {sat}")
    st = np.abs(gpu["rgb_stats"] / cpu["rgb_stats"] - 1).max()
    if not st < 1e-5:
        raise AssertionError(f"{label}: rgb_stats rel err {st}")
    if not np.allclose(gpu["sharpness"], cpu["sharpness"], rtol=1e-4,
                       atol=0):
        raise AssertionError(f"{label}: sharpness {gpu['sharpness']} vs "
                             f"{cpu['sharpness']}")
    ref = cpu["blur_bins"].astype(np.float64)
    err = np.linalg.norm(gpu["blur_bins"] - ref)
    snr = np.inf if err == 0 else 20 * np.log10(np.linalg.norm(ref) / err)
    if not snr >= 60:
        raise AssertionError(f"{label}: blur_bins SNR {snr} dB")
    for f in ("blur_vector_angles", "blur_vector_mags"):
        if not np.array_equal(gpu[f], cpu[f]):
            raise AssertionError(f"{label}: {f} differs from {against}")
    if not (np.isfinite(gpu["blur_bins"]).all()
            and np.isfinite(gpu["rgb_stats"]).all()):
        raise AssertionError(f"{label}: non-finite report values")
    log(f"  {label}: matches {against} (hsv {hsv:.2e}, sat {sat:.2e}, "
        f"stats {st:.2e}, blur {snr:.1f} dB)")


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phases ---

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    return smi


def phase_build() -> None:
    from photohive_dsp_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {path}")


def phase_kernels(images, cfg, tables):
    """Each kernel against its plain version on the card; returns per-kernel
    max abs error and the inputs the timing phase reuses."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import quantize as qz
    from photohive_dsp_tpu_torch.ops.margin_sort import (
        margin_insertion_argsort, margin_sort)

    c = cfg.num_cells
    _, q_full = qz.palette_widths(cfg)
    u8 = torch.as_tensor(np.stack([planar(im) for im in images]),
                         device=DEVICE)
    f32 = (u8.float() / 255.0).contiguous()
    err = {k: 0.0 for k in ("K1", "K2", "K3", "K4q8", "K4qfull")}
    for name, x in (("f32", f32), ("u8", u8)):
        counts, s_sum = pk.cell_counts_s_from_rgb(x, cfg)
        counts0, s_sum0 = pk.cell_counts_s_from_rgb_plain(x, cfg)
        sync()
        if not torch.equal(counts, counts0):
            raise AssertionError(f"K1 {name}: counts differ")
        if not rel_err(s_sum, s_sum0) < K1_S_RTOL:
            raise AssertionError(f"K1 {name}: s_sum rel err "
                                 f"{rel_err(s_sum, s_sum0)}")
        err["K1"] = max(err["K1"], float((s_sum - s_sum0).abs().max()))

        sal = qz.saliency_f32(counts, tables.octree.s_v_f32, cfg)
        order = margin_sort(sal)
        if not torch.equal(order, margin_insertion_argsort(sal)):
            raise AssertionError(f"K2 {name}: order differs at C={c}")
        assign = qz.parent_assignment_from_order(counts, order, H * W, cfg,
                                                 tables.octree)
        slot, off = pk.palette_offset_table(assign, tables.octree, c)
        runs = [("K3", pk.palette_sums_by_k_rgb_q1,
                 pk.palette_sums_by_k_rgb_q1_plain, (slot, off))]
        for key, q in (("K4q8", 8), ("K4qfull", q_full)):
            runs.append((key, pk.palette_sums_by_k_rgb,
                         pk.palette_sums_by_k_rgb_plain,
                         pk.palette_candidate_table(assign, tables.octree,
                                                    c, q)))
        for key, kern, plain, tabs in runs:
            got = kern(x, *tabs, cfg)
            want = plain(x, *tabs, cfg)
            sync()
            if not torch.equal(got[..., 3], want[..., 3]):
                raise AssertionError(f"{key} {name}: counts differ")
            bad = (got - want).abs() > SUMS_RTOL * want.abs()
            if bool(bad.any()):
                raise AssertionError(f"{key} {name}: sums rel err "
                                     f"{rel_err(got, want)}")
            err[key] = max(err[key], float((got - want).abs().max()))
        log(f"  kernels {name}: K1-K4 match their plain versions")
    rng = np.random.default_rng(SEED + 1)
    big = torch.as_tensor(np.round(rng.random((4, 2164)) * 30)
                          + rng.random((4, 2164)) * 0.6, dtype=torch.float32,
                          device=DEVICE)
    if not torch.equal(margin_sort(big), margin_insertion_argsort(big)):
        raise AssertionError("K2: order differs at C=2164")
    log("  K2 exact at C=112 and C=2164")
    return err, dict(u8=u8, slot=slot, off=off, sal=sal, assign=assign,
                     counts=counts)


def luma(images) -> torch.Tensor:
    """(B, H, W) luma of uint8 frames on the card (sharpness's input)."""
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_pgm, \
        u8_to_unit_f32

    rgb = u8_to_unit_f32(torch.as_tensor(
        np.stack([planar(im) for im in images]), device=DEVICE))
    return rgb_to_pgm(rgb[:, 0], rgb[:, 1], rgb[:, 2]).contiguous()


def phase_sharpness_kernel(images):
    """K5 against its plain version at 1080x1920 B=4 with main_boxes (one
    touching the top and right edges), twice (bit-identical); returns its
    max abs error and the inputs the timing phase reuses."""
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import sharpness_kernels as sk

    pgm = luma(images)
    boxes, valid = pt.set_bounding_boxes(main_boxes(H, W))
    bt = sk.box_tensor(np.stack([boxes] * len(images)),
                       np.stack([valid] * len(images)), DEVICE)
    got = sk.sharpness_sums(pgm, bt)
    again = sk.sharpness_sums(pgm, bt)
    want = sk.sharpness_sums_plain(pgm, bt)
    sync()
    err = 0.0
    for name, g, a, w in zip(("s1", "s2"), got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"K5 {name}: two launches differ")
        if not rel_err(g[:, :3], w[:, :3]) <= SHARP_RTOL:
            raise AssertionError(f"K5 {name}: rel err "
                                 f"{rel_err(g[:, :3], w[:, :3])}")
        if bool(g[:, 3:].any()):
            raise AssertionError(f"K5 {name}: empty slots not zero")
        err = max(err, float((g - w).abs().max()))
    log(f"  K5 B={len(images)} 3 boxes: bit-identical twice, rel err "
        f"{max(rel_err(g[:, :3], w[:, :3]) for g, w in zip(got, want)):.2e}")
    return err, dict(pgm=pgm, bt=bt, boxes=boxes, valid=valid)


def flat_hsv(x: torch.Tensor, tail: int):
    """(B, 3, H, W) uint8 -> flat h, s, v (B, H*W + tail) float32, the tail
    hue-sentinel pixels with random s and v."""
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv, \
        u8_to_unit_f32

    b = x.shape[0]
    flat = u8_to_unit_f32(x).reshape(b, 3, -1)
    hsv = rgb_to_hsv(flat[:, 0], flat[:, 1], flat[:, 2])
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    pad = torch.rand((3, b, tail), generator=gen, device=x.device)
    pad[0] = -1.0
    return [torch.cat([c, t], dim=1).contiguous() for c, t in zip(hsv, pad)]


def check_flat_kernels(hsv, assign, octree, cfg, label: str,
                       real=None) -> None:
    """K9 and K10 (q=8 and q_full) against their plain versions on flat HSV
    pixels: the int64 accumulators (counts and fixed-point sums) equal bit
    for bit, which also makes the percentages exact; with ``real`` (the
    pixels without their sentinel tail) both kernels equal their run on
    the real pixels alone."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import quantize as qz

    c = cfg.num_cells
    _, q_full = qz.palette_widths(cfg)
    runs = [("K9", pk.cell_counts_from_hsv, pk.cell_counts_from_hsv_plain,
             ())]
    runs += [(f"K10 q={q}", pk.palette_sums_by_k, pk.palette_sums_by_k_plain,
              pk.palette_candidate_table(assign, octree, c, q))
             for q in (8, q_full)]
    for key, kern, plain, tabs in runs:
        got = kern(*hsv, *tabs, cfg)
        want = plain(*hsv, *tabs, cfg)
        sync()
        if not torch.equal(got, want):
            raise AssertionError(f"{key} {label}: differs from plain, max "
                                 f"abs err {float((got - want).abs().max())}"
                                 f" (fixed-point units)")
        if real is not None and not torch.equal(got, kern(*real, *tabs,
                                                          cfg)):
            raise AssertionError(f"{key} {label}: the sentinel tail changes "
                                 f"the result")


def phase_flat_kernels(kin, cfg, tables):
    """K9 and K10 (q=8 and q_full) against their plain versions at
    1080x1920 B=4 on flat HSV with a sentinel tail (check_flat_kernels),
    and K9's counts against K1's on the same frames; returns max abs errors
    and the timing phase's inputs."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import quantize as qz

    _, q_full = qz.palette_widths(cfg)
    x = kin["u8"]
    p = x.shape[2] * x.shape[3]
    hsv = flat_hsv(x, SENTINEL_TAIL)
    real = [t[:, :p].contiguous() for t in hsv]
    check_flat_kernels(hsv, kin["assign"], tables.octree, cfg,
                       f"1080x1920 B={x.shape[0]}", real)
    counts, _ = pk.counts_s_from_fixed(pk.cell_counts_from_hsv(*hsv, cfg))
    if not torch.equal(counts, kin["counts"]):
        raise AssertionError("K9: counts differ from K1's on the RGB frames")
    log(f"  K9, K10 (q=8, q={q_full}) B={x.shape[0]} + {SENTINEL_TAIL} "
        f"sentinel px: accumulators equal their plain versions', K9 = K1's "
        f"counts, the tail changes nothing")
    return {"K9": 0.0, "K10q8": 0.0, "K10qfull": 0.0}, dict(hsv=hsv, p=p)


def phase_blur_kernels(images, cfg):
    """K6a, K6b and K7+K8 against their plain versions on the card at the
    BLUR_SHAPES; returns per-kernel max abs error at 1080x1920 B=4 and the
    inputs the timing phase reuses."""
    from photohive_dsp_tpu_torch.config import ReportConfig
    from photohive_dsp_tpu_torch.ops import fft_kernels as fk
    from photohive_dsp_tpu_torch.ops import polar_kernels as pk
    from photohive_dsp_tpu_torch.ops.blur import PolarTables, \
        blur_bins_lognorm
    from photohive_dsp_tpu_torch.ops.fft_plan import FftPlan

    a, r = cfg.angle_partitions, cfg.radius_partitions
    rng = np.random.default_rng(SEED + 2)

    def polar_check(flat, ids, nb, label):
        sums = pk.polar_bin_sums_lognorm(flat, ids, nb)
        again = pk.polar_bin_sums_lognorm(flat, ids, nb)
        want = pk.polar_bin_sums_lognorm_plain(flat, ids, nb)
        sync()
        if not torch.equal(sums, again):
            raise AssertionError(f"K7+K8 {label}: two launches differ")
        bad = (sums - want).abs() > POLAR_RTOL * want.abs()
        if bool(bad.any()):
            raise AssertionError(f"K7+K8 {label}: rel err "
                                 f"{rel_err(sums, want)}")
        return float((sums - want).abs().max()), rel_err(sums, want)

    err, kin = {}, {}
    for h, w, b in BLUR_SHAPES:
        label = f"{h}x{w} B={b}"
        if (h, w) == (H, W):
            x = luma_dc(images[:b])
        else:
            x = torch.as_tensor(rng.random((b, h, w), dtype=np.float32) - 0.5,
                                device=DEVICE)
        plan = FftPlan.for_shape(h, w, DEVICE)
        polar = PolarTables.for_shape(h, w, cfg, DEVICE)
        spec, spec0 = fk.fft_rows(x, plan), fk.fft_rows_plain(x, plan)
        mag, mag0 = fk.fft_cols(spec0, plan), fk.fft_cols_plain(spec0, plan)
        sync()
        e_rows = float((spec - spec0).abs().max())
        e_cols = float((mag - mag0).abs().max())
        if not torch.equal(spec, spec0):
            raise AssertionError(f"K6a {label}: differs from plain, max abs "
                                 f"err {e_rows}")
        if not torch.equal(mag, mag0):
            raise AssertionError(f"K6b {label}: differs from plain, max abs "
                                 f"err {e_cols}")
        want = torch.fft.rfft2(x.cpu().double()).abs().square()
        snr_k = snr_db(want, fk.magnitude2(x, plan))
        snr_p = snr_db(want, fk.magnitude2_plain(x, plan))
        if not min(snr_k, snr_p) >= FFT_SNR_DB:
            raise AssertionError(f"K6 {label}: {snr_k} dB (kernels), "
                                 f"{snr_p} dB (plain) vs float64")
        flat = mag.reshape(b, -1)
        e_polar, r_polar = polar_check(flat, polar.bin_ids, a * r, label)
        zero = blur_bins_lognorm(torch.zeros_like(x), plan, polar, a, r)
        sync()
        if not bool(torch.isfinite(zero).all()) or bool(zero.any()):
            raise AssertionError(f"{label}: zero frame gives nonzero bins")
        log(f"  {label}: K6a/K6b equal plain bit for bit; |rfft2|^2 "
            f"{snr_k:.1f} dB (plain {snr_p:.1f} dB) vs float64; K7+K8 "
            f"bit-identical twice, rel err {r_polar:.2e}; zero frame -> "
            f"zero bins")
        if (h, w) == (H, W):
            err = {"K6a": e_rows, "K6b": e_cols, "K7+K8": e_polar}
            kin = dict(x=x, plan=plan, polar=polar, spec=spec0, flat=flat)
    big = ReportConfig(angle_partitions=360, radius_partitions=100)
    nb = big.angle_partitions * big.radius_partitions
    ids = PolarTables.for_shape(H, W, big, DEVICE).bin_ids
    e_big, r_big = polar_check(kin["flat"], ids, nb, "360x100 bins")
    log(f"  K7+K8 global-atomics branch, {nb} bins ({8 * nb} B table): "
        f"bit-identical twice, rel err {r_big:.2e}")
    return err, kin


# The kernels each path must launch (ops/_cuda.LAUNCHES names).
MAIN_COUNTERS = ("cell_counts_s", "margin_sort", "palette_sums_q1",
                 "palette_sums_q8", "palette_sums_qfull", "sharpness_sums",
                 "fft_rows", "fft_cols", "polar_bins")
SPATIAL_COUNTERS = ("margin_sort", "sharpness_sums", "polar_bins",
                    "cell_counts_hsv", "palette_sums_flat_q8",
                    "palette_sums_flat_qfull")


def check_launches(launches: dict, counters, path: str) -> None:
    missing = [k for k in counters if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path}: {missing}")


def phase_main_path(images, cfg):
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import _cuda

    noise, structured, wheel = images[:3]
    boxes = pt.set_bounding_boxes(main_boxes(H, W))
    thin = pt.set_bounding_boxes(main_boxes(H, W)[:2] + [thin_box(H, W)])
    calls = [("noise", noise, None), ("structured", structured, None),
             ("structured+3 boxes", structured, boxes),
             ("noise+3 boxes", noise, boxes),
             ("structured+thin box", structured, thin),
             ("hue wheel", wheel, None)]
    batch = np.stack([planar(images[i % len(images)]) for i in range(8)])
    bboxes = np.stack([boxes[0]] * 8)
    bvalid = np.stack([boxes[1]] * 8)
    tables_gpu = pt.ReportTables.build(H, W, cfg, DEVICE)
    tables_cpu = pt.ReportTables.build(H, W, cfg, "cpu")
    batch_gpu = torch.as_tensor(batch, device=DEVICE)

    _cuda.reset_launch_counts()
    gpu_reports = [pt.get_report(img, bx, device=DEVICE)
                   for _, img, bx in calls]
    gpu_batch = pt.full_report_batched(batch_gpu, bboxes, bvalid, tables_gpu,
                                       cfg)
    sync()
    launches = dict(_cuda.LAUNCHES)
    log(f"  launch counts in the main-path run: {launches}")

    for (label, img, bx), rep in zip(calls, gpu_reports):
        ref = pt.get_report(img, bx, device="cpu")
        if rep is None or ref is None:
            raise AssertionError(f"{label}: get_report returned None")
        if len(json.loads(rep.to_json())) != 439:
            raise AssertionError(f"{label}: to_json does not have 439 keys")
        if rep.to_dict().keys() != ref.to_dict().keys():
            raise AssertionError(f"{label}: to_json keys differ")
        compare_reports(report_fields(rep), report_fields(ref), label)
    cpu_batch = pt.full_report_batched(torch.as_tensor(batch), bboxes, bvalid,
                                       tables_cpu, cfg)
    for i in range(len(batch)):
        compare_reports(data_fields(gpu_batch, i), data_fields(cpu_batch, i),
                        f"full_report_batched B=8 3 boxes, image {i}")
    check_launches(launches, MAIN_COUNTERS, "main path")
    return launches, tables_gpu, batch_gpu, bboxes, bvalid


def spatial_frames():
    """The spatial path's 4320x7680 uint8 frames, planar (3, H, W): noise
    (the palette's q=8 tier) and the hue wheel (q_full)."""
    rng = np.random.default_rng(SEED + 3)
    return {"noise": planar(noise_image(rng, SH, SW)),
            "hue wheel": planar(hue_wheel_image(rng, SH, SW))}


def spatial_kernels(group, frames, box_sets, cfg) -> dict:
    """The spatial path's kernels against their plain versions on the
    inputs its one rank hands them, built by parallel/spatial's own steps
    at 4320x7680: K9 and K10 (q=8 and q_full) on the frame's flat HSV
    (33 MP, accumulators bit-equal), K5 on its luma with the zero halo and
    each box set (within SHARP_RTOL), K7+K8 on the rank's |X|^2 and bin ids
    (within POLAR_RTOL).  Returns max abs errors."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import polar_kernels as pol
    from photohive_dsp_tpu_torch.ops import quantize as qz
    from photohive_dsp_tpu_torch.ops import sharpness_kernels as sk
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_pgm
    from photohive_dsp_tpu_torch.ops.fixed_point import from_fixed
    from photohive_dsp_tpu_torch.ops.margin_sort import margin_sort
    from photohive_dsp_tpu_torch.parallel import spatial

    dev = torch.device(DEVICE, torch.cuda.current_device()) \
        if DEVICE == "cuda" else torch.device(DEVICE)
    nb = cfg.angle_partitions * cfg.radius_partitions
    octree = qz.OctreeTables.for_config(cfg, dev)
    tabs = spatial.sharded_polar_tables(SH, SW, cfg.angle_partitions,
                                        cfg.radius_partitions, 1)
    ids = torch.as_tensor(tabs.flat_ids[0], device=dev)
    err = {"K5": 0.0, "K7+K8": 0.0}
    for name, frame in frames.items():
        rgb = spatial.own_rows(torch.as_tensor(frame), 0, SH, dev)
        hsv = spatial.masked_hsv(rgb, 0, SH)
        counts, _ = pk.counts_s_from_fixed(pk.cell_counts_from_hsv(*hsv, cfg))
        order = margin_sort(qz.saliency_f32(counts, octree.s_v_f32, cfg))
        assign = qz.parent_assignment_from_order(counts, order, SH * SW, cfg,
                                                 octree)
        check_flat_kernels(hsv, assign, octree, cfg, f"spatial {name}")

        pgm = rgb_to_pgm(rgb[0], rgb[1], rgb[2])
        halo = spatial.halo_rows(pgm, group)[None].contiguous()
        rel5 = 0.0
        for label, (bx, vd) in box_sets.items():
            bt = sk.box_tensor(bx[None], vd[None], dev)
            got = sk.sharpness_sums(pgm[None].contiguous(), bt, halo, 0)
            want = sk.sharpness_sums_plain(pgm[None], bt, halo, 0)
            sync()
            on = torch.as_tensor(vd[None], device=dev)
            for g, w in zip(got, want):
                rel = rel_err(g[on], w[on])
                if not rel <= SHARP_RTOL or bool(g[~on].any()):
                    raise AssertionError(f"K5 spatial {name} {label}: rel "
                                         f"err {rel}, or an empty slot not 0")
                rel5 = max(rel5, rel)
                err["K5"] = max(err["K5"], float((g - w).abs().max()))

        stats = spatial.rgb_stats(rgb, 0, SH, SW, group)
        dc = (stats[0] + stats[1] + stats[2]) / 3.0
        mag2 = spatial.power_spectrum(pgm, dc, tabs.wc, SH, SW, group)
        got = from_fixed(pol.polar_bin_sums_lognorm(mag2, ids, nb,
                                                    fixed=True))
        want = from_fixed(pol.polar_bin_sums_lognorm_plain(mag2, ids, nb,
                                                           fixed=True))
        sync()
        if bool(((got - want).abs() > POLAR_RTOL * want.abs()).any()):
            raise AssertionError(f"K7+K8 spatial {name}: rel err "
                                 f"{rel_err(got, want)}")
        err["K7+K8"] = max(err["K7+K8"], float((got - want).abs().max()))
        log(f"  spatial {name} {SH}x{SW}, the rank's inputs: K9, K10 (q=8, "
            f"q_full) accumulators equal plain; K5 ({', '.join(box_sets)}) "
            f"rel err {rel5:.2e}; K7+K8 on {tuple(mag2.shape)} |X|^2 rel err "
            f"{rel_err(got, want):.2e}")
    return err


def phase_spatial(cfg):
    """build_spatial_report on one NCCL rank against the single-device
    full_report_batched on the card, at 4320x7680: the noise frame with
    main_boxes, then with a thin box, the hue-wheel frame with main_boxes;
    then the path's kernels against their plain versions on the rank's own
    inputs (spatial_kernels).  Returns the launch counts of the report
    calls, the spatial call's warm wall time and the kernels' max abs
    errors."""
    import tempfile

    import torch.distributed as dist

    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import _cuda
    from photohive_dsp_tpu_torch.parallel import mesh, spatial

    t0 = time.perf_counter()
    frames = spatial_frames()
    boxes = pt.set_bounding_boxes(main_boxes(SH, SW))
    thin = pt.set_bounding_boxes(main_boxes(SH, SW) + [thin_box(SH, SW)])
    calls = [("noise+3 boxes", "noise", boxes),
             ("noise+thin box", "noise", thin),
             ("hue wheel+3 boxes", "hue wheel", boxes)]
    tables = pt.ReportTables.build(SH, SW, cfg, DEVICE)
    rendezvous = f"file://{tempfile.mkdtemp()}/rendezvous"
    group = mesh.init_spatial_group(0, 1, rendezvous, device=DEVICE)
    try:
        fn = spatial.build_spatial_report(group, SH, SW, cfg, DEVICE)
        log(f"  frames and tables {SH}x{SW}: "
            f"{time.perf_counter() - t0:.1f} s")
        _cuda.reset_launch_counts()
        out = [fn(frames[f], *bx) for _, f, bx in calls]
        sync()
        launches = dict(_cuda.LAUNCHES)
        log(f"  launch counts in the spatial-path run: {launches}")
        wall = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(frames["noise"], *boxes)
            sync()
            wall.append(time.perf_counter() - t0)
        err = spatial_kernels(group, frames, {"3 boxes": boxes,
                                              "thin box": thin}, cfg)
    finally:
        dist.destroy_process_group()
    for (label, f, (bx, vd)), got in zip(calls, out):
        x = torch.as_tensor(frames[f][None], device=DEVICE)
        ref = pt.full_report_batched(x, bx[None], vd[None], tables, cfg)
        one = {k: v[None] for k, v in got._asdict().items()}
        compare_reports(data_fields(pt.ReportData(**one), 0),
                        data_fields(ref, 0), f"spatial {SH}x{SW} {label}",
                        "the single-device path")
    check_launches(launches, SPATIAL_COUNTERS, "spatial path")
    wall_ms = 1e3 * float(np.median(wall))
    log(f"  build_spatial_report {SH}x{SW} u8, 1 rank, 3 boxes, warm: "
        f"median {wall_ms:.1f} ms (min {1e3 * min(wall):.1f}, n=3)")
    return launches, wall_ms, err


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the bytes over the HBM rate and the float32 operations over
    the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def margin_sort_compares(sal: torch.Tensor) -> int:
    """The float32 margin comparisons the insertion sort makes on these
    saliencies (K2's work, which depends on the data)."""
    n = 0
    for row in sal.cpu().numpy():
        done = [row[0]]
        for si in row[1:]:
            j = len(done) - 1
            while j >= 0 and np.float32(done[j] - si) <= -1:
                j -= 1
                n += 1
            n += int(j >= 0)
            done.insert(j + 1, si)
    return n


def stage_times(images, cfg, tables):
    """The blur stage at B=1 and B=8 on the noise frame: the torch route
    (rfft2 + normalisation, then the gather) against the kernels (K6a+K6b,
    then max + K7+K8 + gain), in turns torch, kernels, kernels, torch."""
    from photohive_dsp_tpu_torch.ops.blur import blur_profile_bins, \
        lognorm_bin_means
    from photohive_dsp_tpu_torch.ops.fft import magnitude_fft_normalized
    from photohive_dsp_tpu_torch.ops.fft_kernels import magnitude2
    from photohive_dsp_tpu_torch.ops.fft_plan import FftPlan

    a, r = cfg.angle_partitions, cfg.radius_partitions
    plan = FftPlan.for_shape(H, W, DEVICE)
    for b in (1, 8):
        x = luma_dc([images[0]] * b)
        mag = magnitude_fft_normalized(x)
        mag2 = magnitude2(x, plan).reshape(b, -1)
        torch_route = [
            lambda: magnitude_fft_normalized(x),
            lambda: blur_profile_bins(mag, tables.polar, a, r)]
        kernel_route = [
            lambda: magnitude2(x, plan),
            lambda: lognorm_bin_means(mag2, tables.polar, a, r)]
        t1 = [cuda_ms(f, 20) for f in torch_route]
        k1 = [cuda_ms(f, 20) for f in kernel_route]
        k2 = [cuda_ms(f, 20) for f in kernel_route]
        t2 = [cuda_ms(f, 20) for f in torch_route]
        t = [(u + v) / 2 for u, v in zip(t1, t2)]
        k = [(u + v) / 2 for u, v in zip(k1, k2)]
        log(f"  blur stage B={b} 1080x1920: torch route fft+norm {t[0]:.4f} "
            f"ms + polar bins {t[1]:.4f} ms = {sum(t):.4f} ms; kernels "
            f"K6a+K6b {k[0]:.4f} ms + max/K7+K8/gain {k[1]:.4f} ms = "
            f"{sum(k):.4f} ms")


def sharpness_stage_times(images):
    """The sharpness stage at B=1 and B=8 on the noise frame with
    main_boxes: the plain route (K5's plain version, then the finish)
    against the kernel route (K5, then the finish; what
    variance_sharpness_batched runs), in turns plain, kernel, kernel,
    plain; and, once, the masked route that a batch with a thin box takes
    (plain PyTorch)."""
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import sharpness as sh
    from photohive_dsp_tpu_torch.ops import sharpness_kernels as sk

    boxes, valid = pt.set_bounding_boxes(main_boxes(H, W))
    for b in (1, 8):
        pgm = luma([images[0]] * b)
        bx, vd = np.stack([boxes] * b), np.stack([valid] * b)
        bt = sk.box_tensor(bx, vd, DEVICE)
        bx_d, vd_d = torch.as_tensor(bx, device=DEVICE), \
            torch.as_tensor(vd, device=DEVICE)

        def plain():
            return sh.finish_sharpness(*sk.sharpness_sums_plain(pgm, bt), bx,
                                       vd)

        def kernel():
            return sh.variance_sharpness_batched(pgm, bx, vd)

        p1, k1, k2, p2 = (cuda_ms(plain, 5), cuda_ms(kernel, 20),
                          cuda_ms(kernel, 20), cuda_ms(plain, 5))
        masked = cuda_ms(lambda: sh._masked_sharpness(pgm, bx_d, vd_d), 3)
        log(f"  sharpness stage B={b} 1080x1920 3 boxes: plain route "
            f"{(p1 + p2) / 2:.4f} ms, K5 route {(k1 + k2) / 2:.4f} ms "
            f"({p1:.4f}/{k1:.4f}/{k2:.4f}/{p2:.4f}); masked route "
            f"{masked:.4f} ms")


def dilated_area(boxes, valid, h: int, w: int) -> int:
    """Pixels of one image inside the boxes or their 1-px rings: what K5
    has to read."""
    mask = np.zeros((h, w), bool)
    for (t, b, l, r), ok in zip(boxes, valid):
        if ok:
            mask[max(t - 1, 0):min(b + 1, h), max(l - 1, 0):min(r + 1, w)] = 1
    return int(mask.sum())


def phase_timing(images, cfg, kin, bkin, skin, fkin, main):
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import fft_kernels as fk
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import polar_kernels as pol
    from photohive_dsp_tpu_torch.ops import quantize as qz
    from photohive_dsp_tpu_torch.ops import sharpness_kernels as sk
    from photohive_dsp_tpu_torch.ops.margin_sort import (
        margin_insertion_argsort, margin_sort)

    _, tables, batch_gpu, bboxes, bvalid = main
    img = images[0]
    for _ in range(3):
        pt.get_report(img, device=DEVICE)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        pt.get_report(img, device=DEVICE)
        lat.append(time.perf_counter() - t0)
    lat_ms = 1e3 * float(np.median(lat))
    log(f"  get_report 1080x1920 u8 noise, warm: median {lat_ms:.3f} ms "
        f"(min {1e3 * min(lat):.3f}, max {1e3 * max(lat):.3f}, n=20)")

    pt.full_report_batched(batch_gpu, bboxes, bvalid, tables, cfg)
    sync()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        pt.full_report_batched(batch_gpu, bboxes, bvalid, tables, cfg)
    sync()
    dt = (time.perf_counter() - t0) / reps
    mps = 8 * H * W / dt / 1e6
    log(f"  full_report_batched B=8 1080x1920 u8 (device-resident, 3 boxes,"
        f" none thin): {1e3 * dt:.3f} ms per batch, {mps:.1f} MP/s")
    stage_times(images, cfg, tables)
    sharpness_stage_times(images)

    c = cfg.num_cells
    _, q_full = qz.palette_widths(cfg)
    x = kin["u8"]
    assign = kin["assign"]
    cand = {"K4q8": pk.palette_candidate_table(assign, tables.octree, c, 8),
            "K4qfull": pk.palette_candidate_table(assign, tables.octree, c,
                                                  q_full)}
    c8, cf = cand["K4q8"], cand["K4qfull"]
    hsv = fkin["hsv"]
    fx, plan, spec, flat = bkin["x"], bkin["plan"], bkin["spec"], bkin["flat"]
    ids = bkin["polar"].bin_ids
    nb = cfg.angle_partitions * cfg.radius_partitions
    zc = torch.view_as_complex(spec)
    gated = pol.log_gate(flat)
    ids_l = ids.long()
    acc = torch.zeros((flat.shape[0], nb), device=DEVICE)
    pairs = {
        "K1": (lambda: pk.cell_counts_s_from_rgb(x, cfg),
               lambda: pk.cell_counts_s_from_rgb_plain(x, cfg)),
        "K2": (lambda: margin_sort(kin["sal"]),
               lambda: margin_insertion_argsort(kin["sal"])),
        "K3": (lambda: pk.palette_sums_by_k_rgb_q1(x, kin["slot"], kin["off"],
                                                   cfg),
               lambda: pk.palette_sums_by_k_rgb_q1_plain(
                   x, kin["slot"], kin["off"], cfg)),
        "K4q8": (lambda: pk.palette_sums_by_k_rgb(x, *c8, cfg),
                 lambda: pk.palette_sums_by_k_rgb_plain(x, *c8, cfg)),
        "K4qfull": (lambda: pk.palette_sums_by_k_rgb(x, *cf, cfg),
                    lambda: pk.palette_sums_by_k_rgb_plain(x, *cf, cfg)),
        "K6a": (lambda: fk.fft_rows(fx, plan),
                lambda: fk.fft_rows_plain(fx, plan)),
        "K6b": (lambda: fk.fft_cols(spec, plan),
                lambda: fk.fft_cols_plain(spec, plan)),
        "K7+K8": (lambda: pol.polar_bin_sums_lognorm(flat, ids, nb),
                  lambda: pol.polar_bin_sums_lognorm_plain(flat, ids, nb)),
        "K5": (lambda: sk.sharpness_sums(skin["pgm"], skin["bt"]),
               lambda: sk.sharpness_sums_plain(skin["pgm"], skin["bt"])),
        "K9": (lambda: pk.cell_counts_from_hsv(*hsv, cfg),
               lambda: pk.cell_counts_from_hsv_plain(*hsv, cfg)),
        "K10q8": (lambda: pk.palette_sums_by_k(*hsv, *c8, cfg),
                  lambda: pk.palette_sums_by_k_plain(*hsv, *c8, cfg)),
        "K10qfull": (lambda: pk.palette_sums_by_k(*hsv, *cf, cfg),
                     lambda: pk.palette_sums_by_k_plain(*hsv, *cf, cfg)),
    }
    # One PyTorch call computing the same function, where there is one.
    library = {
        "K6a": lambda: torch.fft.rfft(fx, dim=-1),
        "K6b": lambda: torch.fft.fft(zc, dim=1).abs().square(),
        "K7+K8": lambda: acc.index_add_(1, ids_l, gated),
    }
    times = {}
    for key, (kern, plain) in pairs.items():
        # plain, library, kernel, kernel, library, plain; the mean of each
        lib = library.get(key)
        p1 = cuda_ms(plain, 3)
        l1 = cuda_ms(lib, 20) if lib else None
        k1 = cuda_ms(kern, 20)
        k2 = cuda_ms(kern, 20)
        l2 = cuda_ms(lib, 20) if lib else None
        p2 = cuda_ms(plain, 3)
        times[key] = ((k1 + k2) / 2, (p1 + p2) / 2,
                      (l1 + l2) / 2 if lib else None)
        log(f"  {key}: kernel {times[key][0]:.4f} ms, plain "
            f"{times[key][1]:.4f} ms, library "
            f"{'%.4f ms' % times[key][2] if lib else 'none'}")
    k6 = times["K6a"][0] + times["K6b"][0]
    rfft2 = cuda_ms(lambda: torch.fft.rfft2(fx).abs().square(), 20)
    times["K6"] = (k6, None, rfft2)
    log(f"  K6a+K6b {k6:.4f} ms vs torch.fft.rfft2 + |.|^2 {rfft2:.4f} ms "
        f"(B={fx.shape[0]} f32 {H}x{W})")

    # Work of each timed call, from these inputs.
    b, _, hh, ww = x.shape
    px = b * hh * ww
    x_bytes = x.numel() * x.element_size()
    counts = kin["counts"].long()
    work = {
        "K1": (x_bytes + b * c * 4 + b * 4, px * (OPS_CELL_PX + 1)),
        "K2": (2 * b * c * 4, 2 * margin_sort_compares(kin["sal"])),
        "K3": (x_bytes + b * c * 8 + b * c * 16,
               px * (OPS_CELL_PX + OPS_SLOT_PX)),
    }
    for key, (cand_t, centres) in cand.items():
        per_cell = (cand_t < c).sum(dim=-1).long()
        n_cand = int((counts * per_cell).sum())
        work[key] = (x_bytes + cand_t.numel() * 4 + centres.numel() * 4
                     + b * c * 16,
                     px * (OPS_CELL_PX + OPS_SLOT_PX)
                     + n_cand * OPS_CANDIDATE)
    fb, fh, fw = fx.shape
    half = fw // 2 + 1
    spec_bytes = fb * fh * half * 8
    work["K6a"] = (fx.numel() * 4 + spec_bytes + fw * 8,
                   (fb * fh + 1) // 2 * 5 * fw * np.log2(fw)
                   + fb * fh * half * 6)
    work["K6b"] = (spec_bytes + fb * fh * half * 4 + fh * 8,
                   fb * half * 5 * fh * np.log2(fh) + fb * fh * half * 3)
    # K6 as one function, |rfft2|^2: the luma read once and the half
    # spectrum written once; the intermediate K6a writes and K6b reads
    # back is the two-pass design's cost, not the function's.
    work["K6"] = (fx.numel() * 4 + fb * fh * half * 4,
                  work["K6a"][1] + work["K6b"][1])
    n_gated = int((flat >= 1.0).sum())
    work["K7+K8"] = (flat.numel() * 4 + ids.numel() * 4 + fb * nb * 4,
                     flat.numel() + 3 * n_gated)
    # K5: the luma in and around the boxes, the boxes, the (B, 10, 2)
    # float64 sums; OPS_SHARP_PX per pixel of box area.
    sb = skin["pgm"].shape[0]
    areas = [max(0, min(bb, H) - max(t, 0)) * max(0, min(r, W) - max(lf, 0))
             for (t, bb, lf, r), ok in zip(skin["boxes"], skin["valid"]) if ok]
    work["K5"] = (sb * dilated_area(skin["boxes"], skin["valid"], H, W) * 4
                  + skin["bt"].numel() * 4 + sb * 10 * 2 * 8,
                  sb * sum(areas) * OPS_SHARP_PX)
    # K9/K10: h of every pixel, s and v of the real ones; out, the int64
    # accumulators.
    real_px = b * fkin["p"]
    hsv_bytes = real_px * 12 + b * SENTINEL_TAIL * 4
    work["K9"] = (hsv_bytes + b * (c + 1) * 8, real_px * OPS_CELL_ID)
    for key, (cand_t, centres) in (("K10q8", c8), ("K10qfull", cf)):
        per_cell = (cand_t < c).sum(dim=-1).long()
        n_cand = int((counts * per_cell).sum())
        work[key] = (hsv_bytes + cand_t.numel() * 4 + centres.numel() * 4
                     + b * c * 32,
                     real_px * (OPS_CELL_ID + OPS_SLOT_PX)
                     + n_cand * OPS_CANDIDATE)
    bounds = {k: bound(*v) for k, v in work.items()}
    for k, (ms, by) in bounds.items():
        log(f"  {k}: bound {ms:.5f} ms ({by}; {work[k][0] / 1e6:.2f} MB, "
            f"{work[k][1] / 1e9:.4f} G float32 ops)")
    return times, bounds, lat_ms, mps


KERNELS = [
    ("K1", "cell_counts_s", "cell_counts_s",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels_bf16.py:209"),
    ("K2", "margin_sort", "margin_sort",
     "photohive_dsp_tpu_torch/csrc/margin_sort.cu",
     "photohive_dsp_tpu/ops/pallas_kernels.py:1033"),
    ("K3", "palette_sums_q1", "palette_sums_q1",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels_bf16.py:480"),
    ("K4q8", "palette_sums (q=8)", "palette_sums_q8",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels_bf16.py:402"),
    ("K4qfull", "palette_sums (q=q_full)", "palette_sums_qfull",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels_bf16.py:402"),
    ("K6a", "fft_rows", "fft_rows",
     "photohive_dsp_tpu_torch/csrc/fft.cu",
     "photohive_dsp_tpu/ops/pallas_fft.py:541"),
    ("K6b", "fft_cols", "fft_cols",
     "photohive_dsp_tpu_torch/csrc/fft.cu",
     "photohive_dsp_tpu/ops/pallas_fft.py:586"),
    ("K5", "sharpness_sums", "sharpness_sums",
     "photohive_dsp_tpu_torch/csrc/sharpness.cu",
     "photohive_dsp_tpu/ops/pallas_sharpness.py:123"),
    ("K7+K8", "polar_bin_sums_lognorm", "polar_bins",
     "photohive_dsp_tpu_torch/csrc/polar.cu",
     "photohive_dsp_tpu/ops/pallas_kernels.py:222"),
    ("K9", "cell_counts_from_hsv", "cell_counts_hsv",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels.py:378"),
    ("K10q8", "palette_sums_by_k (q=8)", "palette_sums_flat_q8",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels.py:627"),
    ("K10qfull", "palette_sums_by_k (q=q_full)", "palette_sums_flat_qfull",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels.py:627"),
]

# The library call timed beside each kernel, or why there is none.
LIBRARY = {
    "K1": "none: no PyTorch call computes the HSV cell histogram",
    "K2": "none: the margin comparator is not a sort key torch.argsort takes",
    "K3": "none: no PyTorch call computes the tie-broken palette sums",
    "K4q8": "none: no PyTorch call computes the tie-broken palette sums",
    "K4qfull": "none: no PyTorch call computes the tie-broken palette sums",
    "K6a": "torch.fft.rfft(dim=-1)",
    "K6b": "torch.fft.fft(dim=1) then abs().square()",
    "K7+K8": "Tensor.index_add_ of the gated values into (B, A*R)",
    "K5": "none: no PyTorch call computes masked-crop Laplacian sums",
    "K9": "none: no PyTorch call computes the sentinel HSV cell histogram",
    "K10q8": "none: no PyTorch call computes the tie-broken palette sums",
    "K10qfull": "none: no PyTorch call computes the tie-broken palette sums",
}


def main() -> int:
    smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from photohive_dsp_tpu_torch.config import ReportConfig
    from photohive_dsp_tpu_torch.models.pipeline import ReportTables

    phase_build()
    cfg = ReportConfig()
    rng = np.random.default_rng(SEED)
    images = [noise_image(rng), structured_image(rng), hue_wheel_image(rng),
              noise_image(rng)]
    tables = ReportTables.build(H, W, cfg, DEVICE)
    log("phase 3: kernels vs plain versions")
    err, kin = phase_kernels(images, cfg, tables)
    sharp_err, skin = phase_sharpness_kernel(images)
    err["K5"] = sharp_err
    flat_err, fkin = phase_flat_kernels(kin, cfg, tables)
    err.update(flat_err)
    blur_err, bkin = phase_blur_kernels(images, cfg)
    err.update(blur_err)
    log("phase 4: main path")
    main_out = phase_main_path(images, cfg)
    launches = main_out[0]
    log("phase 5: spatial path")
    spatial_launches, spatial_ms, spatial_err = phase_spatial(cfg)
    for key, e in spatial_err.items():
        err[key] = max(err[key], e)
    # K9 and K10 run on the spatial path only.
    for counter in ("cell_counts_hsv", "palette_sums_flat_q8",
                    "palette_sums_flat_qfull"):
        launches[counter] = spatial_launches[counter]
    log("phase 6: timing (B=4 1080x1920: u8 for K1-K4, f32 luma for K5-K8, "
        "flat HSV for K9-K10)")
    times, bounds, lat_ms, mps = phase_timing(images, cfg, kin, bkin, skin,
                                              fkin, main_out)

    kernels = [dict(id=key, name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[counter], max_abs_err=err[key],
                    ms=times[key][0], plain_ms=times[key][1],
                    bound_ms=bounds[key][0], bound_by=bounds[key][1],
                    library_ms=times[key][2], library=LIBRARY[key])
               for key, name, counter, src, rep in KERNELS]
    for entry in kernels:
        if entry["id"] in ("K6a", "K6b"):
            entry.update(k6_ms=times["K6"][0], k6_bound_ms=bounds["K6"][0],
                         k6_bound_by=bounds["K6"][1])
    log(f"  K6 (K6a+K6b) {times['K6'][0]:.4f} ms against the bound of "
        f"|rfft2|^2 itself, {bounds['K6'][0]:.5f} ms "
        f"({times['K6'][0] / bounds['K6'][0]:.1f}x)")
    log(f"get_report warm median {lat_ms:.3f} ms; full_report_batched B=8 "
        f"{mps:.1f} MP/s; build_spatial_report {SH}x{SW} {spatial_ms:.1f} ms")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
