"""Smoke test of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Drives photohive_dsp_tpu_torch's paths through their CUDA kernels — the
main path (get_report on 1080x1920 frames and full_report_batched on a
batch of 8, with and without crop boxes), the single-image API
(full_report on float32 frames), the corpus path (run_corpus over
config #3's 256 frames under each PHOTOHIVE_PALETTE_KERNEL variant, the
streaming runner, process_corpus with a crash and a resume) and the
row-sharded report (parallel/spatial.build_spatial_report, one NCCL rank, a
4320x7680 frame), the serving path (serving.export_report, the artifact
loaded in a fresh process) and the data-parallel and dp x spatial layer
(parallel/sharding, build_dp_spatial_report and the mesh parameters of the
batch layer and serving, one NCCL rank) — and checks every result against
a reference.
Phases, each of which raises on failure:

  1. device: a CUDA device must be present; prints its name and power limit;
  2. build: compiles the kernels from photohive_dsp_tpu_torch/csrc;
  3. kernels against their plain versions on the card: the palette kernels
     at 1080x1920, B=4, uint8 input (K1-K4) and float32 input (K11-K13);
     the margin sort (K2) on both sides of each of its buckets' edges at
     B=1, 4 and 16 on seven kinds of data (check_margin_sort);
     the crop-box sharpness kernel (K5) at 1080x1920 B=4 with three boxes,
     one on the image's edge, and on its edge cases (sharpness_edge_cases:
     the whole frame, boxes across its item seams and over the halo row,
     row offsets, width 1001, B=16), each twice (bit-identical), within
     SHARP_RTOL of plain and zero where plain is; the flat-HSV palette
     kernels (K9, K10, K14) at 1080x1920 B=4 with a sentinel tail (which
     must change nothing), K14 also against K10 on a noise batch (q=8) and
     a hue-wheel batch (q_full), and the cell-id histogram (K15) against
     K9's counts; the FFT kernels (K6a, K6b) and the polar kernel (K7+K8) at
     1080x1920 B=4, 2160x3840 B=1 and 1092x1001 B=2, the FFT also against
     float64 rfft2 (>= 90 dB), the polar sums, maxima and bin means twice
     (bit-identical), a zero frame, and a 360x100-bin table (the polar
     kernel's global-atomics branch);
  4. main path against the CPU path (seven get_report calls, the last on
     the near-tie frame, and a B=8 batch), with the kernel launch counts of
     that run (each of its kernels at least once, K5 included), with
     --parent against the parent checkout's main path on the card, every
     report field bit for bit but, against a parent that rounds the
     palette's distance and saliency weight unfused, the predicted
     UNFUSED_MOVES, which must move, and K5 against its plain version on
     the path's B=8 batch;
  5. corpus path: run_corpus over 256 uint8 frames of 720x1280, 1080x1920
     and 480x640 (bench.py's config #3), batch 16 with padded tails, under
     bf16, candidate and cwide: every report equal across the variants,
     each bucket's first batch and tail equal to get_report of the image,
     and each variant's kernels launched (K1/K3/K4; K11-K13; K9 and K14);
     run_stream_u8 with and without prefetch (equal results); then
     process_corpus on 8 .txt frames with a crash after the first flush
     and a resume: every key once, the reports run_corpus's;
  6. spatial path: build_spatial_report at world size 1 on 4320x7680 frames
     (boxes, a thin box, a full-width tie tier) against the single-device
     full_report_batched on the card, with the launch counts of that run
     (K9 and K10 at both widths at least once), and one call under cwide
     (K14) against the bf16 one; then K5, K7+K8, K9 and K10 against their
     plain versions on the inputs the rank hands them there (33 MP of flat
     HSV, the luma with its halo, the rank's |X|^2);
  7. timing: warm get_report latency; warm full_report on a float32
     frame on the card against full_report_batched at B=1 on it and
     get_report on it as uint8 (20 calls each between CUDA events, in
     turns); batch-8 throughput, the corpus
     path's MP/s, the spatial call's wall time, the blur and sharpness
     stages by their plain routes and by the kernels at B=1 and B=8, K6a
     against torch.fft.rfft at ROW_FFT_WIDTHS, K6b against torch.fft.fft
     of the columns at COL_FFT_HEIGHTS, and each kernel's device
     time (graph_ms) beside its plain version's, its bound and a library
     call's;
  8. serving path: export_report at 1080x1920 with B=8 pinned and with a
     dynamic batch (their seconds); the pinned artifact saved, loaded in a
     fresh process that imports the port alone and run on each frame kind
     (structured: q=1, noise: q=8, hue wheel: q_full) under each box set
     (none, main_boxes, main_boxes with thin_box) and one mixed batch,
     with the launch counts of that run (K1-K8 each at least once); each
     report bit-equal to the live full_report_batched and through
     utils.debug.verify_report; the dynamic artifact at B=1, 3 and 8, the
     same; the artifact call against the live call in turns (CUDA events,
     median of 20); the host time of an operator call (dispatch_times);
     utils.profiling.stage_timings at B=8;
  9. dp and dp x spatial on one NCCL rank (parallel.mesh's
     initialize_distributed with one process, make_mesh(1, 1)): the
     data-parallel report (parallel/sharding) on phase 4's 8 frames, bit
     for bit against full_report_batched; build_dp_spatial_report at B=2
     on phase 6's frames, each image bit-equal to build_spatial_report of
     it (3 boxes; a thin box in image 0 alone: image 1 on the masked route
     within 1e-4; under cwide: K14, no K10); run_corpus(mesh=...) on two
     2160x3840 frames and 16 of config #3's, equal to the mesh-less run;
     phase 8's artifact through load_report(mesh=...), bit for bit; the
     launch counts of that run; K9, K10 and K14 on the deferred palette
     pass's batched (2, P) flat HSV against their plain versions; the warm
     dp x spatial call and the dp call in turns with full_report_batched;
 10. the single-image API: full_report through jitted_full_report (its
     default device, its cache) on phase 4's three frame kinds decoded
     to float32 (q=8, q=1, q_full) under no boxes, main_boxes and
     main_boxes with thin_box, with the launch counts of that run (K11,
     K2, K12, K13, K5, K6a, K6b, K7+K8 each at least once, no uint8
     kernel); each report bit-equal to full_report_batched at B=1, through
     utils.debug.verify_report and against full_report on the CPU; the
     dev utilities (hsv_to_rgb on all 2^24 triples' HSV and a hue grid,
     fft_shift, filter_image, create_filtered_rgb, sharpness_avg,
     average_sharpness, the crops) on the card against the CPU; and
     utils.viz on a card report (the PIL and matplotlib images only where
     those import, as a line says).

Phase 3 also holds K6a to its plain version on its edge cases (odd row
counts, widths 1001, 3840 and 14520, and short widths that reach each of
its fused passes: ROW_FFT_EDGES), K6b on heights that reach each of
its passes and tile layouts (COL_FFT_EDGES), the palette-sums kernel (K3, K4,
K10, K12-K14) on a one-colour batch, two-colour stripes, a pixel count
that is no multiple of 4, and C=2164; the cell histogram (K1, K9, K11,
K15) on a one-colour batch and, with the palette-sums kernel, on a frame
of all 2^24 RGB triples at four grids (18x2x3, 12x3x2, 24x5x5, 8x4x6),
and get_report against the CPU path on frames of the triples whose cell
IEEE division would move (12x3x2, 24x5x5); every route of the
palette-sums kernel (K4 on uint8, K13 on float32, K10 and K14 on flat HSV,
K3, K12) on a 1080x1920 noise frame (seed 5) where the fused tie-break
distance moves two pixels against the unfused one, the plain versions
carrying the fused counts; and K7+K8 on one-bin, below-gate,
out-of-range-id and odd-length spectra.  Phase 7 also times the
one-colour batch.

Prints the kernels' JSON line, the card's name and power limit, and, last,
{"ok": true, "device": {...}}.  Exits nonzero without that line when a
phase fails or no CUDA device is present.  Imports no JAX.

    python3 chip_smoke.py                     # what the checks need
    python3 chip_smoke.py --parent DIR        # also hold the main path's
        # reports bit-equal to the checkout at DIR's (but UNFUSED_MOVES
        # against a checkout without the FMAs), and time the palette
        # kernels, K2 (C=112 and 2164), K5 (and its time in each CUDA
        # kernel it launches, by torch.profiler), K6a, K6b, K7+K8, the blur
        # tail, a B=8 report and warm get_report of the
        # checkout at DIR against this one's, on the same inputs, in turns
        # parent, this, this, parent
    python3 chip_smoke.py --kernel-times DIR [KEY ...]  # those times
        # alone, for the checkout at DIR (one JSON line); with keys of
        # kernel_calls (e.g. K5), those kernels alone
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
# The FFT kernels equal their plain versions bit for bit (the same float32
# operations in the same order); both meet the JAX package's bar against
# float64 rfft2 (tests/test_pallas_fft.py).
FFT_SNR_DB = 90.0
# K5's s1, s2 vs plain: float32 per-thread sums there, float64 here.
SHARP_RTOL = 1e-5
SENTINEL_TAIL = 4096      # hue-sentinel pixels after K9/K10's real ones
BLUR_SHAPES = [(1080, 1920, 4), (2160, 3840, 1), (1092, 1001, 2)]
# bench.py's config #3 (bench.py:438-452): 256 frames, image i of shape
# i % 3, batch 16.
CORPUS_SHAPES = [(720, 1280), (1080, 1920), (480, 640)]
CORPUS_IMAGES = 256
CORPUS_BATCH = 16
CORPUS_KINDS = ("noise", "structured", "hue wheel")   # q=8, q=1, q_full
TXT_FRAMES = 8            # process_corpus's .txt frames, 720x1280
VARIANTS = ("bf16", "candidate", "cwide")
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


def structured_image(rng, h=H, w=W) -> np.ndarray:
    """Gradient + four flat colour blobs + mild noise: few populated cells,
    none of them tied, so the palette takes the q=1 tier."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    r = 0.25 + 0.5 * (x / w)
    g = 0.25 + 0.5 * (y / h)
    b = 0.35 + 0.25 * np.sin(2 * np.pi * x / 97) * np.cos(2 * np.pi * y / 61)
    for cy, cx, rad, col in [(0.3, 0.3, 0.11, (0.9, 0.1, 0.1)),
                             (0.7, 0.6, 0.15, (0.1, 0.8, 0.2)),
                             (0.4, 0.8, 0.09, (0.15, 0.2, 0.9)),
                             (0.8, 0.2, 0.07, (0.95, 0.85, 0.1))]:
        m = (y - cy * h) ** 2 + (x - cx * w) ** 2 < (rad * h) ** 2
        r[m], g[m], b[m] = col
    rgb = np.stack([r, g, b], axis=-1) + rng.normal(0, 0.01, (h, w, 3))
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


def smoke_images() -> list:
    """The four frames the main path and the timings run on, from SEED."""
    rng = np.random.default_rng(SEED)
    return [noise_image(rng), structured_image(rng), hue_wheel_image(rng),
            noise_image(rng)]


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


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms of one call of fn: ``iters`` calls captured in one CUDA
    graph, timed by events around its replay, so the host's launch
    overhead (a wrapper's checks, allocations and ctypes call, tens of
    microseconds) is not counted.  The wrappers launch on the current
    stream and never synchronise, so they capture as they are."""
    fn()
    sync()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


# The float32 instantiations of K1, K3 and K4 stand for the TPU's float32
# candidate kernels K11, K12 and K13.
F32_IDS = {"K1": "K11", "K3": "K12", "K4q8": "K13q8", "K4qfull": "K13qfull"}


def phase_kernels(images, cfg, tables):
    """The RGB palette kernels (K1-K4 on uint8, K11-K13 on float32) and K2
    against their plain versions on the card; returns per-kernel max abs
    error and the inputs the timing phase reuses."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import quantize as qz
    from photohive_dsp_tpu_torch.ops.margin_sort import (
        margin_insertion_argsort, margin_sort)

    c = cfg.num_cells
    _, q_full = qz.palette_widths(cfg)
    u8 = torch.as_tensor(np.stack([planar(im) for im in images]),
                         device=DEVICE)
    f32 = (u8.float() / 255.0).contiguous()
    err = {"K2": 0.0}
    for name, x in (("f32", f32), ("u8", u8)):
        ids = F32_IDS if name == "f32" else {k: k for k in F32_IDS}
        counts, s_sum = pk.cell_counts_s_from_rgb(x, cfg)
        counts0, s_sum0 = pk.cell_counts_s_from_rgb_plain(x, cfg)
        sync()
        if not torch.equal(counts, counts0):
            raise AssertionError(f"{ids['K1']} {name}: counts differ")
        if not torch.equal(s_sum, s_sum0):
            raise AssertionError(f"{ids['K1']} {name}: s_sum rel err "
                                 f"{rel_err(s_sum, s_sum0)}")
        err[ids["K1"]] = float((s_sum - s_sum0).abs().max())

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
            key = ids[key]
            got = kern(x, *tabs, cfg)
            want = plain(x, *tabs, cfg)
            sync()
            if not torch.equal(got[..., 3], want[..., 3]):
                raise AssertionError(f"{key} {name}: counts differ")
            if not torch.equal(got, want):
                raise AssertionError(f"{key} {name}: sums rel err "
                                     f"{rel_err(got, want)}")
            err[key] = float((got - want).abs().max())
        log(f"  kernels {name}: {', '.join(ids.values())} match their "
            f"plain versions")
    check_margin_sort()
    return err, dict(u8=u8, f32=f32, slot=slot, off=off, sal=sal,
                     assign=assign, counts=counts)


# K2 beyond tests/test_torch_margin_sort.SORT_CS: the 16- and 32-warp
# buckets, at B=1.
SORT_BIG_CS = [2500, 9000, 17000]


def check_margin_sort() -> None:
    """K2 bit-equal to its plain version at every C of
    tests/test_torch_margin_sort.SORT_CS (each bucket's edges), B=1, 4 and
    16, on each of its data kinds (uniform, ties inside the margin, all
    equal, monotone, exactly 1.0 apart, subtractions that round near 1e7),
    and at SORT_BIG_CS."""
    from photohive_dsp_tpu_torch.ops.margin_sort import (
        margin_insertion_argsort, margin_sort, sort_layout)
    from tests.test_torch_margin_sort import KINDS, SORT_CS, sort_data

    for c in SORT_CS:
        for kind in KINDS:
            sal = torch.as_tensor(sort_data(kind, 16, c), device=DEVICE)
            want = margin_insertion_argsort(sal)
            for b in (1, 4, 16):
                if not torch.equal(margin_sort(sal[:b].contiguous()),
                                   want[:b]):
                    raise AssertionError(f"K2 C={c} B={b} {kind}: order "
                                         f"differs from plain")
    for c in SORT_BIG_CS:
        sal = torch.as_tensor(sort_data("rounded+jitter", 1, c),
                              device=DEVICE)
        if not torch.equal(margin_sort(sal), margin_insertion_argsort(sal)):
            raise AssertionError(f"K2 C={c}: order differs from plain")
    log(f"  K2 bit-equal to plain at C={SORT_CS} (B=1, 4, 16; {len(KINDS)} "
        f"data kinds) and C={SORT_BIG_CS} (B=1); buckets (warps, "
        f"registers) {sorted({sort_layout(c) for c in SORT_CS + SORT_BIG_CS})}")


def luma(images) -> torch.Tensor:
    """(B, H, W) luma of uint8 frames on the card (sharpness's input)."""
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_pgm, \
        u8_to_unit_f32

    rgb = u8_to_unit_f32(torch.as_tensor(
        np.stack([planar(im) for im in images]), device=DEVICE))
    return rgb_to_pgm(rgb[:, 0], rgb[:, 1], rgb[:, 2]).contiguous()


def check_sharpness(pgm, bt, label: str, halo=None, row_offset: int = 0):
    """K5 against its plain version: bit-identical over two launches,
    within SHARP_RTOL of plain, zero exactly where plain is zero.  Returns
    (max abs error, max rel error)."""
    from photohive_dsp_tpu_torch.ops import sharpness_kernels as sk

    got = sk.sharpness_sums(pgm, bt, halo, row_offset)
    again = sk.sharpness_sums(pgm, bt, halo, row_offset)
    want = sk.sharpness_sums_plain(pgm, bt, halo, row_offset)
    sync()
    err = rel = 0.0
    for name, g, a, w in zip(("s1", "s2"), got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"K5 {label} {name}: two launches differ")
        on = w != 0
        r = rel_err(g[on], w[on]) if bool(on.any()) else 0.0
        if not r <= SHARP_RTOL:
            raise AssertionError(f"K5 {label} {name}: rel err {r}")
        if not torch.equal(g == 0, w == 0):
            raise AssertionError(f"K5 {label} {name}: zero where plain is "
                                 f"not, or not where it is")
        err, rel = max(err, float((g - w).abs().max())), max(rel, r)
    return err, rel


def sharpness_edge_cases():
    """{label: (pgm, boxes, halo, row_offset)}: the cases of
    tests/test_torch_cuda.py::test_cuda_sharpness_kernel_matches_plain
    (1080x1000 B=2: the whole frame, a box across 32-row and 128-column
    seams, a corner box, a box over the halo row; without and with a halo,
    row offsets 0 and 3), and 1092x1001 B=2 (rows not 16-byte aligned) and
    1080x1920 B=16 with main_boxes."""
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import sharpness_kernels as sk

    rng = np.random.default_rng(9)
    b, h, w = 2, 1080, 1000
    pgm = torch.as_tensor(rng.random((b, h, w), dtype=np.float32),
                          device=DEVICE)
    halo = torch.as_tensor(rng.random((b, 2, w), dtype=np.float32),
                           device=DEVICE)
    boxes = torch.zeros((b, 10, 4), dtype=torch.int32)
    boxes[:, 0] = torch.tensor([0, 1080, 0, 1000])
    boxes[:, 1] = torch.tensor([31, 65, 127, 129 + 4])
    boxes[:, 4] = torch.tensor([1040, 1080, 900, 1000])
    boxes[1, 9] = torch.tensor([-3, 20, 5, 400])
    boxes = boxes.to(DEVICE)
    cases = {f"1080x1000 B=2 halo {hl is not None} row_offset {off}":
             (pgm, boxes, hl, off)
             for hl in (None, halo) for off in (0, 3)}
    for b, h, w in ((2, 1092, 1001), (16, H, W)):
        bx, vd = pt.set_bounding_boxes(main_boxes(h, w))
        bt = sk.box_tensor(np.stack([bx] * b), np.stack([vd] * b), DEVICE)
        cases[f"{h}x{w} B={b} main_boxes"] = (
            luma([noise_image(rng, h, w) for _ in range(b)]), bt, None, 0)
    return cases


def phase_sharpness_kernel(images):
    """K5 against its plain version (check_sharpness) at 1080x1920 B=4
    with main_boxes (one touching the top and right edges) and on
    sharpness_edge_cases; returns its max abs error and the inputs the
    timing phase reuses."""
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import sharpness_kernels as sk

    pgm = luma(images)
    boxes, valid = pt.set_bounding_boxes(main_boxes(H, W))
    bt = sk.box_tensor(np.stack([boxes] * len(images)),
                       np.stack([valid] * len(images)), DEVICE)
    err, rel = check_sharpness(pgm, bt, f"B={len(images)} 3 boxes")
    for label, (x, bx, halo, off) in sharpness_edge_cases().items():
        e, r = check_sharpness(x, bx, label, halo, off)
        err, rel = max(err, e), max(rel, r)
    log(f"  K5 B={len(images)} 3 boxes and the edge cases: bit-identical "
        f"twice, zero where plain is, rel err {rel:.2e}")
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


def assignment(counts, p: int, cfg, octree):
    """The parent assignment the palette routes derive from cell counts:
    saliency, K2's order, then parent_assignment_from_order."""
    from photohive_dsp_tpu_torch.ops import quantize as qz
    from photohive_dsp_tpu_torch.ops.margin_sort import margin_sort

    order = margin_sort(qz.saliency_f32(counts, octree.s_v_f32, cfg))
    return qz.parent_assignment_from_order(counts, order, p, cfg, octree)


def cell_ids(hsv, cfg) -> torch.Tensor:
    """(B, P) int32 cell ids of flat HSV pixels, C for the sentinels."""
    from photohive_dsp_tpu_torch.ops.quantize import assign_cells

    real = hsv[0] >= 0.0
    ids = assign_cells(torch.where(real, hsv[0], 0.0), hsv[1], hsv[2], cfg)
    return torch.where(real, ids, cfg.num_cells).contiguous()


def check_cwide(hsv, assign, octree, cfg, label: str, real=None) -> None:
    """K14 against its plain version and against K10 at the width the
    batch needs (q=8 or q_full): the int64 accumulators equal bit for bit;
    with ``real``, K14 equals its run on the real pixels alone."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import quantize as qz

    tabs = pk.cwide_tables(assign, octree)
    got = pk.palette_sums_by_k_cwide(*hsv, *tabs, cfg)
    want = pk.palette_sums_by_k_cwide_plain(*hsv, *tabs, cfg)
    counts, _ = pk.counts_s_from_fixed(pk.cell_counts_from_hsv(*hsv, cfg))
    q = max(int(qz.palette_tier(counts, assign, cfg)), 8)
    k10 = pk.palette_sums_by_k(*hsv, *pk.palette_candidate_table(
        assign, octree, cfg.num_cells, q), cfg)
    sync()
    if not torch.equal(got, want):
        raise AssertionError(f"K14 {label}: differs from plain, max abs err "
                             f"{float((got - want).abs().max())} "
                             f"(fixed-point units)")
    if not torch.equal(got, k10):
        raise AssertionError(f"K14 {label}: differs from K10 at q={q}")
    if real is not None and not torch.equal(
            got, pk.palette_sums_by_k_cwide(*real, *tabs, cfg)):
        raise AssertionError(f"K14 {label}: the sentinel tail changes the "
                             f"result")
    log(f"  K14 {label}: accumulator equals its plain version's and K10's "
        f"at q={q}" + (", the tail changes nothing" if real else ""))


def check_route_kernels(variant: str, x, octree, cfg, label: str) -> str:
    """The palette kernels ``variant``'s route launches on one batch
    against their plain versions, on the inputs the route hands them, bit
    for bit.  x: the batch as BatchRunner.run_u8 puts it on the card,
    (B, 3, H, W) uint8.  bf16: K1, then K3 or K4 at the batch's tier, on x;
    candidate: K11, then K12 or K13, on its decoded float32 planes; cwide:
    K9 on its flat HSV planes, then K14 (check_cwide).  Returns the ids
    checked."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import quantize as qz
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv, \
        u8_to_unit_f32

    b, _, hh, ww = x.shape
    if variant == "cwide":
        rgb = u8_to_unit_f32(x)
        hsv = [t.reshape(b, -1).contiguous()
               for t in rgb_to_hsv(rgb[:, 0], rgb[:, 1], rgb[:, 2])]
        acc = pk.cell_counts_from_hsv(*hsv, cfg)
        if not torch.equal(acc, pk.cell_counts_from_hsv_plain(*hsv, cfg)):
            raise AssertionError(f"K9 {label}: differs from plain")
        counts, _ = pk.counts_s_from_fixed(acc)
        check_cwide(hsv, assignment(counts, hh * ww, cfg, octree), octree,
                    cfg, label)
        return "K9, K14"
    k1, k3, k4 = ("K1", "K3", "K4") if variant == "bf16" else \
        ("K11", "K12", "K13")
    rgb = x if variant == "bf16" else u8_to_unit_f32(x).contiguous()
    counts, s_sum = pk.cell_counts_s_from_rgb(rgb, cfg)
    want = pk.cell_counts_s_from_rgb_plain(rgb, cfg)
    sync()
    if not (torch.equal(counts, want[0]) and torch.equal(s_sum, want[1])):
        raise AssertionError(f"{k1} {label}: differs from plain")
    assign = assignment(counts, hh * ww, cfg, octree)
    q = int(qz.palette_tier(counts, assign, cfg))
    if q == 1:
        key, kern, plain = k3, pk.palette_sums_by_k_rgb_q1, \
            pk.palette_sums_by_k_rgb_q1_plain
        tabs = pk.palette_offset_table(assign, octree, cfg.num_cells)
    else:
        key, kern, plain = f"{k4} q={q}", pk.palette_sums_by_k_rgb, \
            pk.palette_sums_by_k_rgb_plain
        tabs = pk.palette_candidate_table(assign, octree, cfg.num_cells, q)
    got, want = kern(rgb, *tabs, cfg), plain(rgb, *tabs, cfg)
    sync()
    if not torch.equal(got, want):
        raise AssertionError(f"{key} {label}: differs from plain, max abs "
                             f"err {float((got - want).abs().max())}")
    return f"{k1}, {key}"


def phase_flat_kernels(kin, cfg, tables):
    """K9 and K10 (q=8 and q_full) against their plain versions at
    1080x1920 B=4 on flat HSV with a sentinel tail (check_flat_kernels),
    and K9's counts against K1's on the same frames; K15 against its plain
    version and K9's counts; K14 against its plain version and K10
    (check_cwide) on those frames and on a noise batch and a hue-wheel
    batch.  Returns max abs errors and the timing phase's inputs."""
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
    ids = cell_ids(hsv, cfg)
    k15 = pk.cell_counts_batched(ids, cfg.num_cells)
    if not torch.equal(k15, pk.cell_counts_batched_plain(ids, cfg.num_cells)):
        raise AssertionError("K15: differs from its plain version")
    if not torch.equal(k15, counts):
        raise AssertionError("K15: differs from K9's counts")
    log(f"  K15 on the same pixels' cell ids (sentinels -> C): equals its "
        f"plain version and K9's counts")
    cw_tabs = pk.cwide_tables(kin["assign"], tables.octree)
    check_cwide(hsv, kin["assign"], tables.octree, cfg, "1080x1920 B=4 "
                f"(q={q_full} batch)", real)
    rng = np.random.default_rng(SEED + 5)
    for label, make in (("noise", noise_image), ("hue wheel",
                                                 hue_wheel_image)):
        frames = torch.as_tensor(np.stack([planar(make(rng))
                                           for _ in range(x.shape[0])]),
                                 device=DEVICE)
        f_hsv = flat_hsv(frames, SENTINEL_TAIL)
        f_counts, _ = pk.counts_s_from_fixed(pk.cell_counts_from_hsv(*f_hsv,
                                                                     cfg))
        f_assign = assignment(f_counts, p, cfg, tables.octree)
        check_cwide(f_hsv, f_assign, tables.octree, cfg,
                    f"{label} 1080x1920 B={x.shape[0]}")
    return ({"K9": 0.0, "K10q8": 0.0, "K10qfull": 0.0, "K14": 0.0,
             "K15": 0.0}, dict(hsv=hsv, p=p, ids=ids, cw_tabs=cw_tabs))


def phase_blur_kernels(images, cfg):
    """K6a, K6b and K7+K8 against their plain versions on the card at the
    BLUR_SHAPES; returns per-kernel max abs error at 1080x1920 B=4 and the
    inputs the timing phase reuses."""
    from photohive_dsp_tpu_torch.config import ReportConfig
    from photohive_dsp_tpu_torch.ops import fft_kernels as fk
    from photohive_dsp_tpu_torch.ops.blur import PolarTables, \
        blur_bins_lognorm
    from photohive_dsp_tpu_torch.ops.fft_plan import FftPlan

    a, r = cfg.angle_partitions, cfg.radius_partitions
    rng = np.random.default_rng(SEED + 2)

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
        e_polar = check_polar(flat, polar.bin_ids, polar.bin_counts, label)
        zero = blur_bins_lognorm(torch.zeros_like(x), plan, polar, a, r)
        sync()
        if not bool(torch.isfinite(zero).all()) or bool(zero.any()):
            raise AssertionError(f"{label}: zero frame gives nonzero bins")
        log(f"  {label}: K6a/K6b equal plain bit for bit; |rfft2|^2 "
            f"{snr_k:.1f} dB (plain {snr_p:.1f} dB) vs float64; K7+K8 "
            f"sums, max and means equal plain bit for bit, twice; zero "
            f"frame -> zero bins")
        if (h, w) == (H, W):
            err = {"K6a": e_rows, "K6b": e_cols, "K7+K8": e_polar}
            kin = dict(x=x, plan=plan, polar=polar, spec=spec0, flat=flat)
    big = ReportConfig(angle_partitions=360, radius_partitions=100)
    nb = big.angle_partitions * big.radius_partitions
    big_tables = PolarTables.for_shape(H, W, big, DEVICE)
    check_polar(kin["flat"], big_tables.bin_ids, big_tables.bin_counts,
                "360x100 bins")
    log(f"  K7+K8 global-atomics branch, {nb} bins ({8 * nb} B table): "
        f"equal plain bit for bit, twice")
    return err, kin


def check_polar(flat, ids, counts, label: str) -> float:
    """K7+K8 on (B, P) |X|^2: its sums and maxima, and its means with
    ``counts``, each launched twice, against the plain versions bit for
    bit; returns the sums' max abs error (0)."""
    from photohive_dsp_tpu_torch.ops import polar_kernels as pol

    nb = counts.shape[0]
    got = [pol.polar_bin_sums_lognorm(flat, ids, nb) for _ in range(2)]
    means = [pol.polar_bin_means_lognorm(flat, ids, counts)
             for _ in range(2)]
    sums0, mx0 = pol.polar_bin_sums_lognorm_plain(flat, ids, nb)
    means0 = pol.polar_bin_means_lognorm_plain(flat, ids, counts)
    sync()
    for (sums, mx), m in zip(got, means):
        for what, x, x0 in (("sums", sums, sums0), ("max", mx, mx0),
                            ("means", m, means0)):
            if not torch.equal(x, x0):
                raise AssertionError(
                    f"K7+K8 {label}: {what} differ from plain, max abs err "
                    f"{float((x - x0).abs().max())}")
    return float((got[0][0] - sums0).abs().max())


# K6a's edge cases, (B, H, W): odd row counts (the last row pairs with
# zeros), 1001 = 7 * 11 * 13 (single stages), 3840, 14520 = 2^3 * 3 * 5 *
# 11^2 (the stage twiddles in device memory), and lengths whose passes
# (fft_plan.row_passes) reach every fused pair and single stage the others
# miss: 1080 (4x2, 3x3), 480 (2x3), 12 (4x3), 10 (2x5), 14 (2x7), 9, 64
# (4 alone), 5, 3, 2 and 1.
ROW_FFT_EDGES = [(1, 3, 1920), (3, 5, 1001), (1, 7, 3840), (1, 3, 14520),
                 (1, 3, 1080), (1, 3, 480), (1, 3, 12), (1, 3, 10),
                 (1, 3, 14), (1, 3, 9), (1, 3, 64), (1, 3, 5), (1, 3, 3),
                 (1, 3, 2), (1, 3, 1)]


def phase_row_fft_edges() -> None:
    """K6a against fft_rows_plain bit for bit on ROW_FFT_EDGES."""
    from photohive_dsp_tpu_torch.ops import fft_kernels as fk
    from photohive_dsp_tpu_torch.ops.fft_plan import FftPlan

    rng = np.random.default_rng(SEED + 6)
    for b, h, w in ROW_FFT_EDGES:
        x = torch.as_tensor(rng.standard_normal((b, h, w), dtype=np.float32),
                            device=DEVICE)
        x[0, 0, ::7] = 0.0
        plan = FftPlan.for_shape(h, w, DEVICE)
        got, want = fk.fft_rows(x, plan), fk.fft_rows_plain(x, plan)
        sync()
        if not torch.equal(got, want):
            raise AssertionError(f"K6a {b}x{h}x{w}: differs from plain, max "
                                 f"abs err {float((got - want).abs().max())}")
    log(f"  K6a equals plain bit for bit at {ROW_FFT_EDGES} (B, H, W)")


# K6b's edge cases, (B, H, W): heights whose passes (fft_plan.row_passes)
# reach every fused pair (1080: 4x2, 3x3, 3x5; 720: 4x4; 480: 2x3; 1092 and
# 12: 4x3; 10: 2x5; 14: 2x7; 15 and 9: one pass, first and last) and every
# single stage (64: 4; 720: 5; 7, 11, 13, 143 = 11 x 13 and 1001; 3; 2),
# H = 1; the tile layouts of fft_plan.col_tile (4 lanes; 2 at 2160; 1 with
# the twiddle table in shared memory at 4320, in device memory at 7000 and
# 14520, the tallest); half widths that are no multiple of the tile
# (1001: 501; 30: 16 of 4 lanes is one, so 9: 5 and 6: 4 too).
COL_FFT_EDGES = [(1, 1080, 30), (2, 1092, 1001), (1, 2160, 10),
                 (1, 4320, 6), (1, 7000, 6), (1, 14520, 4), (1, 720, 9),
                 (1, 480, 9), (1, 143, 9), (1, 1001, 9), (1, 64, 9),
                 (1, 12, 9), (1, 10, 9), (1, 14, 9), (1, 15, 9), (1, 9, 9),
                 (1, 7, 9), (1, 11, 9), (1, 13, 9), (1, 5, 9), (1, 3, 9),
                 (1, 2, 9), (1, 1, 9)]


def phase_col_fft_edges() -> None:
    """K6b against fft_cols_plain bit for bit on COL_FFT_EDGES, on a half
    spectrum of noise with a zero column and zero rows."""
    from photohive_dsp_tpu_torch.ops import fft_kernels as fk
    from photohive_dsp_tpu_torch.ops.fft_plan import FftPlan

    rng = np.random.default_rng(SEED + 10)
    for b, h, w in COL_FFT_EDGES:
        spec = torch.as_tensor(rng.standard_normal((b, h, w // 2 + 1, 2),
                                                   dtype=np.float32),
                               device=DEVICE)
        spec[0, :, 0] = 0.0
        spec[0, ::3, -1] = 0.0
        plan = FftPlan.for_shape(h, w, DEVICE)
        got, want = fk.fft_cols(spec, plan), fk.fft_cols_plain(spec, plan)
        sync()
        if not torch.equal(got, want):
            raise AssertionError(f"K6b {b}x{h}x{w}: differs from plain, max "
                                 f"abs err {float((got - want).abs().max())}")
    log(f"  K6b equals plain bit for bit at {COL_FFT_EDGES} (B, H, W)")


def one_colour_frames(b: int, h: int, w: int) -> np.ndarray:
    """(B, 3, H, W) uint8 frames of one colour: every lane of a warp on one
    slot, the palette-sums kernel's worst case for collisions."""
    rgb = np.empty((b, 3, h, w), np.uint8)
    rgb[:, 0], rgb[:, 1], rgb[:, 2] = 201, 77, 30
    return rgb


def stripe_frames(b: int, h: int, w: int) -> np.ndarray:
    """Two colours in vertical stripes 5 px wide: two slots a warp."""
    rgb = one_colour_frames(b, h, w)
    rgb[..., (np.arange(w) // 5) % 2 == 1] = np.array(
        [20, 90, 180], np.uint8)[:, None, None]
    return rgb


def palette_sums_routes(x, cfg, octree, tail: int = 777):
    """Every route of the palette-sums kernel on (B, 3, H, W) uint8 frames
    on the card: [(label, kernel, plain version, pixel inputs, tables)] for
    K3 (q=1) and K4 (q=8, q_full) on the uint8 frames and on their float32
    planes (K12, K13), and K10 (q=8, q_full) and K14 on their flat HSV with
    a hue-sentinel tail."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import quantize as qz
    from photohive_dsp_tpu_torch.ops.colorspace import u8_to_unit_f32

    c = cfg.num_cells
    b, _, hh, ww = x.shape
    counts, _ = pk.cell_counts_s_from_rgb(x, cfg)
    assign = assignment(counts, hh * ww, cfg, octree)
    _, q_full = qz.palette_widths(cfg)
    f32 = u8_to_unit_f32(x).contiguous()
    hsv = flat_hsv(x, tail)
    q1 = pk.palette_offset_table(assign, octree, c)
    runs = [("K3", pk.palette_sums_by_k_rgb_q1,
             pk.palette_sums_by_k_rgb_q1_plain, [x], q1),
            ("K12", pk.palette_sums_by_k_rgb_q1,
             pk.palette_sums_by_k_rgb_q1_plain, [f32], q1)]
    for q in (8, q_full):
        tabs = pk.palette_candidate_table(assign, octree, c, q)
        runs += [(f"K4 q={q}", pk.palette_sums_by_k_rgb,
                  pk.palette_sums_by_k_rgb_plain, [x], tabs),
                 (f"K13 q={q}", pk.palette_sums_by_k_rgb,
                  pk.palette_sums_by_k_rgb_plain, [f32], tabs),
                 (f"K10 q={q}", pk.palette_sums_by_k,
                  pk.palette_sums_by_k_plain, hsv, tabs)]
    runs.append(("K14", pk.palette_sums_by_k_cwide,
                 pk.palette_sums_by_k_cwide_plain, hsv,
                 pk.cwide_tables(assign, octree)))
    return runs


def check_palette_sums_routes(x, cfg, label: str) -> None:
    """Every route of palette_sums_routes equal to its plain version bit for
    bit (K3/K4/K12/K13's float32 sums, K10/K14's int64 accumulators)."""
    from photohive_dsp_tpu_torch.ops import quantize as qz

    octree = qz.OctreeTables.for_config(cfg, DEVICE)
    for key, kern, plain, px, tabs in palette_sums_routes(x, cfg, octree):
        want = plain(*px, *tabs, cfg)
        got = kern(*px, *tabs, cfg)
        sync()
        if not torch.equal(got, want):
            raise AssertionError(
                f"{key} {label}: differs from plain, max abs err "
                f"{float((got - want).abs().max())}")


# A noise frame (seed 5) on which the tie-break distance decides: two
# pixels (flat indices) take another parent when the distance rounds after
# every operation than when it is fused as jitted XLA fuses it
# (ops/palette_kernels._nearest_candidates).
NEAR_TIE_SEED = 5
NEAR_TIE_PIXELS = [529788, 1153689]


def near_tie_frame() -> np.ndarray:
    return noise_image(np.random.default_rng(NEAR_TIE_SEED))


def tie_break_slots(x, cfg, octree, assign, fused: bool) -> torch.Tensor:
    """(P,) slot of each pixel of one (1, 3, H, W) uint8 frame among its
    cell's q=8 candidates, the distance fused as the plain versions compute
    it (``stats.fma_f32``) or rounded after every operation; C for a pixel
    without a candidate."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv, \
        u8_to_unit_f32
    from photohive_dsp_tpu_torch.ops.quantize import assign_cells
    from photohive_dsp_tpu_torch.ops.stats import fma_f32

    c = cfg.num_cells
    rgb = u8_to_unit_f32(x[0]).reshape(3, -1)
    h, s, v = rgb_to_hsv(rgb[0], rgb[1], rgb[2])
    cand, ctr = pk.palette_candidate_table(assign, octree, c, 8)
    cand = cand[0].long()[assign_cells(h, s, v, cfg).long()]    # (P, 8)
    m = ctr[0][cand.clamp(max=c - 1)]                            # (P, 8, 3)
    hd = (h[:, None] - m[..., 0]).abs()
    hd = torch.where(hd > 180.0, 360.0 - hd, hd) * (1.0 / 360.0)
    sd = s[:, None] - m[..., 1]
    vd = v[:, None] - m[..., 2]
    d = fma_f32(vd, vd, fma_f32(sd, sd, hd * hd)) if fused else \
        hd * hd + sd * sd + vd * vd
    d = torch.where(cand < c, d, float("inf"))
    return torch.gather(cand, 1, d.argmin(dim=1, keepdim=True))[:, 0]


def phase_near_tie_frame(cfg) -> None:
    """The palette-sums kernel on the 1080x1920 near-tie frame: every route
    of palette_sums_routes (K4 on uint8, K13 on float32, K10 and K14 on flat
    HSV, and K3/K12) equal to its plain version bit for bit, and the
    tie-breaking plain versions' counts those of the fused distance, which
    moves exactly NEAR_TIE_PIXELS against the unfused one."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import quantize as qz

    x = torch.as_tensor(planar(near_tie_frame())[None], device=DEVICE)
    octree = qz.OctreeTables.for_config(cfg, DEVICE)
    counts, _ = pk.cell_counts_s_from_rgb(x, cfg)
    assign = assignment(counts, H * W, cfg, octree)
    if int(qz.palette_tier(counts, assign, cfg)) != 8:
        raise AssertionError("near-tie frame: not a q=8 frame")
    fused, unfused = (tie_break_slots(x, cfg, octree, assign, f)
                      for f in (True, False))
    moved = torch.nonzero(fused != unfused)[:, 0].tolist()
    if moved != NEAR_TIE_PIXELS:
        raise AssertionError(f"near-tie frame: the fused distance moves "
                             f"pixels {moved}, not {NEAR_TIE_PIXELS}")
    c = cfg.num_cells
    want_counts = torch.bincount(fused, minlength=c + 1)[:c]
    checked = []
    for key, kern, plain, px, tabs in palette_sums_routes(x, cfg, octree):
        want = plain(*px, *tabs, cfg)
        got = kern(*px, *tabs, cfg)
        sync()
        if not torch.equal(got, want):
            raise AssertionError(
                f"{key} near-tie frame: differs from plain, max abs err "
                f"{float((got - want).abs().max())}")
        if key not in ("K3", "K12") and not torch.equal(
                want[0, :, 3].long(), want_counts):
            raise AssertionError(f"{key} near-tie frame: the plain version's"
                                 f" counts are not the fused distance's")
        checked.append(key)
    log(f"  near-tie frame {H}x{W} seed {NEAR_TIE_SEED}: the fused distance "
        f"moves pixels {moved} against the unfused one; "
        + ", ".join(checked) + " equal plain bit for bit, the tie-breaking "
        "ones with the fused distance's counts")


def phase_palette_sums_edges(cfg) -> None:
    """The palette-sums kernel (K3, K4, K10, K12-K14) on its edge cases: a
    one-colour 1080x1920 batch of 4 (the timed collision case), two-colour
    stripes and noise at 61x67 (a pixel count that is no multiple of the
    4-pixel loads or of a block's run), and noise at C=2164
    (h_partitions=360: the candidate table and the bitmask in device
    memory)."""
    from photohive_dsp_tpu_torch.config import ReportConfig

    rng = np.random.default_rng(SEED + 7)
    cases = [("one colour 1080x1920 B=4", one_colour_frames(4, H, W), cfg),
             ("stripes 61x67 B=2", stripe_frames(2, 61, 67), cfg),
             ("noise 61x67 B=2",
              rng.integers(0, 256, (2, 3, 61, 67), dtype=np.uint8), cfg),
             ("noise 64x255 C=2164",
              rng.integers(0, 256, (1, 3, 64, 255), dtype=np.uint8),
              ReportConfig(h_partitions=360))]
    for label, frames, c in cases:
        check_palette_sums_routes(torch.as_tensor(frames, device=DEVICE), c,
                                  label)
    log(f"  palette sums K3, K4 (q=8, q_full), K10 (q=8, q_full), K12, K13, "
        f"K14 equal plain bit for bit on: "
        + "; ".join(label for label, _, _ in cases))


def all_triples(b: int = 1) -> np.ndarray:
    """(B, 3, 4096, 4096) uint8: every RGB triple once an image."""
    i = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([i >> 16, (i >> 8) & 255, i & 255]).astype(np.uint8)
    return np.broadcast_to(rgb.reshape(1, 3, 4096, 4096),
                           (b, 3, 4096, 4096)).copy()


def check_cell_counts(x, cfg, label: str) -> None:
    """The cell histogram on (B, 3, H, W) uint8 frames on the card, bit
    for bit against the plain versions: K1 on the uint8 frames, K11 on
    their float32 planes, K9 on their flat HSV with a sentinel tail, K15
    on the flat HSV's cell ids."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops.colorspace import u8_to_unit_f32

    hsv = flat_hsv(x, 777)
    ids = cell_ids(hsv, cfg)
    runs = [("K1", pk.cell_counts_s_from_rgb, pk.cell_counts_s_from_rgb_plain,
             (x, cfg)),
            ("K11", pk.cell_counts_s_from_rgb,
             pk.cell_counts_s_from_rgb_plain,
             (u8_to_unit_f32(x).contiguous(), cfg)),
            ("K9", pk.cell_counts_from_hsv, pk.cell_counts_from_hsv_plain,
             (*hsv, cfg)),
            ("K15", pk.cell_counts_batched, pk.cell_counts_batched_plain,
             (ids, cfg.num_cells))]
    for key, kern, plain, args in runs:
        got, want = kern(*args), plain(*args)
        sync()
        for g, w in zip(got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want]):
            if not torch.equal(g, w):
                raise AssertionError(f"{key} {label}: differs from plain")


# (B, H, W): the polar kernel's edges, on a real spectrum.
POLAR_EDGE_SHAPE = (2, 1080, 1920)


# Grids whose cell steps send uint8 triples to other cells under IEEE
# division than under the JAX package's jitted x * f32(1/L): 1498 triples
# at 12x3x2, 2640 at 24x5x5, 59 at 8x4x6 (none at the default 18x2x3).
CELL_GRIDS = [dict(h_partitions=12, s_partitions=3, v_partitions=2),
              dict(h_partitions=24, s_partitions=5, v_partitions=5),
              dict(h_partitions=8, s_partitions=4, v_partitions=6)]


def grid_name(c) -> str:
    return f"{c.h_partitions}x{c.s_partitions}x{c.v_partitions}"


def ieee_moved_frame(cfg, h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8 frame, in a seeded order, of the RGB triples whose
    cell at cfg's grid differs between IEEE division by the cell steps and
    the multiply by their float32 reciprocals (the port's and jitted JAX's
    cell id), found in numpy float32 from the port's HSV on the CPU."""
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv, \
        u8_to_unit_f32

    f32 = np.float32
    rgb = all_triples()[0].reshape(3, -1)
    hue, sat, val = (x.numpy() for x in rgb_to_hsv(
        *u8_to_unit_f32(torch.from_numpy(rgb))))

    def cells(ieee: bool) -> np.ndarray:
        def index(x, base, step, parts):
            y = x - f32(base)
            q = y / f32(step) if ieee else y * (f32(1) / f32(step))
            return np.clip(q, f32(0), f32(parts - 1e-6)).astype(np.int64)

        color = ((index(hue, 0.0, cfg.cell_Lh, cfg.h_partitions)
                  * cfg.s_partitions
                  + index(sat, cfg.gray_thresh, cfg.cell_Ls,
                          cfg.s_partitions)) * cfg.v_partitions
                 + index(val, cfg.black_thresh, cfg.cell_Lv,
                         cfg.v_partitions))
        return np.where(val < f32(cfg.black_thresh), cfg.black_id,
                        np.where(sat < f32(cfg.gray_thresh), cfg.gray_start,
                                 color))

    moved = rgb[:, np.flatnonzero(cells(True) != cells(False))].T
    rng = np.random.default_rng(seed)
    idx = np.resize(rng.permutation(len(moved)), h * w)
    return np.ascontiguousarray(moved[rng.permutation(idx)].reshape(h, w, 3))


def check_moved_triples_reports() -> None:
    """get_report on the card against the CPU path on 1080x1920 frames of
    the triples IEEE division would move, at 12x3x2 and 24x5x5: ids and
    percentages exact, the other fields at the port's bars."""
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.config import ReportConfig

    for knobs in CELL_GRIDS[:2]:
        c = ReportConfig(**knobs)
        img = ieee_moved_frame(c, H, W, SEED + 9)
        gpu = pt.get_report(img, device=DEVICE, **knobs)
        cpu = pt.get_report(img, device="cpu", **knobs)
        if gpu is None or cpu is None:
            raise AssertionError(f"{grid_name(c)}: get_report returned None")
        compare_reports(report_fields(gpu), report_fields(cpu),
                        f"get_report {H}x{W}, {grid_name(c)} triples "
                        f"IEEE division would move")


def phase_cell_and_polar_edges(cfg) -> None:
    """The cell histogram (K1, K9, K11, K15) on a one-colour batch and on
    every RGB triple (a 4096x4096 frame, at the default 18x2x3 grid and at
    CELL_GRIDS), with the palette-sums kernel on every triple too (the
    shared front end); get_report on frames of the triples IEEE division
    would move (check_moved_triples_reports); K7+K8 (sums, max, means) on a
    spectrum whose bins are one bin (one run a warp), one below the gate
    everywhere, one with ids out of range, and one whose pixel count is no
    multiple of 4."""
    from photohive_dsp_tpu_torch.config import ReportConfig
    from photohive_dsp_tpu_torch.ops.blur import PolarTables
    from photohive_dsp_tpu_torch.ops.fft_kernels import magnitude2
    from photohive_dsp_tpu_torch.ops.fft_plan import FftPlan

    check_cell_counts(torch.as_tensor(one_colour_frames(4, H, W),
                                      device=DEVICE), cfg,
                      "one colour 1080x1920 B=4")
    triples = torch.as_tensor(all_triples(), device=DEVICE)
    grids = [cfg] + [ReportConfig(**knobs) for knobs in CELL_GRIDS]
    for c in grids:
        check_cell_counts(triples, c, f"all 2^24 triples, {grid_name(c)}")
        check_palette_sums_routes(triples, c,
                                  f"all 2^24 triples, {grid_name(c)}")
    log("  K1, K9, K11, K15 equal plain bit for bit on a one-colour batch "
        "and on all 2^24 RGB triples ("
        + ", ".join(grid_name(c) for c in grids) + " grids); K3, K4, "
        "K10, K12-K14 too on the triples")
    check_moved_triples_reports()

    b, h, w = POLAR_EDGE_SHAPE
    rng = np.random.default_rng(SEED + 8)
    x = torch.as_tensor(rng.standard_normal((b, h, w), dtype=np.float32),
                        device=DEVICE)
    mag2 = magnitude2(x, FftPlan.for_shape(h, w, DEVICE)).reshape(b, -1)
    tables = PolarTables.for_shape(h, w, cfg, DEVICE)
    nb = tables.bin_counts.shape[0]
    p = mag2.shape[1]
    one_bin = torch.full((p,), nb // 3, dtype=torch.int32, device=DEVICE)
    stray = tables.bin_ids.clone()
    stray[::3] = -1
    stray[1::7] = nb + 5
    below = (mag2 / (mag2.amax() * 1.01)).contiguous()
    odd = p - 3
    cases = [("one bin", mag2, one_bin, tables.bin_counts),
             ("below the gate", below, tables.bin_ids, tables.bin_counts),
             ("ids out of range", mag2, stray, tables.bin_counts),
             (f"{odd} px", mag2[:, :odd].contiguous(),
              tables.bin_ids[:odd].contiguous(), tables.bin_counts)]
    for label, m, ids, counts in cases:
        check_polar(m, ids, counts, label)
    log(f"  K7+K8 sums, max and means equal plain bit for bit on {b}x{h}x"
        f"{w} spectra: " + "; ".join(c[0] for c in cases))


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


def main_path_inputs(images):
    """The main path's get_report calls [(label, image, boxes)] and its
    B=8 batch (frames, boxes, validity), host arrays."""
    import photohive_dsp_tpu_torch as pt

    noise, structured, wheel = images[:3]
    boxes = pt.set_bounding_boxes(main_boxes(H, W))
    thin = pt.set_bounding_boxes(main_boxes(H, W)[:2] + [thin_box(H, W)])
    calls = [("noise", noise, None), ("structured", structured, None),
             ("structured+3 boxes", structured, boxes),
             ("noise+3 boxes", noise, boxes),
             ("structured+thin box", structured, thin),
             ("hue wheel", wheel, None),
             ("noise seed 5 (near ties)", near_tie_frame(), None)]
    batch = np.stack([planar(images[i % len(images)]) for i in range(8)])
    return calls, batch, np.stack([boxes[0]] * 8), np.stack([boxes[1]] * 8)


def main_path_fields(reports, batch_data) -> dict:
    """The main path's results as arrays, "call i/field" for each
    get_report report and "batch i/field" for each image of the batch."""
    out = {}
    for i, rep in enumerate(reports):
        out.update({f"call {i}/{k}": np.asarray(v)
                    for k, v in report_fields(rep).items()})
    for i in range(batch_data.palette_n.shape[0]):
        out.update({f"batch {i}/{k}": np.asarray(v)
                    for k, v in data_fields(batch_data, i).items()})
    return out


def main_reports_child(out_path: str) -> int:
    """The main path of the package on sys.path on the card, its fields
    saved to ``out_path`` (.npz): what compare_parent_reports reads."""
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.config import ReportConfig

    phase_device()
    cfg = ReportConfig()
    calls, batch, bboxes, bvalid = main_path_inputs(smoke_images())
    tables = pt.ReportTables.build(H, W, cfg, DEVICE)
    reports = [pt.get_report(img, bx, device=DEVICE) for _, img, bx in calls]
    data = pt.full_report_batched(torch.as_tensor(batch, device=DEVICE),
                                  bboxes, bvalid, tables, cfg)
    np.savez(out_path, **main_path_fields(reports, data))
    return 0


# The main path's fields that move against a checkout whose palette rounds
# the tie-break distance and the saliency weight after every operation (one
# without ops/stats.fma_f32, as before the FMAs): pixels on near ties of the
# noise frames (calls 0, 3 and 6; batch images 0 and 4) and the hue wheel's
# gray band (call 5; batch images 2 and 6) take other parents, so their
# percentages and average HSV move.  Predicted by running both checkouts'
# plain versions on the CPU on these inputs; no id, count or other field
# moves.
UNFUSED_MOVES = frozenset(
    f"{item}/{field}" for item in ("call 0", "call 3", "call 5", "call 6",
                                   "batch 0", "batch 2", "batch 4", "batch 6")
    for field in ("palette_pct", "palette_hsv"))


def rounds_unfused(checkout: str) -> bool:
    """Whether the checkout's palette predates the distance's and the
    weight's FMAs (its ops/stats.py has no fma_f32)."""
    path = os.path.join(checkout, "photohive_dsp_tpu_torch", "ops",
                        "stats.py")
    with open(path) as f:
        return "def fma_f32" not in f.read()


def compare_parent_reports(parent: str, fields: dict) -> None:
    """The main path's default-config reports of the checkout at ``parent``
    (its own package, in a child process) against this one's, bit for
    bit: every field of every call and batch image, but for a parent that
    rounds unfused, the UNFUSED_MOVES fields, which must differ."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "main_reports.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--main-reports", os.path.abspath(parent), path],
                       check=True, timeout=600, stdout=subprocess.DEVNULL)
        with np.load(path) as npz:
            theirs = {k: npz[k] for k in npz.files}
    if sorted(theirs) != sorted(fields):
        raise AssertionError("main path: the parent's report fields differ "
                             "in name from this checkout's")
    moves = UNFUSED_MOVES if rounds_unfused(parent) else frozenset()
    for key, ours in fields.items():
        got = theirs[key]
        same = (got.dtype == ours.dtype and got.shape == ours.shape
                and got.tobytes() == ours.tobytes())
        if same and key in moves:
            raise AssertionError(f"main path {key}: predicted to move "
                                 f"against the parent {parent}, but equal")
        if not same and key not in moves:
            raise AssertionError(f"main path {key}: differs from the parent "
                                 f"{parent} on the card")
    log(f"  main path: {len(fields) - len(moves)} of the {len(fields)} "
        f"report fields of the get_report calls and the B=8 batch bit-equal"
        f" to the parent {parent}'s on the card, the {len(moves)} predicted "
        f"to move (UNFUSED_MOVES) moved")


def phase_main_path(images, cfg, parent=None):
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import _cuda
    from photohive_dsp_tpu_torch.ops.sharpness_kernels import box_tensor

    calls, batch, bboxes, bvalid = main_path_inputs(images)
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
    if parent:
        compare_parent_reports(parent, main_path_fields(gpu_reports,
                                                        gpu_batch))
    check_launches(launches, MAIN_COUNTERS, "main path")
    _, rel = check_sharpness(luma([images[i % len(images)] for i in range(8)]),
                             box_tensor(bboxes, bvalid, DEVICE),
                             "main path B=8")
    log(f"  K5 on the main path's B=8 batch: bit-identical twice, rel err "
        f"{rel:.2e}")
    return launches, tables_gpu, batch_gpu, bboxes, bvalid


# The kernels each palette variant must launch on the corpus path, and
# those of the other variants, which it must not.
CORPUS_COUNTERS = {
    "bf16": ("cell_counts_s", "palette_sums_q1", "palette_sums_q8",
             "palette_sums_qfull"),
    "candidate": ("cell_counts_s_f32", "palette_sums_q1_f32",
                  "palette_sums_q8_f32", "palette_sums_qfull_f32"),
    "cwide": ("cell_counts_hsv", "palette_sums_cwide"),
}
CORPUS_SHARED = ("margin_sort", "fft_rows", "fft_cols", "polar_bins")


def corpus_images():
    """Config #3's corpus: CORPUS_IMAGES uint8 (H, W, 3) frames, image i of
    CORPUS_SHAPES[i % 3].  Within a shape the kind changes with each batch
    of CORPUS_BATCH: noise (q=8), structured (q=1), hue wheel (q_full),
    over again, so every palette tier runs under every variant; structured
    and wheel frames are their shape's one frame rolled by a random
    offset."""
    rng = np.random.default_rng(SEED + 4)
    bases = {hw: {"structured": structured_image(rng, *hw),
                  "hue wheel": hue_wheel_image(rng, *hw)}
             for hw in CORPUS_SHAPES}
    items = []
    for i in range(CORPUS_IMAGES):
        hw = CORPUS_SHAPES[i % len(CORPUS_SHAPES)]
        kind = CORPUS_KINDS[(i // len(CORPUS_SHAPES) // CORPUS_BATCH)
                            % len(CORPUS_KINDS)]
        img = noise_image(rng, *hw) if kind == "noise" else np.roll(
            bases[hw][kind], int(rng.integers(hw[1])), axis=1)
        items.append((i, img))
    return items


def row_report(data, img):
    """A Report from one image's row of run_corpus's output."""
    import photohive_dsp_tpu_torch as pt

    return pt.Report(data, img.shape[0], img.shape[1])


def compare_variants(got: dict, ref: dict, label: str) -> None:
    """One image's report under two palette variants: ids, n and
    percentages equal, HSV < 5e-3, saturation rel < 1e-6, the rest
    equal."""
    for f in ("palette_ids", "palette_n", "palette_pct", "rgb_stats",
              "sharpness", "blur_bins", "blur_vector_angles",
              "blur_vector_mags"):
        if not np.array_equal(got[f], ref[f]):
            raise AssertionError(f"{label}: {f} differs")
    hsv = np.abs(got["palette_hsv"] - ref["palette_hsv"]).max(initial=0.0)
    sat = abs(got["average_saturation"] / ref["average_saturation"] - 1)
    if not (hsv < 5e-3 and sat < 1e-6):
        raise AssertionError(f"{label}: hsv {hsv}, saturation rel err {sat}")


def corpus_subset(items) -> set:
    """Keys of each bucket's first batch and its padded tail."""
    keys = set()
    for j in range(len(CORPUS_SHAPES)):
        bucket = [k for k, _ in items[j::len(CORPUS_SHAPES)]]
        tail = len(bucket) % CORPUS_BATCH
        keys.update(bucket[:CORPUS_BATCH] + (bucket[-tail:] if tail else []))
    return keys


def corpus_route_batches(items):
    """Each shape bucket's first batch of each kind (noise, structured, hue
    wheel: the q=8, q=1 and q_full tiers), stacked as run_corpus stacks
    it: [(label, (B, H, W, 3) uint8)]."""
    out = []
    for j, (hh, ww) in enumerate(CORPUS_SHAPES):
        bucket = [img for _, img in items[j::len(CORPUS_SHAPES)]]
        for b, kind in enumerate(CORPUS_KINDS):
            out.append((f"corpus {kind} {hh}x{ww} B={CORPUS_BATCH}",
                        np.stack(bucket[b * CORPUS_BATCH:
                                        (b + 1) * CORPUS_BATCH])))
    return out


def phase_corpus(cfg, smi: str):
    """run_corpus over config #3 under each palette variant (timed, each
    with its launch counts), the variants' reports against each other and,
    on corpus_subset, against get_report; each variant's palette kernels
    against their plain versions on corpus_route_batches; run_corpus and
    run_stream_u8 on the same frames (stream_times); process_corpus with a
    crash and a resume.  Returns the launch counts by variant and the MP/s
    measured."""
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.models import batch
    from photohive_dsp_tpu_torch.ops import _cuda
    from photohive_dsp_tpu_torch.ops import quantize as qz

    t0 = time.perf_counter()
    items = corpus_images()
    images = dict(items)
    mp = sum(im.shape[0] * im.shape[1] for _, im in items) / 1e6
    batch.warmup(CORPUS_SHAPES, cfg, batch_size=CORPUS_BATCH, device=DEVICE)
    log(f"  {len(items)} frames, {mp:.1f} MP, made in "
        f"{time.perf_counter() - t0:.1f} s")
    reports, launches, mps = {}, {}, {}
    try:
        for variant in VARIANTS:
            os.environ["PHOTOHIVE_PALETTE_KERNEL"] = variant
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            reports[variant] = dict(batch.run_corpus(
                iter(items), cfg, batch_size=CORPUS_BATCH, device=DEVICE))
            sync()
            dt = time.perf_counter() - t0
            launches[variant] = dict(_cuda.LAUNCHES)
            mps[variant] = mp / dt
            log(f"  run_corpus {variant}: {dt:.3f} s, {mps[variant]:.1f} "
                f"MP/s ({smi}); launches "
                f"{ {k: v for k, v in launches[variant].items() if v} }")
    finally:
        os.environ.pop("PHOTOHIVE_PALETTE_KERNEL", None)
    for variant in VARIANTS:
        if sorted(reports[variant]) != sorted(images):
            raise AssertionError(f"run_corpus {variant}: keys differ from "
                                 f"the corpus")
        others = [k for v in VARIANTS if v != variant
                  for k in CORPUS_COUNTERS[v]
                  if k not in CORPUS_COUNTERS[variant]]
        check_launches(launches[variant],
                       CORPUS_COUNTERS[variant] + CORPUS_SHARED,
                       f"corpus path ({variant})")
        stray = [k for k in others if launches[variant][k]]
        if stray:
            raise AssertionError(f"corpus path ({variant}) launched another "
                                 f"variant's kernels: {stray}")
    fields = {v: {k: report_fields(row_report(d, images[k]))
                  for k, d in reports[v].items()} for v in VARIANTS}
    for key in images:
        for variant in VARIANTS[1:]:
            compare_variants(fields[variant][key], fields["bf16"][key],
                             f"corpus image {key} {variant} vs bf16")
    log(f"  every report equal across {', '.join(VARIANTS)}")
    subset = sorted(corpus_subset(items))
    for key in subset:
        ref = pt.get_report(images[key], device=DEVICE)
        compare_reports(fields["bf16"][key], report_fields(ref),
                        f"corpus image {key}", "get_report")
    log(f"  {len(subset)} images (each bucket's first batch and tail) equal "
        f"get_report's")
    octree = qz.OctreeTables.for_config(cfg, DEVICE)
    for label, arr in corpus_route_batches(items):
        x = torch.as_tensor(arr, device=DEVICE).permute(0, 3, 1,
                                                         2).contiguous()
        done = [check_route_kernels(v, x, octree, cfg, label)
                for v in VARIANTS]
        log(f"  {label}: {'; '.join(done)} equal their plain versions")
    stream = stream_times(cfg, items, smi)
    corpus_breakdown(cfg, items, smi)
    txt = corpus_txt_resume(cfg, images)
    return launches, dict(mps, **stream, txt_mps=txt)


def corpus_breakdown(cfg, items, smi: str) -> None:
    """Where one run_corpus batch's time goes, each of its steps timed
    alone on the host clock, synchronised, on the 1080x1920 bucket's first
    batch: np.stack of the frames, their pageable copy to the card,
    full_report_batched there (BatchRunner.run_u8 on the device tensor),
    the copy of the reports to the host.  Medians of 3."""
    from photohive_dsp_tpu_torch.models import batch
    from photohive_dsp_tpu_torch.models.pipeline import ReportData

    runner = batch.BatchRunner(cfg, device=DEVICE)
    hw = CORPUS_SHAPES[1]
    frames = [img for _, img in items if img.shape[:2] == hw][:CORPUS_BATCH]
    steps = {"stack": [], "copy in": [], "report": [], "copy out": []}
    for _ in range(3):
        t = [time.perf_counter()]
        arr = np.stack(frames)
        t.append(time.perf_counter())
        x = torch.as_tensor(arr).to(DEVICE)
        sync()
        t.append(time.perf_counter())
        out = runner.run_u8(x)
        sync()
        t.append(time.perf_counter())
        ReportData(*(v.cpu() for v in out))
        t.append(time.perf_counter())
        for k, a, b in zip(steps, t, t[1:]):
            steps[k].append(1e3 * (b - a))
    med = {k: float(np.median(v)) for k, v in steps.items()}
    log(f"  one run_corpus batch, B={CORPUS_BATCH} {hw[0]}x{hw[1]} u8, "
        f"median of 3 ms: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                        med.items())
        + f"; sum {sum(med.values()):.3f} ({smi})")


STREAM_TURNS = ("prefetch 0", "prefetch 2", "run_corpus", "run_corpus",
                "prefetch 2", "prefetch 0") * 2


def stream_times(cfg, items, smi: str) -> dict:
    """run_corpus and run_stream_u8 without and with prefetch on the same
    frames, the 1080x1920 bucket's full batches of CORPUS_BATCH (the
    stream's batches stacked beforehand, its reports copied to the host as
    run_corpus's are): one untimed first run of each, then STREAM_TURNS.
    Every run's MP/s; each image's report equal in all three."""
    from photohive_dsp_tpu_torch.models import batch
    from photohive_dsp_tpu_torch.models.pipeline import ReportData

    runner = batch.BatchRunner(cfg, device=DEVICE)
    hh, ww = CORPUS_SHAPES[1]
    frames = [(k, img) for k, img in items if img.shape[:2] == (hh, ww)]
    n = len(frames) // CORPUS_BATCH
    frames = frames[:n * CORPUS_BATCH]
    boxes, valid = (np.zeros((CORPUS_BATCH, 10, 4), np.int32),
                    np.zeros((CORPUS_BATCH, 10), bool))
    batches = [(np.stack([img for _, img in frames[i * CORPUS_BATCH:
                                                   (i + 1) * CORPUS_BATCH]]),
                boxes, valid) for i in range(n)]
    mp = len(frames) * hh * ww / 1e6

    def stream(prefetch):
        out = {}
        for i, rep in enumerate(runner.run_stream_u8(iter(batches),
                                                     prefetch)):
            host = ReportData(*(v.cpu() for v in rep))
            for j in range(CORPUS_BATCH):
                out[frames[i * CORPUS_BATCH + j][0]] = ReportData(
                    *(v[j] for v in host))
        return out

    runs = {"prefetch 0": lambda: stream(0), "prefetch 2": lambda: stream(2),
            "run_corpus": lambda: dict(batch.run_corpus(
                iter(frames), cfg, batch_size=CORPUS_BATCH, device=DEVICE))}
    out, first, rates = {}, {}, {k: [] for k in runs}
    for i, mode in enumerate(list(runs) + list(STREAM_TURNS)):
        t0 = time.perf_counter()
        out[mode] = runs[mode]()
        sync()
        rate = mp / (time.perf_counter() - t0)
        if i < len(runs):
            first[mode] = rate
        else:
            rates[mode].append(rate)
    for mode in ("prefetch 2", "run_corpus"):
        for key, rep in out[mode].items():
            if not all(torch.equal(a, b) for a, b in
                       zip(rep, out["prefetch 0"][key])):
                raise AssertionError(f"{mode}: image {key}'s report differs "
                                     f"from run_stream_u8's without prefetch")
    log(f"  {n} x B={CORPUS_BATCH} {hh}x{ww} u8, the same frames, MP/s "
        f"({smi}); first run, then each run in turns "
        f"{', '.join(STREAM_TURNS[:6])}, twice; reports equal:")
    for mode in runs:
        log(f"    {mode}: first {first[mode]:.1f}; "
            + ", ".join(f"{r:.1f}" for r in rates[mode])
            + f" (median {float(np.median(rates[mode])):.1f})")
    return {f"same_{k.replace(' ', '')}_mps": float(np.median(v))
            for k, v in rates.items()}


def same_report_dict(got: dict, want: dict, label: str) -> None:
    """Two JSONL reports of one image: the same keys in order; integers
    equal (a colour channel, an HSV average truncated to an int, may move
    by one); floats within 1e-5 relative."""
    if list(got) != list(want):
        raise AssertionError(f"{label}: keys differ")
    for k, w in want.items():
        g = got[k]
        if isinstance(w, int) and not isinstance(w, bool):
            ok = g == w or (k.startswith("Color") and abs(g - w) <= 1)
        else:
            ok = abs(g - w) <= 1e-5 * abs(w)
        if not ok:
            raise AssertionError(f"{label}: {k} {g} vs {w}")


def corpus_txt_resume(cfg, images) -> float:
    """process_corpus on TXT_FRAMES 720x1280 .txt frames (the port's native
    writer), batch 4, flushing every 4: a crash after the fifth report,
    then a resume; every key appears once and every report equals
    run_corpus's.  Returns the resumed run's MP/s."""
    import json
    import tempfile

    from photohive_dsp_tpu_torch import runtime as native_rt
    from photohive_dsp_tpu_torch.models import batch
    from photohive_dsp_tpu_torch.utils import io as phio

    hh, ww = CORPUS_SHAPES[0]
    frames = [img for img in images.values() if img.shape[:2] == (hh, ww)]
    frames = frames[:TXT_FRAMES]
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, f"frame_{i}.txt") for i in range(len(frames))]
        for p, img in zip(paths, frames):
            if not native_rt.write_txt_u8(p, img):
                raise AssertionError("the native .txt writer did not build")
        real = phio.run_corpus

        def crashing(*args, **kw):
            for n, item in enumerate(real(*args, **kw)):
                yield item
                if n == 4:
                    raise RuntimeError("injected crash")

        out_dir = os.path.join(d, "out")
        phio.run_corpus = crashing
        try:
            phio.process_corpus(paths, out_dir, cfg, batch_size=4,
                                flush_every=4, device=DEVICE)
            raise AssertionError("the injected crash did not happen")
        except RuntimeError as e:
            if str(e) != "injected crash":
                raise
        finally:
            phio.run_corpus = real
        t0 = time.perf_counter()
        n = phio.process_corpus(paths, out_dir, cfg, batch_size=4,
                                flush_every=4, device=DEVICE)
        dt = time.perf_counter() - t0
        with open(os.path.join(out_dir, "reports.0.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        with open(os.path.join(out_dir, "watermark.0")) as f:
            marked = [line.strip() for line in f if line.strip()]
    # The fifth report was written but not watermarked before the crash:
    # the resume finds it in the shard, so it is neither redone nor marked.
    keys = [ln["key"] for ln in lines]
    if n != len(paths) - 5 or sorted(keys) != sorted(paths) \
            or len(set(marked)) != len(marked) or len(marked) != n + 4:
        raise AssertionError(f"process_corpus resume: {n} processed, keys "
                             f"{len(keys)} ({len(set(keys))} distinct), "
                             f"watermark {len(marked)}")
    want = dict(batch.run_corpus(zip(paths, frames), cfg, batch_size=4,
                                 device=DEVICE))
    for ln in lines:
        img = frames[paths.index(ln["key"])]
        same_report_dict(ln["report"], row_report(want[ln["key"]],
                                                  img).to_dict(),
                         f"process_corpus {os.path.basename(ln['key'])}")
    mp = n * hh * ww / 1e6
    log(f"  process_corpus {len(paths)} x {hh}x{ww} .txt: crash after 5 "
        f"reports (4 watermarked), resume processed {n} in {dt:.3f} s "
        f"({mp / dt:.1f} MP/s, .txt parse included); every key once, "
        f"reports equal run_corpus's")
    return mp / dt


def spatial_frames():
    """The spatial path's 4320x7680 uint8 frames, planar (3, H, W): noise
    (the palette's q=8 tier) and the hue wheel (q_full)."""
    rng = np.random.default_rng(SEED + 3)
    return {"noise": planar(noise_image(rng, SH, SW)),
            "hue wheel": planar(hue_wheel_image(rng, SH, SW))}


def spatial_kernels(group, frames, box_sets, cfg) -> dict:
    """The spatial path's kernels against their plain versions on the
    inputs its one rank hands them, built by parallel/spatial's own steps
    at 4320x7680: K9, K10 (q=8 and q_full) and K14 on the frame's flat HSV
    (33 MP, accumulators bit-equal), K5 on its luma with the zero halo and
    each box set at row offsets 0 and 3 (check_sharpness), K7+K8 on the
    rank's |X|^2 and bin ids
    (bit for bit, with the rank's maximum).  Returns max abs errors."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import polar_kernels as pol
    from photohive_dsp_tpu_torch.ops import quantize as qz
    from photohive_dsp_tpu_torch.ops import sharpness_kernels as sk
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_pgm
    from photohive_dsp_tpu_torch.ops.fixed_point import from_fixed
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
        assign = assignment(counts, SH * SW, cfg, octree)
        check_flat_kernels(hsv, assign, octree, cfg, f"spatial {name}")
        check_cwide(hsv, assign, octree, cfg, f"spatial {name} {SH}x{SW}")

        pgm = rgb_to_pgm(rgb[0], rgb[1], rgb[2])
        halo = spatial.halo_rows(pgm, group)[None].contiguous()
        rel5 = 0.0
        for label, (bx, vd) in box_sets.items():
            for off in (0, 3):
                e, r = check_sharpness(
                    pgm[None].contiguous(), sk.box_tensor(bx[None], vd[None],
                                                          dev),
                    f"spatial {name} {label} row_offset {off}", halo, off)
                err["K5"], rel5 = max(err["K5"], e), max(rel5, r)

        stats = spatial.rgb_stats(rgb, 0, SH, SW, group)
        dc = (stats[0] + stats[1] + stats[2]) / 3.0
        mag2 = spatial.power_spectrum(pgm, dc, tabs.wc, SH, SW, group)
        acc, mx = pol.polar_bin_sums_lognorm(mag2, ids, nb, fixed=True)
        acc0, mx0 = pol.polar_bin_sums_lognorm_plain(mag2, ids, nb,
                                                     fixed=True)
        got, want = from_fixed(acc), from_fixed(acc0)
        sync()
        if not (torch.equal(acc, acc0) and torch.equal(mx, mx0)):
            raise AssertionError(f"K7+K8 spatial {name}: rel err "
                                 f"{rel_err(got, want)}, max {mx} vs {mx0}")
        err["K7+K8"] = max(err["K7+K8"], float((got - want).abs().max()))
        log(f"  spatial {name} {SH}x{SW}, the rank's inputs: K9, K10 (q=8, "
            f"q_full), K14 accumulators equal plain; K5 ({', '.join(box_sets)}"
            f"; halo, row offsets 0 and 3) bit-identical twice, rel err "
            f"{rel5:.2e}; K7+K8 on {tuple(mag2.shape)} |X|^2 rel err "
            f"{rel_err(got, want):.2e}")
    return err


def phase_spatial(cfg):
    """build_spatial_report on one NCCL rank against the single-device
    full_report_batched on the card, at 4320x7680: the noise frame with
    main_boxes, then with a thin box, the hue-wheel frame with main_boxes;
    then one call under the cwide variant (K14) against the bf16 one; then
    the path's kernels against their plain versions on the rank's own
    inputs (spatial_kernels).  Returns the launch counts of the bf16
    report calls, the spatial call's warm wall time and the kernels' max
    abs errors."""
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
        os.environ["PHOTOHIVE_PALETTE_KERNEL"] = "cwide"
        try:
            _cuda.reset_launch_counts()
            cwide = fn(frames["noise"], *boxes)
            sync()
            cw_launches = dict(_cuda.LAUNCHES)
        finally:
            os.environ.pop("PHOTOHIVE_PALETTE_KERNEL", None)
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
    check_launches(cw_launches, ("cell_counts_hsv", "palette_sums_cwide"),
                   "spatial path under cwide")
    if cw_launches["palette_sums_flat_q8"] or \
            cw_launches["palette_sums_flat_qfull"]:
        raise AssertionError("spatial path under cwide launched K10")
    bf16 = {k: v[None] for k, v in out[0]._asdict().items()}
    cw = {k: v[None] for k, v in cwide._asdict().items()}
    compare_variants(data_fields(pt.ReportData(**cw), 0),
                     data_fields(pt.ReportData(**bf16), 0),
                     f"spatial {SH}x{SW} noise+3 boxes, cwide vs bf16")
    log(f"  spatial {SH}x{SW} noise+3 boxes under cwide (K14 launched "
        f"{cw_launches['palette_sums_cwide']}x, K10 0x): equals the bf16 "
        f"call")
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
    then K7+K8 with its max, gain and means), in turns torch, kernels,
    kernels, torch."""
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
            f"K6a+K6b {k[0]:.4f} ms + K7+K8 (sums, max, gain, means) "
            f"{k[1]:.4f} ms = "
            f"{sum(k):.4f} ms")


# K6a's other widths, (B, H, W): 1001 = 7 x 11 x 13 (the plan's radix-7,
# 11 and 13 passes), 1092x1001 (the blur shape of phase 3) and 14520 =
# 2^3 x 3 x 5 x 11^2 (its stage twiddles in device memory; 2904 rows, the
# 5:1 frame the report takes).
ROW_FFT_WIDTHS = [(4, 1001, 1001), (4, 1092, 1001), (4, 2904, 14520)]


def row_fft_width_times(smi: str) -> None:
    """K6a against torch.fft.rfft(dim=-1) at ROW_FFT_WIDTHS, in turns
    library, kernel, kernel, library, with each row's bound."""
    from photohive_dsp_tpu_torch.ops import fft_kernels as fk
    from photohive_dsp_tpu_torch.ops.fft_plan import FftPlan

    rng = np.random.default_rng(SEED + 9)
    for b, h, w in ROW_FFT_WIDTHS:
        x = torch.as_tensor(rng.standard_normal((b, h, w), dtype=np.float32),
                            device=DEVICE)
        plan = FftPlan.for_shape(h, w, DEVICE)
        l1, k1, k2, l2 = (graph_ms(lambda: torch.fft.rfft(x, dim=-1), 5),
                          graph_ms(lambda: fk.fft_rows(x, plan), 5),
                          graph_ms(lambda: fk.fft_rows(x, plan), 5),
                          graph_ms(lambda: torch.fft.rfft(x, dim=-1), 5))
        ms, by = bound(*row_fft_work(b, h, w))
        kern, lib = (k1 + k2) / 2, (l1 + l2) / 2
        log(f"  K6a B={b} {h}x{w}: kernel {kern:.4f} ms, torch.fft.rfft "
            f"{lib:.4f} ms ({lib / kern:.2f}x), bound {ms:.5f} ms ({by}) "
            f"({smi})")
        del x


# K6b's other heights, (B, H, W): the blur shapes of phase 3 besides
# 1080x1920 (2160: the tile of 2 lanes; 1092: radices 4, 3, 7, 13).
COL_FFT_HEIGHTS = [(1, 2160, 3840), (2, 1092, 1001)]


def col_fft_height_times(smi: str) -> None:
    """K6b against torch.fft.fft(dim=1) then abs().square() at
    COL_FFT_HEIGHTS, in turns library, kernel, kernel, library, with each
    row's bound."""
    from photohive_dsp_tpu_torch.ops import fft_kernels as fk

    for (b, h, w), (spec, plan) in zip(COL_FFT_HEIGHTS,
                                       col_fft_inputs().values()):
        zc = torch.view_as_complex(spec)
        l1, k1, k2, l2 = (
            graph_ms(lambda: torch.fft.fft(zc, dim=1).abs().square(), 5),
            graph_ms(lambda: fk.fft_cols(spec, plan), 5),
            graph_ms(lambda: fk.fft_cols(spec, plan), 5),
            graph_ms(lambda: torch.fft.fft(zc, dim=1).abs().square(), 5))
        ms, by = bound(*col_fft_work(b, h, w))
        kern, lib = (k1 + k2) / 2, (l1 + l2) / 2
        log(f"  K6b B={b} {h}x{w}: kernel {kern:.4f} ms, torch.fft.fft + "
            f"|.|^2 {lib:.4f} ms ({lib / kern:.2f}x), bound {ms:.5f} ms "
            f"({by}) ({smi})")


def col_fft_inputs() -> dict:
    """{"K6b HxW B=b": (spec, plan)} at COL_FFT_HEIGHTS: a half spectrum of
    noise from SEED (K6b's time does not depend on the values)."""
    from photohive_dsp_tpu_torch.ops.fft_plan import FftPlan

    rng = np.random.default_rng(SEED + 11)
    return {f"K6b {h}x{w} B={b}": (
        torch.as_tensor(rng.standard_normal((b, h, w // 2 + 1, 2),
                                            dtype=np.float32), device=DEVICE),
        FftPlan.for_shape(h, w, DEVICE)) for b, h, w in COL_FFT_HEIGHTS}


def col_fft_work(b: int, h: int, w: int):
    """(bytes, float32 ops) of K6b on (B, H, W//2+1) complex: the half
    spectrum in, |X|^2 out, the twiddles; 5 H log2 H a complex FFT of a
    column and 3 for its |X|^2."""
    half = w // 2 + 1
    return (b * h * half * 12 + h * 8,
            b * half * 5 * h * np.log2(max(h, 2)) + b * h * half * 3)


def row_fft_work(b: int, h: int, w: int):
    """(bytes, float32 ops) of K6a on (B, H, W): the rows in, the half
    spectrum out, the twiddles; 5 W log2 W a complex FFT of a row pair and
    the split of its two spectra."""
    half = w // 2 + 1
    return (b * h * w * 4 + b * h * half * 8 + w * 8,
            (b * h + 1) // 2 * 5 * w * np.log2(w) + b * h * half * 6)


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


# Launches of each plain version timed (3 by default): K14's builds a
# (256 K px, C) float64 distance matrix a chunk.
PLAIN_ITERS = {"K14": 1}


def flat_frame_times(cfg) -> dict:
    """The palette-sums kernel on a B=4 batch of one-colour frames against
    its plain version, in turns plain, kernel, kernel, plain, held bit for
    bit.  Returns {key: (kernel ms, plain ms, (bytes, float32 ops))}."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk

    inp = kernel_time_inputs(cfg)
    own = kernel_calls(cfg, inp)
    c = cfg.num_cells
    d = inp["flat"]
    x, hsv = d["u8"], d["hsv"]
    counts = pk.cell_counts_s_from_rgb(x, cfg)[0].long()
    b = x.shape[0]
    px = x.numel() // 3
    hsv_bytes = px * 12 + b * SENTINEL_TAIL * 4
    n_cand = int((counts * (d["q8"][0] < c).sum(dim=-1).long()).sum())
    n_allowed = int((counts * pk.unpack_allowed(d["cw"][0], c)
                     .sum(dim=-1)).sum())
    tab8 = (d["q8"][0].numel() + d["q8"][1].numel()) * 4
    cw_tab = (d["cw"][0].numel() + d["cw"][1].numel()) * 4
    rgb_ops = px * (OPS_CELL_PX + OPS_SLOT_PX)
    hsv_ops = px * (OPS_CELL_ID + OPS_SLOT_PX)
    # key: (plain version, (bytes, float32 ops)) of the timed call.
    flat = {
        "flat K3": (lambda: pk.palette_sums_by_k_rgb_q1_plain(
            x, *d["q1"], cfg), (x.numel() + b * c * 24, rgb_ops)),
        "flat K4q8": (lambda: pk.palette_sums_by_k_rgb_plain(
            x, *d["q8"], cfg), (x.numel() + tab8 + b * c * 16,
                                rgb_ops + n_cand * OPS_CANDIDATE)),
        "flat K10q8": (lambda: pk.palette_sums_by_k_plain(
            *hsv, *d["q8"], cfg), (hsv_bytes + tab8 + b * c * 32,
                                   hsv_ops + n_cand * OPS_CANDIDATE)),
        "flat K14": (lambda: pk.palette_sums_by_k_cwide_plain(
            *hsv, *d["cw"], cfg), (hsv_bytes + cw_tab + b * c * 32,
                                   hsv_ops + n_allowed * OPS_CANDIDATE)),
    }
    out = {}
    for key, (plain, work) in flat.items():
        kern = own[key]
        if not torch.equal(kern(), plain()):
            raise AssertionError(f"{key}: differs from its plain version")
        p1, k1, k2, p2 = (cuda_ms(plain, 1), graph_ms(kern), graph_ms(kern),
                          cuda_ms(plain, 1))
        out[key] = ((k1 + k2) / 2, (p1 + p2) / 2, work)
    return out


def phase_timing(images, cfg, kin, bkin, skin, fkin, main, smi):
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import _cuda
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
    single_ms = single_image_times(img, cfg, smi)
    stage_times(images, cfg, tables)
    row_fft_width_times(smi)
    col_fft_height_times(smi)
    sharpness_stage_times(images)

    c = cfg.num_cells
    _, q_full = qz.palette_widths(cfg)
    x, xf = kin["u8"], kin["f32"]
    assign = kin["assign"]
    cand = {"K4q8": pk.palette_candidate_table(assign, tables.octree, c, 8),
            "K4qfull": pk.palette_candidate_table(assign, tables.octree, c,
                                                  q_full)}
    c8, cf = cand["K4q8"], cand["K4qfull"]
    hsv, cw, cells = fkin["hsv"], fkin["cw_tabs"], fkin["ids"]
    cells_l = cells.long()
    ones_l = torch.ones_like(cells_l)
    acc15 = torch.zeros((cells.shape[0], c + 1), dtype=torch.int64,
                        device=DEVICE)
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
        "K7+K8": (lambda: polar_sums_max(flat, ids, nb),
                  lambda: pol.polar_bin_sums_lognorm_plain(flat, ids, nb)),
        "K5": (lambda: sk.sharpness_sums(skin["pgm"], skin["bt"]),
               lambda: sk.sharpness_sums_plain(skin["pgm"], skin["bt"])),
        "K9": (lambda: pk.cell_counts_from_hsv(*hsv, cfg),
               lambda: pk.cell_counts_from_hsv_plain(*hsv, cfg)),
        "K10q8": (lambda: pk.palette_sums_by_k(*hsv, *c8, cfg),
                  lambda: pk.palette_sums_by_k_plain(*hsv, *c8, cfg)),
        "K10qfull": (lambda: pk.palette_sums_by_k(*hsv, *cf, cfg),
                     lambda: pk.palette_sums_by_k_plain(*hsv, *cf, cfg)),
        "K11": (lambda: pk.cell_counts_s_from_rgb(xf, cfg),
                lambda: pk.cell_counts_s_from_rgb_plain(xf, cfg)),
        "K12": (lambda: pk.palette_sums_by_k_rgb_q1(xf, kin["slot"],
                                                    kin["off"], cfg),
                lambda: pk.palette_sums_by_k_rgb_q1_plain(
                    xf, kin["slot"], kin["off"], cfg)),
        "K13q8": (lambda: pk.palette_sums_by_k_rgb(xf, *c8, cfg),
                  lambda: pk.palette_sums_by_k_rgb_plain(xf, *c8, cfg)),
        "K13qfull": (lambda: pk.palette_sums_by_k_rgb(xf, *cf, cfg),
                     lambda: pk.palette_sums_by_k_rgb_plain(xf, *cf, cfg)),
        "K14": (lambda: pk.palette_sums_by_k_cwide(*hsv, *cw, cfg),
                lambda: pk.palette_sums_by_k_cwide_plain(*hsv, *cw, cfg)),
        "K15": (lambda: pk.cell_counts_batched(cells, c),
                lambda: pk.cell_counts_batched_plain(cells, c)),
    }
    # One PyTorch call computing the same function, where there is one.
    library = {
        "K6a": lambda: torch.fft.rfft(fx, dim=-1),
        "K6b": lambda: torch.fft.fft(zc, dim=1).abs().square(),
        "K7+K8": lambda: acc.index_add_(1, ids_l, gated),
        "K15": lambda: acc15.scatter_add_(1, cells_l, ones_l),
    }
    times = {}
    for key, (kern, plain) in pairs.items():
        # plain, library, kernel, kernel, library, plain; the mean of each
        lib = library.get(key)
        p1 = cuda_ms(plain, PLAIN_ITERS.get(key, 3))
        l1 = graph_ms(lib) if lib else None
        k1 = graph_ms(kern)
        k2 = graph_ms(kern)
        l2 = graph_ms(lib) if lib else None
        p2 = cuda_ms(plain, PLAIN_ITERS.get(key, 3))
        times[key] = ((k1 + k2) / 2, (p1 + p2) / 2,
                      (l1 + l2) / 2 if lib else None)
        log(f"  {key}: kernel {times[key][0]:.4f} ms, plain "
            f"{times[key][1]:.4f} ms, library "
            f"{'%.4f ms' % times[key][2] if lib else 'none'}")
    k6 = times["K6a"][0] + times["K6b"][0]
    floor = graph_ms(lambda: _cuda.launch("ph_empty_kernel", x))
    times["launch floor"] = (floor, None, None)
    log(f"  launch floor, an empty kernel of one warp: {floor:.4f} ms "
        f"(K2 {times['K2'][0]:.4f} ms)")
    rfft2 = graph_ms(lambda: torch.fft.rfft2(fx).abs().square())
    times["K6"] = (k6, None, rfft2)
    log(f"  K6a+K6b {k6:.4f} ms vs torch.fft.rfft2 + |.|^2 {rfft2:.4f} ms "
        f"(B={fx.shape[0]} f32 {H}x{W})")
    flat_rows = flat_frame_times(cfg)

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
    xf_bytes = xf.numel() * xf.element_size()
    for key in ("K1", "K3"):
        work[F32_IDS[key]] = (work[key][0] - x_bytes + xf_bytes,
                              work[key][1])
    for key, (cand_t, centres) in cand.items():
        per_cell = (cand_t < c).sum(dim=-1).long()
        n_cand = int((counts * per_cell).sum())
        work[key] = (x_bytes + cand_t.numel() * 4 + centres.numel() * 4
                     + b * c * 16,
                     px * (OPS_CELL_PX + OPS_SLOT_PX)
                     + n_cand * OPS_CANDIDATE)
        work[F32_IDS[key]] = (work[key][0] - x_bytes + xf_bytes,
                              work[key][1])
    fb, fh, fw = fx.shape
    half = fw // 2 + 1
    work["K6a"] = row_fft_work(fb, fh, fw)
    work["K6b"] = col_fft_work(fb, fh, fw)
    # K6 as one function, |rfft2|^2: the luma read once and the half
    # spectrum written once; the intermediate K6a writes and K6b reads
    # back is the two-pass design's cost, not the function's.
    work["K6"] = (fx.numel() * 4 + fb * fh * half * 4,
                  work["K6a"][1] + work["K6b"][1])
    n_gated = int((flat >= 1.0).sum())
    # K7+K8: the spectrum and ids in, the sums and maxima out; a gate and
    # a max compare a pixel, logf, its scaling and add a gated pixel.
    work["K7+K8"] = (flat.numel() * 4 + ids.numel() * 4 + fb * nb * 4
                     + fb * 4, 2 * flat.numel() + 3 * n_gated)
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
    # K14: the flat HSV, the bitmask and the centres in, the accumulator
    # out; every allowed parent of each pixel's cell is one candidate.
    n_allowed = int((counts * assign.allowed.sum(dim=-1)).sum())
    work["K14"] = (hsv_bytes + cw[0].numel() * 4 + cw[1].numel() * 4
                   + b * c * 32,
                   real_px * (OPS_CELL_ID + OPS_SLOT_PX)
                   + n_allowed * OPS_CANDIDATE)
    # K15: the ids in (one range check each), the int32 counts out.
    work["K15"] = (cells.numel() * 4 + b * c * 4, cells.numel())
    bounds = {k: bound(*v) for k, v in work.items()}
    for k, (ms, by) in bounds.items():
        log(f"  {k}: bound {ms:.5f} ms ({by}; {work[k][0] / 1e6:.2f} MB, "
            f"{work[k][1] / 1e9:.4f} G float32 ops)")
    for key, (kern_ms, plain_ms, work_flat) in flat_rows.items():
        ms, by = bound(*work_flat)
        log(f"  {key} (one-colour B=4 {H}x{W}): kernel {kern_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {ms:.5f} ms ({by}), equal to "
            f"plain bit for bit ({smi})")
    return times, bounds, lat_ms, mps, single_ms


def single_image_times(img, cfg, smi: str) -> dict:
    """Warm full_report (jitted_full_report's fn) on a device-resident
    float32 1080x1920 frame, full_report_batched at B=1 on the same frame
    and get_report on it as an (H, W, 3) uint8 host array, no boxes: 20
    calls of each between CUDA events, in turns full_report, batched,
    get_report, get_report, batched, full_report.  Returns the median ms of
    each over its 40 calls."""
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.models import pipeline

    fn, tables = pipeline.jitted_full_report(H, W, cfg)
    x = unit_f32(img)
    bx, vd = pipeline.empty_boxes()
    calls = {"full_report": lambda: fn(x, bx, vd, tables),
             "full_report_batched B=1": lambda: pt.full_report_batched(
                 x[None], bx[None], vd[None], tables, cfg),
             "get_report u8": lambda: pt.get_report(img, device=DEVICE)}
    runs = {k: [] for k in calls}
    for key in list(calls) + list(calls)[::-1]:
        runs[key].append(event_times(calls[key]))
    out = {}
    for key, (a, b) in runs.items():
        every = a + b
        out[key] = float(np.median(every))
        frame = "u8 host" if key == "get_report u8" else "f32 on the card"
        log(f"  {key} {H}x{W} {frame}, warm, 2 x 20 calls between CUDA "
            f"events in turns: median "
            f"{out[key]:.4f} ms (min {min(every):.4f}, max {max(every):.4f}; "
            f"runs {np.median(a):.4f} / {np.median(b):.4f}) ({smi})")
    return out


def kernel_time_inputs(cfg):
    """The inputs phase 7 times the kernels on, made from SEED alone with
    the package on sys.path (this checkout's or another's): B=4 1080x1920
    uint8 frames (noise, structured, hue wheel, noise), their float32
    planes, flat HSV with a sentinel tail and its cell ids, the palette
    tables of the batch and its saliencies (K2 at C=112), saliencies of
    4 images at C=2164 (ties inside the margin), the luma with
    main_boxes (K5), the luma without its mean, its half spectrum (K6a's
    output), its |X|^2 and polar tables, the half spectra of
    col_fft_inputs, and a batch of 4 one-colour frames with its tables."""
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import quantize as qz
    from photohive_dsp_tpu_torch.ops import sharpness_kernels as sk
    from photohive_dsp_tpu_torch.ops.blur import PolarTables
    from photohive_dsp_tpu_torch.ops.fft_kernels import fft_rows, magnitude2
    from photohive_dsp_tpu_torch.ops.fft_plan import FftPlan

    rng = np.random.default_rng(SEED)
    images = [noise_image(rng, H, W), structured_image(rng, H, W),
              hue_wheel_image(rng, H, W), noise_image(rng, H, W)]
    c = cfg.num_cells
    _, q_full = qz.palette_widths(cfg)
    octree = qz.OctreeTables.for_config(cfg, DEVICE)
    out = {"x_dc": luma_dc(images), "plan": FftPlan.for_shape(H, W, DEVICE),
           "polar": PolarTables.for_shape(H, W, cfg, DEVICE)}
    out["spec"] = fft_rows(out["x_dc"], out["plan"])
    out["mag2"] = magnitude2(out["x_dc"], out["plan"]).reshape(4, -1)
    out["cols"] = col_fft_inputs()
    boxes, valid = pt.set_bounding_boxes(main_boxes(H, W))
    out["pgm"] = luma(images)
    out["bt"] = sk.box_tensor(np.stack([boxes] * 4), np.stack([valid] * 4),
                              DEVICE)
    out["sal2164"] = torch.as_tensor(
        np.round(rng.random((4, 2164)) * 30) + rng.random((4, 2164)) * 0.6,
        dtype=torch.float32, device=DEVICE)
    for name, frames in (("", np.stack([planar(im) for im in images])),
                         ("flat", one_colour_frames(4, H, W))):
        x = torch.as_tensor(frames, device=DEVICE)
        counts, _ = pk.cell_counts_s_from_rgb(x, cfg)
        assign = assignment(counts, H * W, cfg, octree)
        hsv = flat_hsv(x, SENTINEL_TAIL)
        out[name] = dict(
            u8=x, f32=(x.float() / 255.0).contiguous(), hsv=hsv,
            sal=qz.saliency_f32(counts, octree.s_v_f32, cfg),
            ids=cell_ids(hsv, cfg),
            q1=pk.palette_offset_table(assign, octree, c),
            q8=pk.palette_candidate_table(assign, octree, c, 8),
            qfull=pk.palette_candidate_table(assign, octree, c, q_full),
            cw=pk.cwide_tables(assign, octree))
    return out


def polar_sums_max(mag2, ids, nb):
    """K7+K8's sums and each image's maximum: one launch here, the launch
    and an ``amax`` in a checkout whose kernel returns the sums alone."""
    from photohive_dsp_tpu_torch.ops import polar_kernels as pol

    out = pol.polar_bin_sums_lognorm(mag2, ids, nb)
    return out if isinstance(out, tuple) else (out, mag2.amax(dim=1))


def kernel_calls(cfg, inp):
    """{key: call} of the palette kernels, K2 (also at C=2164), K5, K6a,
    K6b (also at COL_FFT_HEIGHTS), K7+K8 (sums and maxima) and the blur
    tail after the FFT (blur.lognorm_bin_means) on kernel_time_inputs;
    "flat ..." keys run the one-colour batch."""
    from photohive_dsp_tpu_torch.ops import fft_kernels as fk
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import sharpness_kernels as sk
    from photohive_dsp_tpu_torch.ops.blur import lognorm_bin_means
    from photohive_dsp_tpu_torch.ops.margin_sort import margin_sort

    c = cfg.num_cells
    a, r = cfg.angle_partitions, cfg.radius_partitions
    mag2, polar = inp["mag2"], inp["polar"]
    calls = {"K6a": lambda: fk.fft_rows(inp["x_dc"], inp["plan"]),
             "K6b": lambda: fk.fft_cols(inp["spec"], inp["plan"]),
             "K7+K8": lambda: polar_sums_max(mag2, polar.bin_ids, a * r),
             "blur tail": lambda: lognorm_bin_means(mag2, polar, a, r),
             "K2": lambda: margin_sort(inp[""]["sal"]),
             "K2 C=2164": lambda: margin_sort(inp["sal2164"]),
             "K5": lambda: sk.sharpness_sums(inp["pgm"], inp["bt"])}
    for key, (spec, plan) in inp["cols"].items():
        calls[key] = lambda s=spec, p=plan: fk.fft_cols(s, p)
    for pre, d in (("", inp[""]), ("flat ", inp["flat"])):
        x, xf, hsv = d["u8"], d["f32"], d["hsv"]
        calls.update({
            pre + "K1": lambda x=x: pk.cell_counts_s_from_rgb(x, cfg),
            pre + "K3": lambda x=x, t=d["q1"]: pk.palette_sums_by_k_rgb_q1(
                x, *t, cfg),
            pre + "K4q8": lambda x=x, t=d["q8"]: pk.palette_sums_by_k_rgb(
                x, *t, cfg),
            pre + "K4qfull": lambda x=x, t=d["qfull"]:
                pk.palette_sums_by_k_rgb(x, *t, cfg),
            pre + "K9": lambda h=hsv: pk.cell_counts_from_hsv(*h, cfg),
            pre + "K10q8": lambda h=hsv, t=d["q8"]: pk.palette_sums_by_k(
                *h, *t, cfg),
            pre + "K10qfull": lambda h=hsv, t=d["qfull"]:
                pk.palette_sums_by_k(*h, *t, cfg),
            pre + "K11": lambda x=xf: pk.cell_counts_s_from_rgb(x, cfg),
            pre + "K12": lambda x=xf, t=d["q1"]: pk.palette_sums_by_k_rgb_q1(
                x, *t, cfg),
            pre + "K13q8": lambda x=xf, t=d["q8"]: pk.palette_sums_by_k_rgb(
                x, *t, cfg),
            pre + "K13qfull": lambda x=xf, t=d["qfull"]:
                pk.palette_sums_by_k_rgb(x, *t, cfg),
            pre + "K14": lambda h=hsv, t=d["cw"]: pk.palette_sums_by_k_cwide(
                *h, *t, cfg),
            pre + "K15": lambda i=d["ids"]: pk.cell_counts_batched(i, c),
        })
    return calls


def kernel_breakdown(fn, iters: int = 20) -> dict:
    """{kernel name: device ms a call of fn spends in it}, from
    torch.profiler's CUDA trace (CUPTI kernel durations) of ``iters`` eager
    calls; empty where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us and str(ev.device_type).endswith("CUDA"):
            out[ev.key[:80]] = us / iters / 1e3
    return out


def kernel_times(cfg, keys=None) -> dict:
    """Mean device ms (graph_ms) of two runs of 20 launches of each of
    kernel_calls, in the package on sys.path; "K5 kernels": K5's time in
    each CUDA kernel it launches (kernel_breakdown); "report B=8": the
    ms of one full_report_batched call on 8 device-resident frames (the
    four frames twice) with main_boxes, host included (cuda_ms, 10
    calls); "get_report": the median ms of 20 warm get_report calls on
    the first (noise) frame from the host.  With ``keys``, the
    kernel_calls of those keys alone."""
    import photohive_dsp_tpu_torch as pt

    inp = kernel_time_inputs(cfg)
    calls = kernel_calls(cfg, inp)
    if keys:
        return {k: (graph_ms(calls[k]) + graph_ms(calls[k])) / 2
                for k in keys}
    out = {k: (graph_ms(f) + graph_ms(f)) / 2 for k, f in calls.items()}
    out["K5 kernels"] = kernel_breakdown(calls["K5"])
    frames = torch.cat([inp[""]["u8"]] * 2)
    boxes, valid = pt.set_bounding_boxes(main_boxes(H, W))
    bx, vd = np.stack([boxes] * 8), np.stack([valid] * 8)
    tables = pt.ReportTables.build(H, W, cfg, DEVICE)
    out["report B=8"] = cuda_ms(
        lambda: pt.full_report_batched(frames, bx, vd, tables, cfg), 10)
    img = np.ascontiguousarray(np.moveaxis(
        inp[""]["u8"][0].cpu().numpy(), 0, -1))
    pt.get_report(img, device=DEVICE)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        pt.get_report(img, device=DEVICE)
        lat.append(1e3 * (time.perf_counter() - t0))
    out["get_report"] = float(np.median(lat))
    return out


def parent_kernel_times(parent: str) -> dict:
    """kernel_times of the checkout at ``parent`` (its own package, built
    from its own sources), in a child process."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--kernel-times", os.path.abspath(parent)],
                         capture_output=True, text=True, check=True,
                         timeout=600)
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("KERNEL_TIMES ")][-1]
    return json.loads(line[len("KERNEL_TIMES "):])


def compare_parent(parent: str, cfg, smi: str) -> None:
    """kernel_times of the checkout at ``parent`` against this one's on
    the same inputs and card, in turns parent, this, this, parent; each
    run's means."""
    runs = [parent_kernel_times(parent), kernel_times(cfg),
            kernel_times(cfg), parent_kernel_times(parent)]
    log(f"  kernel ms, parent {parent} against this checkout, in turns "
        f"parent, this, this, parent ({smi}):")
    for key in runs[1]:
        if isinstance(runs[1][key], dict):
            for i, run in enumerate(runs):
                log(f"    {key} ({'parent' if i in (0, 3) else 'this'}): "
                    + (", ".join(f"{k} {v:.4f}" for k, v in run[key].items())
                       or "no device time in the trace"))
            continue
        p = (runs[0][key] + runs[3][key]) / 2
        t = (runs[1][key] + runs[2][key]) / 2
        log(f"    {key}: parent {p:.4f} ({runs[0][key]:.4f}/"
            f"{runs[3][key]:.4f}), this {t:.4f} ({runs[1][key]:.4f}/"
            f"{runs[2][key]:.4f}), {p / t:.2f}x")


# ---------------------------------------------------------- serving ---

SERVE_B = 8
SERVE_DYNAMIC_BS = (1, 3, 8)
SERVE_TIMING_BATCH = "noise, 3 boxes"


def serving_batches():
    """The serving phase's B=8 uint8 batches, made from SEED: each frame
    kind (structured: the q=1 tier; noise: q=8; hue wheel: q_full) under
    each box set (none; main_boxes: K5; main_boxes with thin_box: the
    masked route), and one mixed batch, kinds and box sets by image.
    [(label, (8, H, W, 3) uint8, (8, 10, 4) int32 boxes, (8, 10) valid)],
    the same in the child process that runs the artifact."""
    import photohive_dsp_tpu_torch as pt

    rng = np.random.default_rng(SEED + 7)
    kinds = {"structured": structured_image(rng), "noise": noise_image(rng),
             "hue wheel": hue_wheel_image(rng)}
    sets = {"no boxes": pt.set_bounding_boxes([]),
            "3 boxes": pt.set_bounding_boxes(main_boxes(H, W)),
            "thin box": pt.set_bounding_boxes(main_boxes(H, W)[:2]
                                              + [thin_box(H, W)])}
    out = [(f"{kind}, {name}", np.stack([img] * SERVE_B),
            np.stack([bx] * SERVE_B), np.stack([vd] * SERVE_B))
           for kind, img in kinds.items()
           for name, (bx, vd) in sets.items()]
    imgs, bsets = list(kinds.values()), list(sets.values())
    order = [(i % 3, (i // 3) % 3) for i in range(SERVE_B)]
    out.append(("mixed", np.stack([imgs[k] for k, _ in order]),
                np.stack([bsets[s][0] for _, s in order]),
                np.stack([bsets[s][1] for _, s in order])))
    return out


def serve_args(u8, bx, vd):
    """An artifact's arguments: the frames on the card, the boxes and
    their validity as CPU tensors (serving.py's calling convention)."""
    return (torch.as_tensor(u8, device=DEVICE), torch.from_numpy(bx),
            torch.from_numpy(vd))


def serve_child(blob_path: str, out_path: str) -> int:
    """Child of phase_serving, a fresh process that imports the port
    alone: loads the artifact, runs it on serving_batches with the launch
    counts zeroed just before and read just after, saves the reports and
    the counts."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from photohive_dsp_tpu_torch.ops import _cuda
    from photohive_dsp_tpu_torch.serving import load_report

    with open(blob_path, "rb") as f:
        fn = load_report(f.read())
    batches = [(label, serve_args(u8, bx, vd))
               for label, u8, bx, vd in serving_batches()]
    _cuda.reset_launch_counts()
    outs = [[t.cpu() for t in fn(*args)] for _, args in batches]
    sync()
    launches = dict(_cuda.LAUNCHES)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "photohive_dsp_tpu"))
    if bad:
        raise AssertionError(f"the serving child imported {bad}")
    torch.save({"outs": outs, "launches": launches}, out_path)
    return 0


def same_data(got, want, label: str) -> None:
    """Two ReportData, field by field, bit for bit."""
    for name, a, b in zip(want._fields, got, want):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{label}: {name} differs from the live "
                                 f"full_report_batched")


def verify_rows(data, vd, cfg, label: str) -> None:
    """debug.verify_report on every image of a batched ReportData."""
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.utils import debug

    for i in range(len(vd)):
        row = pt.ReportData(*(t[i] for t in data))
        try:
            debug.verify_report(pt.Report(row, H, W, int(vd[i].sum()), cfg))
        except AssertionError as e:
            raise AssertionError(f"{label}, image {i}: {e}") from e


def event_times(fn, n: int = 20) -> list:
    """ms of each of ``n`` warm calls of fn, each between CUDA events (host
    included: the call's one device read ends with the stream idle)."""
    fn()
    sync()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median_event_ms(fn, n: int = 20) -> float:
    """Median of ``n`` calls of fn, each between CUDA events."""
    return float(np.median(event_times(fn, n)))


def dispatch_times() -> dict:
    """Host us a call of K2 (B=4, C=112) and K6a (B=4 1080x1920): through
    the registered operator (torch.library.custom_op, ops/library.py);
    through a twin registered with the low-level torch.library.Library API
    on the same launch; and that launch called directly.  Min over 5 runs
    of 400 calls each, the three in turns; the launches are not counted.
    The yardstick for what the operators cost the live path."""
    import ctypes

    from photohive_dsp_tpu_torch.ops import _cuda
    from photohive_dsp_tpu_torch.ops.fft_plan import FftPlan
    from photohive_dsp_tpu_torch.ops.margin_sort import sort_layout

    def sort_launch(sal):
        b, c = sal.shape
        out = torch.empty((b, c), dtype=torch.int32, device=sal.device)
        _cuda.launch("ph_margin_sort", sal, _cuda.ptr(sal), b, c,
                     *sort_layout(c), _cuda.ptr(out))
        return out

    def rows_launch(pgm, radices, tw, stw):
        b, h, w = pgm.shape
        spec = torch.empty((b, h, w // 2 + 1, 2), dtype=torch.float32,
                           device=pgm.device)
        _cuda.launch("ph_fft_rows", pgm, _cuda.ptr(pgm), b * h,
                     ctypes.byref(_cuda.FftStages.for_plan(w, radices)),
                     _cuda.ptr(tw), _cuda.ptr(stw), _cuda.ptr(spec))
        return spec

    lib = torch.library.Library("photohive_twin", "DEF")
    lib.define("margin_sort(Tensor sal) -> Tensor")
    lib.impl("margin_sort", sort_launch, "CUDA")
    lib.define("fft_rows(Tensor pgm, int[] radices, Tensor tw, Tensor stw) "
               "-> Tensor")
    lib.impl("fft_rows", rows_launch, "CUDA")
    sal = torch.rand((4, 112), device=DEVICE) * 1000
    pgm = torch.rand((4, H, W), device=DEVICE)
    lp = FftPlan.for_shape(H, W, DEVICE).rows
    rows = (pgm, list(lp.radices), lp.twiddles, lp.stage_twiddles)
    calls = {"K2 operator": lambda: torch.ops.photohive.margin_sort(sal),
             "K2 Library twin": lambda: torch.ops.photohive_twin.margin_sort(
                 sal),
             "K2 launch": lambda: sort_launch(sal),
             "K6a operator": lambda: torch.ops.photohive.fft_rows(*rows),
             "K6a Library twin": lambda: torch.ops.photohive_twin.fft_rows(
                 *rows),
             "K6a launch": lambda: rows_launch(*rows)}
    best = {k: float("inf") for k in calls}
    for f in calls.values():
        f()
    for _ in range(5):
        for k, f in calls.items():
            sync()
            t0 = time.perf_counter()
            for _ in range(400):
                f()
            best[k] = min(best[k], (time.perf_counter() - t0) / 400 * 1e6)
    sync()
    return best


def phase_serving(cfg, smi: str) -> dict:
    """serving.export_report at 1080x1920, B=8 pinned and a dynamic batch;
    the pinned artifact saved, loaded in a fresh process and run on
    serving_batches, each report bit-equal to the live full_report_batched
    and through debug.verify_report, with K1-K8 counted inside the
    artifact; the dynamic artifact at B=1, 3 and 8, the same; then the
    artifact's and the live call's time in turns, and stage_timings at
    B=8.  Returns the launch counts and the times."""
    import tempfile

    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.serving import export_report, load_report
    from photohive_dsp_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    blob = export_report(H, W, cfg, batch_size=SERVE_B, device=DEVICE)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dyn_blob = export_report(H, W, cfg, batch_size="dynamic", device=DEVICE)
    dyn_export_s = time.perf_counter() - t0
    log(f"  export_report {H}x{W}: B={SERVE_B} {export_s:.1f} s "
        f"({len(blob) / 1e6:.1f} MB), dynamic batch {dyn_export_s:.1f} s "
        f"({len(dyn_blob) / 1e6:.1f} MB)")

    with tempfile.TemporaryDirectory() as tmp:
        blob_path = os.path.join(tmp, "report.pt2")
        out_path = os.path.join(tmp, "reports.pt")
        with open(blob_path, "wb") as f:
            f.write(blob)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--serve-child", blob_path, out_path], check=True,
                       timeout=900)
        child_s = time.perf_counter() - t0
        child = torch.load(out_path)
    launches = child["launches"]
    log(f"  launch counts in the artifact's run (fresh process, "
        f"{child_s:.1f} s with its start): {launches}")
    check_launches(launches, MAIN_COUNTERS, "serving path")

    tables = pt.ReportTables.build(H, W, cfg, DEVICE)
    batches = serving_batches()

    def live(args):
        """The live path on the artifact's arguments, the frames made
        planar as BatchRunner.run_u8 (and the artifact) makes them."""
        u8, bx, vd = args
        return pt.full_report_batched(u8.permute(0, 3, 1, 2).contiguous(),
                                      bx, vd, tables, cfg)

    for (label, u8, bx, vd), got in zip(batches, child["outs"]):
        args = serve_args(u8, bx, vd)
        same_data(pt.ReportData(*got), live(args), f"artifact, {label}")
        verify_rows(got, vd, cfg, f"artifact, {label}")
    log(f"  the loaded B={SERVE_B} artifact equals the live path bit for bit "
        f"on {len(batches)} batches (" + "; ".join(b[0] for b in batches)
        + "), every report through debug.verify_report")
    dyn = load_report(dyn_blob)
    _, u8, bx, vd = batches[-1]
    for b in SERVE_DYNAMIC_BS:
        args = serve_args(u8[:b], bx[:b], vd[:b])
        got = dyn(*args)
        same_data(got, live(args), f"dynamic artifact B={b}")
        verify_rows(got, vd[:b], cfg, f"dynamic artifact B={b}")
    log(f"  the dynamic artifact equals the live path bit for bit at B="
        + ", ".join(map(str, SERVE_DYNAMIC_BS)) + " (the mixed batch)")

    fn = load_report(blob)
    _, u8, bx, vd = next(b for b in batches if b[0] == SERVE_TIMING_BATCH)
    args = serve_args(u8, bx, vd)
    runs = [median_event_ms(lambda: fn(*args)),
            median_event_ms(lambda: live(args)),
            median_event_ms(lambda: live(args)),
            median_event_ms(lambda: fn(*args))]
    art_ms, live_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    log(f"  B={SERVE_B} {H}x{W} u8 ({SERVE_TIMING_BATCH}), median of 20 "
        f"calls between CUDA events, in turns artifact, live, live, "
        f"artifact: " + " / ".join(f"{t:.4f}" for t in runs)
        + f" ms; artifact {art_ms:.4f} ms, live {live_ms:.4f} ms ({smi})")
    disp = dispatch_times()
    log("  host us a call (min of 5 runs of 400): " + "; ".join(
        f"{k} {v:.2f}" for k, v in disp.items()) + f" ({smi})")
    stages = profiling.stage_timings(H, W, SERVE_B, cfg, device=DEVICE)
    log(f"  stage_timings B={SERVE_B} {H}x{W} (ms a call, CUDA events, "
        f"5 warm calls): " + "; ".join(f"{k} {1e3 * v:.4f}"
                                       for k, v in stages.items()))
    return dict(launches=launches, blob=blob, export_s=export_s,
                dynamic_export_s=dyn_export_s, artifact_ms=art_ms,
                live_ms=live_ms, stages_ms={k: 1e3 * v
                                            for k, v in stages.items()})


# ------------------------------------------------------------- mesh ---

MESH_DP_B = 8             # the dp route's batch of phase 4's frames
MESH_DPS_B = 2            # the dp x spatial batch of phase 6's frames
MESH_CORPUS_BATCH = 8
# run_corpus(mesh=...)'s frames: two 2160x3840 frames (8.3 MP, at the
# row-sharded threshold: they shard when the mesh has a spatial axis, and
# take the dp route at spatial=1) and 16 of config #3's shapes.
MESH_CORPUS_SHAPES = [(2160, 3840)] * 2 + [
    CORPUS_SHAPES[i % len(CORPUS_SHAPES)] for i in range(16)]
# The kernels the mesh path must launch: the dp route's on its 8 frames
# (whose tie structure needs the q_full tier) and the dp x spatial route's
# on its noise and hue-wheel frames (K10 at the q_full tier).
MESH_COUNTERS = ("cell_counts_s", "margin_sort", "palette_sums_qfull",
                 "sharpness_sums", "fft_rows", "fft_cols", "polar_bins",
                 "cell_counts_hsv", "palette_sums_flat_qfull")


def mesh_flat_kernels(frames, cfg) -> None:
    """The deferred palette pass's kernels against their plain versions
    on the batched (2, P) flat HSV it hands them: each frame's rows made
    flat HSV by parallel/spatial's own steps, with a SENTINEL_TAIL of
    hue-sentinel pixels after each row (the padded rows' marker: one rank
    pads none), K9, K10 (q=8 and q_full) and K14 bit-equal, the tail
    changing nothing."""
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import quantize as qz
    from photohive_dsp_tpu_torch.parallel import spatial

    dev = torch.device(DEVICE)
    octree = qz.OctreeTables.for_config(cfg, dev)
    rows = [spatial.masked_hsv(spatial.own_rows(torch.as_tensor(f), 0, SH,
                                                dev), 0, SH)
            for f in frames]
    real = [torch.cat(c).contiguous() for c in zip(*rows)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tail = torch.rand((3, len(frames), SENTINEL_TAIL), generator=gen,
                      device=dev)
    tail[0] = -1.0
    hsv = [torch.cat([c, t], dim=1).contiguous() for c, t in zip(real, tail)]
    counts, _ = pk.counts_s_from_fixed(pk.cell_counts_from_hsv(*real, cfg))
    assign = assignment(counts, SH * SW, cfg, octree)
    label = f"mesh {len(frames)}x{SH}x{SW} flat HSV"
    check_flat_kernels(hsv, assign, octree, cfg, label, real)
    check_cwide(hsv, assign, octree, cfg, label, real)


def phase_mesh(cfg, images, blob: bytes, smi: str) -> dict:
    """The data-parallel and dp x spatial layer on one NCCL rank
    (initialize_distributed with one process, make_mesh(1, 1)): the dp
    route (data_parallel_report_u8 on phase 4's 8 device-resident frames
    with main_boxes) bit-equal to full_report_batched; build_dp_spatial_report
    at B=2 on phase 6's frames with (a) main_boxes, each image bit-equal to
    build_spatial_report of it, (b) a thin box in image 0 alone, image 0
    bit-equal to build_spatial_report of it and image 1 to (a) but its
    sharpness (the masked route, within 1e-4), (c) under cwide, K14 and no
    K10, equal to (a) as the variants are; run_corpus(mesh=...) over
    MESH_CORPUS_SHAPES equal to the mesh-less run; phase 8's artifact
    through load_report(mesh=...) bit-equal to full_report_batched; the
    launch counts of (dp, a, b, the corpus, the artifact); K9, K10 and K14
    on the deferred pass's batched flat HSV (mesh_flat_kernels); the warm
    dp x spatial call (median of 3) and the dp call in turns with
    full_report_batched.  Returns the launch counts and the times."""
    import torch.distributed as dist

    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.models import batch
    from photohive_dsp_tpu_torch.ops import _cuda
    from photohive_dsp_tpu_torch.parallel import mesh, sharding, spatial
    from photohive_dsp_tpu_torch.serving import load_report

    t0 = time.perf_counter()
    u8 = torch.as_tensor(np.stack([images[i % len(images)]
                                   for i in range(MESH_DP_B)]), device=DEVICE)
    bx, vd = pt.set_bounding_boxes(main_boxes(H, W))
    bx, vd = np.stack([bx] * MESH_DP_B), np.stack([vd] * MESH_DP_B)
    frames = list(spatial_frames().values())
    rgb2 = np.stack(frames)
    three = pt.set_bounding_boxes(main_boxes(SH, SW))
    thin = pt.set_bounding_boxes(main_boxes(SH, SW) + [thin_box(SH, SW)])
    box_sets = {"a": (np.stack([three[0]] * 2), np.stack([three[1]] * 2)),
                "b": (np.stack([thin[0], three[0]]),
                      np.stack([thin[1], three[1]]))}
    rng = np.random.default_rng(SEED + 9)
    corpus = [(i, noise_image(rng, *hw))
              for i, hw in enumerate(MESH_CORPUS_SHAPES)]
    tables = pt.ReportTables.build(H, W, cfg, DEVICE)

    def live():
        return pt.full_report_batched(u8.permute(0, 3, 1, 2).contiguous(),
                                      bx, vd, tables, cfg)

    mesh.initialize_distributed(num_processes=1, device=DEVICE)
    try:
        m = mesh.make_mesh(data=1, spatial=1)
        # A one-rank NCCL group makes its communicator at its first
        # collective: warm each group before anything is timed.
        for g in (m.spatial_group, m.data_group):
            dist.all_reduce(torch.zeros(1, device=DEVICE), group=g)
        dp_fn, dp_tables = sharding.data_parallel_report_u8(
            H, W, cfg, sharding.flat_data_mesh(m), DEVICE)
        dps_fn = spatial.build_dp_spatial_report(m, MESH_DPS_B, SH, SW, cfg,
                                                 DEVICE)
        single = spatial.build_spatial_report(m.spatial_group, SH, SW, cfg,
                                              DEVICE)
        art_fn = load_report(blob, mesh=m)
        log(f"  inputs, groups and artifact: "
            f"{time.perf_counter() - t0:.1f} s")
        _cuda.reset_launch_counts()
        dp = dp_fn(u8, bx, vd, dp_tables)
        dps = {k: dps_fn(rgb2, *b) for k, b in box_sets.items()}
        mesh_corpus = dict(batch.run_corpus(
            iter(corpus), cfg, mesh=m, batch_size=MESH_CORPUS_BATCH,
            device=DEVICE))
        art = art_fn(u8, torch.from_numpy(bx), torch.from_numpy(vd))
        sync()
        launches = dict(_cuda.LAUNCHES)
        log(f"  launch counts in the mesh-path run: {launches}")
        os.environ["PHOTOHIVE_PALETTE_KERNEL"] = "cwide"
        try:
            _cuda.reset_launch_counts()
            cwide = dps_fn(rgb2, *box_sets["a"])
            sync()
            cw_launches = dict(_cuda.LAUNCHES)
        finally:
            os.environ.pop("PHOTOHIVE_PALETTE_KERNEL", None)
        alone = {(i, k): single(frames[i], *(b[i] for b in box_sets[k]))
                 for i, k in ((0, "a"), (1, "a"), (0, "b"))}
        wall = []
        for _ in range(3):
            t1 = time.perf_counter()
            dps_fn(rgb2, *box_sets["a"])
            sync()
            wall.append(time.perf_counter() - t1)
        runs = [median_event_ms(lambda: dp_fn(u8, bx, vd, dp_tables)),
                median_event_ms(live), median_event_ms(live),
                median_event_ms(lambda: dp_fn(u8, bx, vd, dp_tables))]
        # The dp route's own cost over the live call: its one gather
        # (packing, the all_gather, unpacking) and the all_gather alone.
        words = torch.cat([t.view(torch.int32).reshape(MESH_DP_B, -1)
                           for t in dp], dim=1)
        parts = [torch.empty_like(words)]
        gather_ms = median_event_ms(
            lambda: sharding.gather_reports(dp, m.data_group))
        all_gather_ms = median_event_ms(
            lambda: dist.all_gather(parts, words, group=m.data_group))
    finally:
        dist.destroy_process_group()

    same_data(dp, live(), f"dp route B={MESH_DP_B} {H}x{W}")
    same_data(art, live(), f"mesh artifact B={MESH_DP_B} {H}x{W}")
    log(f"  dp route and the mesh artifact, B={MESH_DP_B} {H}x{W} 3 boxes: "
        f"bit-equal to full_report_batched")
    for i in range(MESH_DPS_B):
        for k in ("a", "b") if i == 0 else ("a",):
            same_data(pt.ReportData(*(t[i:i + 1] for t in dps[k])),
                      pt.ReportData(*(t[None] for t in alone[(i, k)])),
                      f"dp x spatial ({k}) image {i} against "
                      f"build_spatial_report")
        compare_variants(data_fields(cwide, i), data_fields(dps["a"], i),
                         f"dp x spatial image {i}, cwide vs bf16")
    b1, a1 = (pt.ReportData(*(t[1] for t in dps[k])) for k in ("b", "a"))
    for name, x, y in zip(a1._fields, b1, a1):
        if name != "sharpness" and not torch.equal(x, y):
            raise AssertionError(f"dp x spatial (b) image 1: {name} differs "
                                 f"from (a)")
    sharp_rel = float(((b1.sharpness - a1.sharpness).abs()
                       / a1.sharpness.abs().clamp(min=1e-30)).max())
    if not sharp_rel <= 1e-4:
        raise AssertionError(f"dp x spatial (b) image 1: sharpness rel err "
                             f"{sharp_rel} against (a)")
    log(f"  dp x spatial B={MESH_DPS_B} {SH}x{SW}: (a) each image bit-equal "
        f"to build_spatial_report; (b) image 0 bit-equal, image 1 equal to "
        f"(a) but its sharpness (masked route, rel err {sharp_rel:.2e}); "
        f"(c) cwide equals bf16 (K14 launched "
        f"{cw_launches['palette_sums_cwide']}x, K10 0x)")
    want = dict(batch.run_corpus(iter(corpus), cfg,
                                 batch_size=MESH_CORPUS_BATCH, device=DEVICE))
    if sorted(mesh_corpus) != sorted(want):
        raise AssertionError("run_corpus(mesh=...): keys differ")
    for key, got in mesh_corpus.items():
        same_data(got, want[key], f"run_corpus(mesh=...) image {key}")
    log(f"  run_corpus(mesh=...) over {len(corpus)} frames (two 2160x3840, "
        f"16 of config #3's shapes), batch {MESH_CORPUS_BATCH}: every report "
        f"bit-equal to the mesh-less run")
    check_launches(launches, MESH_COUNTERS, "mesh path")
    check_launches(cw_launches, ("cell_counts_hsv", "palette_sums_cwide"),
                   "mesh path under cwide")
    if cw_launches["palette_sums_flat_q8"] or \
            cw_launches["palette_sums_flat_qfull"]:
        raise AssertionError("dp x spatial under cwide launched K10")
    mesh_flat_kernels(frames, cfg)
    dps_ms = 1e3 * float(np.median(wall))
    dp_ms, live_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    log(f"  build_dp_spatial_report B={MESH_DPS_B} {SH}x{SW} u8, 1 rank, 3 "
        f"boxes, warm: median {dps_ms:.1f} ms (min {1e3 * min(wall):.1f}, "
        f"n=3) ({smi})")
    log(f"  dp route B={MESH_DP_B} {H}x{W} u8, median of 20 calls between "
        f"CUDA events, in turns dp, live, live, dp: "
        + " / ".join(f"{t:.4f}" for t in runs)
        + f" ms; dp {dp_ms:.4f} ms, full_report_batched {live_ms:.4f} ms; "
        f"of the dp call, gather_reports {gather_ms:.4f} ms, its all_gather "
        f"of {words.numel() * 4 / 1e3:.1f} KB {all_gather_ms:.4f} ms ({smi})")
    return dict(launches=launches, cwide_launches=cw_launches,
                dp_spatial_ms=dps_ms, dp_ms=dp_ms, live_ms=live_ms,
                gather_ms=gather_ms)


# ---------------------------------------------------- single image ---

# The kernels full_report must launch on float32 frames (K11, K2, K12 and
# K13 by tier, K5, K6a, K6b, K7+K8), and the uint8 ones it must not.
SINGLE_COUNTERS = ("cell_counts_s_f32", "margin_sort", "palette_sums_q1_f32",
                   "palette_sums_q8_f32", "palette_sums_qfull_f32",
                   "sharpness_sums", "fft_rows", "fft_cols", "polar_bins")
U8_COUNTERS = ("cell_counts_s", "palette_sums_q1", "palette_sums_q8",
               "palette_sums_qfull")
LAPLACIAN = [[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]]
# filter_image is fh*fw products added in a fixed order, the same float32
# operations on every device: bit-equal card to CPU.  Against
# laplacian_3x3 (separable, another order) on [0, 1] luma: 8 ulp of |8|.
LAPLACIAN_ATOL = 8 * 2.0 ** -20
# sharpness_avg's two sums over 2 M values, reduced in the card's order
# and the CPU's.
SUM_RTOL = 1e-5


def unit_f32(img: np.ndarray) -> torch.Tensor:
    """An (H, W, 3) uint8 frame as (3, H, W) float32 planes in [0, 1] on
    the card (the exact x / 255)."""
    from photohive_dsp_tpu_torch.ops.colorspace import u8_to_unit_f32

    return u8_to_unit_f32(torch.as_tensor(planar(img), device=DEVICE))


def hue_grid() -> tuple:
    """(h, s, v) on the card: a dense hue grid over [0, 360] with every
    multiple of 60 and its neighbouring floats (hsv_to_rgb's sector
    edges), s and v from SEED."""
    edges = np.arange(7, dtype=np.float32) * 60
    h = np.concatenate([np.linspace(0, 360, 1 << 20, dtype=np.float32),
                        edges, np.nextafter(edges, np.float32(-1)),
                        np.nextafter(edges, np.float32(400))])
    rng = np.random.default_rng(SEED + 10)
    s, v = rng.random((2, h.size), dtype=np.float32)
    return tuple(torch.as_tensor(a, device=DEVICE) for a in (h, s, v))


def equal_on_cpu(got, want, label: str) -> None:
    """A tensor (or a tuple of them) of the card bit-equal to the CPU's."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g.cpu(), w):
            raise AssertionError(f"{label}: the card's result differs from "
                                 f"the CPU's")


def check_dev_extras(images) -> None:
    """The dev utilities off the report path on card tensors against the
    same calls on the CPU: hsv_to_rgb (the HSV of all 2^24 RGB triples and
    hue_grid) and fft_shift bit-equal; filter_image (the Laplacian and 3x5
    taps) and create_filtered_rgb bit-equal, and the Laplacian taps equal
    to laplacian_3x3 (bit for bit on integer-valued planes, within
    LAPLACIAN_ATOL on luma); sharpness_avg and average_sharpness within
    SUM_RTOL, NaN with nothing above the threshold; crop_pgm and
    crop_image equal to slices, None out of range."""
    from photohive_dsp_tpu_torch.ops import colorspace as cs
    from photohive_dsp_tpu_torch.ops import fft, filtering

    trip = cs.u8_to_unit_f32(torch.as_tensor(all_triples()[0],
                                             device=DEVICE))
    for label, hsv in (("all 2^24 triples' HSV", cs.rgb_to_hsv(*trip)),
                       ("the hue grid", hue_grid())):
        got = cs.hsv_to_rgb(*hsv)
        equal_on_cpu(got, cs.hsv_to_rgb(*(t.cpu() for t in hsv)),
                     f"hsv_to_rgb on {label}")
    back = float((torch.stack(cs.hsv_to_rgb(*cs.rgb_to_hsv(*trip)))
                  - trip).abs().max())
    if not back < 1e-5:
        raise AssertionError(f"hsv_to_rgb(rgb_to_hsv(rgb)) off by {back}")
    log(f"  hsv_to_rgb: bit-equal to the CPU on all 2^24 RGB triples' HSV "
        f"and {hsv[0].numel()} hues with every sector edge; round trip of "
        f"the triples within {back:.2e}")

    rgb = unit_f32(images[1])
    pgm = cs.rgb_to_pgm(*rgb)
    spec = torch.fft.rfft2(pgm - pgm.mean()).abs().square()
    shifted = fft.fft_shift(spec)
    equal_on_cpu(shifted, fft.fft_shift(spec.cpu()), "fft_shift")
    taps = np.random.default_rng(SEED + 11).standard_normal((3, 5)).astype(
        np.float32)
    for name, t in (("Laplacian", LAPLACIAN), ("3x5", taps)):
        equal_on_cpu(filtering.filter_image(pgm, t),
                     filtering.filter_image(pgm.cpu(), t),
                     f"filter_image {name} taps")
        equal_on_cpu(filtering.create_filtered_rgb(rgb, t),
                     filtering.create_filtered_rgb(rgb.cpu(), t),
                     f"create_filtered_rgb {name} taps")
    ints = torch.as_tensor(planar(images[1])[0], device=DEVICE).float()
    if not torch.equal(filtering.filter_image(ints, LAPLACIAN),
                       filtering.laplacian_3x3(ints)):
        raise AssertionError("filter_image Laplacian differs from "
                             "laplacian_3x3 on an integer-valued plane")
    lap_err = float((filtering.filter_image(pgm, LAPLACIAN)
                     - filtering.laplacian_3x3(pgm)).abs().max())
    if not lap_err <= LAPLACIAN_ATOL:
        raise AssertionError(f"filter_image Laplacian off laplacian_3x3 by "
                             f"{lap_err}")
    log(f"  fft_shift {tuple(spec.shape)} -> {tuple(shifted.shape)}, "
        f"filter_image and create_filtered_rgb (Laplacian, 3x5 taps): "
        f"bit-equal to the CPU; the Laplacian taps equal laplacian_3x3 bit "
        f"for bit on integers, within {lap_err:.2e} on luma")

    resp = filtering.laplacian_3x3(pgm)
    for label, got, want in (
            ("sharpness_avg", filtering.sharpness_avg(resp),
             filtering.sharpness_avg(resp.cpu())),
            ("average_sharpness", filtering.average_sharpness(pgm),
             filtering.average_sharpness(pgm.cpu()))):
        rel = abs(float(got) / float(want) - 1)
        if not rel <= SUM_RTOL:
            raise AssertionError(f"{label}: rel err {rel} against the CPU")
        log(f"  {label}: {float(got):.6f}, rel err {rel:.2e} against the "
            f"CPU")
    if not torch.isnan(filtering.sharpness_avg(-resp.abs() - 1)):
        raise AssertionError("sharpness_avg with nothing above the "
                             "threshold is not NaN")

    for args in ((W * 3 // 4, W // 10, H // 2, H // 8), (W, 0, H, 0),
                 (W // 3, W // 2, H // 2, H // 4)):
        right, left, bottom, top = args
        equal_on_cpu(cs.crop_pgm(pgm, *args),
                     pgm.cpu()[top:bottom, left:right], f"crop_pgm {args}")
        equal_on_cpu(cs.crop_image(rgb, *args),
                     cs.crop_image(rgb.cpu(), *args), f"crop_image {args}")
    for bad in ((W + 1, 0, H, 0), (W, -1, H, 0), (W, 0, H + 1, 0)):
        if cs.crop_pgm(pgm, *bad) is not None \
                or cs.crop_image(rgb, *bad) is not None:
            raise AssertionError(f"crop of {bad} is not None")
    log("  crop_pgm and crop_image: the slices, bit-equal to the CPU; None "
        "out of range")


def check_viz(rep, ref) -> None:
    """utils.viz on a card report: blur_profile_visual (numpy only) against
    the CPU report's at the blur bar; the PIL and matplotlib images where
    those import."""
    import importlib.util

    from photohive_dsp_tpu_torch.utils import viz

    vis = viz.blur_profile_visual(np.asarray(rep.blur_profile.bins), H, W)
    want = viz.blur_profile_visual(np.asarray(ref.blur_profile.bins), H, W)
    if vis.shape != (H, W // 2) or not np.isfinite(vis).all():
        raise AssertionError(f"blur_profile_visual: shape {vis.shape}")
    snr = snr_db(torch.as_tensor(want), torch.as_tensor(vis))
    if not snr >= 60:
        raise AssertionError(f"blur_profile_visual: {snr} dB against the CPU")
    log(f"  viz.blur_profile_visual of the card report: {vis.shape}, "
        f"{snr:.1f} dB against the CPU report's")
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "matplotlib")}
    log(f"  viz: importable here: PIL {have['PIL']}, matplotlib "
        f"{have['matplotlib']}; the images below are those they allow")
    if not have["PIL"]:
        return
    images = {"palette": rep.generate_color_palette_image(),
              "blur profile": rep.generate_blur_profile_image(),
              "report card": rep.generate_report_card()}
    if have["matplotlib"]:
        images["frequency response"] = \
            rep.generate_blur_direction_frequency_response()
    if images["blur profile"].size != (W // 2, H):
        raise AssertionError("generate_blur_profile_image: size "
                             f"{images['blur profile'].size}")
    log("  viz: images drawn from the card report: "
        + ", ".join(f"{k} {v.size[0]}x{v.size[1]}"
                    for k, v in images.items()))


def phase_single_image(images, cfg) -> dict:
    """The single-image API on the card: full_report (through
    jitted_full_report's fn, on the default device) on phase 4's three
    frame kinds decoded to float32 (noise: q=8, structured: q=1, hue
    wheel: q_full), each under no boxes, main_boxes and main_boxes with
    thin_box; the launch counts of that run (K11, K2, K12, K13, K5, K6a,
    K6b, K7+K8 each at least once, no uint8 kernel); each report
    bit-equal to full_report_batched at B=1 on the card, through
    utils.debug.verify_report, and at the bars against full_report on the
    CPU; jitted_full_report cached, its tables on the card; the dev
    utilities (check_dev_extras) and utils.viz (check_viz).  Returns the
    launch counts."""
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.models import pipeline
    from photohive_dsp_tpu_torch.ops import _cuda
    from photohive_dsp_tpu_torch.utils import debug

    fn, tables = pipeline.jitted_full_report(H, W, cfg)
    again = pipeline.jitted_full_report(H, W, cfg)
    if again[0] is not fn or again[1] is not tables:
        raise AssertionError("jitted_full_report is not cached")
    if not (tables.polar.bin_ids.is_cuda and tables.octree.centers.is_cuda):
        raise AssertionError("jitted_full_report's tables are not on the "
                             "card")
    frames = {"noise": unit_f32(images[0]), "structured": unit_f32(images[1]),
              "hue wheel": unit_f32(images[2])}
    box_sets = {"no boxes": pipeline.empty_boxes(),
                "3 boxes": pt.set_bounding_boxes(main_boxes(H, W)),
                "3 boxes + thin": pt.set_bounding_boxes(
                    main_boxes(H, W) + [thin_box(H, W)])}
    sync()
    _cuda.reset_launch_counts()
    got = {(f, b): fn(x, *box_sets[b], tables)
           for f, x in frames.items() for b in box_sets}
    sync()
    launches = dict(_cuda.LAUNCHES)
    log(f"  launch counts in the single-image run: {launches}")
    check_launches(launches, SINGLE_COUNTERS, "single-image path")
    u8 = [k for k in U8_COUNTERS if launches[k]]
    if u8:
        raise AssertionError(f"full_report on float32 frames launched the "
                             f"uint8 kernels {u8}")

    cpu_tables = pipeline.ReportTables.build(H, W, cfg, "cpu")
    refs = {}
    for (f, b), data in got.items():
        label = f"full_report {f}, {b}"
        bx, vd = box_sets[b]
        x = frames[f]
        one = pt.ReportData(*(t[None] for t in data))
        same_data(one, pt.full_report_batched(x[None], bx[None], vd[None],
                                              tables, cfg),
                  f"{label} against full_report_batched B=1")
        rep = pt.Report(data, H, W, int(vd.sum()), cfg)
        try:
            debug.verify_report(rep)
        except AssertionError as e:
            raise AssertionError(f"{label}: {e}") from e
        ref = refs[f, b] = pipeline.full_report(x.cpu(), bx, vd, cpu_tables,
                                                cfg)
        compare_reports(data_fields(one, 0),
                        data_fields(pt.ReportData(*(t[None] for t in ref)), 0),
                        label + " (bit-equal to full_report_batched B=1)")
    check_dev_extras(images)
    key = ("structured", "3 boxes")
    check_viz(pt.Report(got[key], H, W, 3, cfg),
              pt.Report(refs[key], H, W, 3, cfg))
    return launches


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
    ("K11", "cell_counts_s (float32)", "cell_counts_s_f32",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels.py:763"),
    ("K12", "palette_sums_q1 (float32)", "palette_sums_q1_f32",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels.py:872"),
    ("K13q8", "palette_sums (float32, q=8)", "palette_sums_q8_f32",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels.py:967"),
    ("K13qfull", "palette_sums (float32, q=q_full)", "palette_sums_qfull_f32",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels.py:967"),
    ("K14", "palette_sums_by_k_cwide", "palette_sums_cwide",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels_cwide.py:139"),
    ("K15", "cell_counts_batched", "cell_counts_ids",
     "photohive_dsp_tpu_torch/csrc/palette.cu",
     "photohive_dsp_tpu/ops/pallas_kernels.py:299"),
]

# Which run each kernel's launch count comes from.  K15 is on no path:
# the JAX package calls it from tests and tools only.
LAUNCHES_FROM = {"K9": "spatial path", "K10q8": "spatial path",
                 "K10qfull": "spatial path",
                 "K11": "corpus path (candidate)",
                 "K12": "corpus path (candidate)",
                 "K13q8": "corpus path (candidate)",
                 "K13qfull": "corpus path (candidate)",
                 "K14": "corpus path (cwide)",
                 "K15": "none: tests and tools only, as in the JAX package"}

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
    "K11": "none, as K1",
    "K12": "none, as K3",
    "K13q8": "none, as K3",
    "K13qfull": "none, as K3",
    "K14": "none, as K3",
    "K15": "Tensor.scatter_add_ of ones into (B, C + 1), ids outside [0, C) "
           "mapped to column C",
}


def main(argv) -> int:
    if argv[:1] == ["--serve-child"]:
        return serve_child(argv[1], argv[2])
    if argv[:1] == ["--main-reports"]:
        # A child of compare_parent_reports: the checkout at argv[1]'s
        # package.
        sys.path.insert(0, argv[1])
        return main_reports_child(argv[2])
    if argv[:1] == ["--kernel-times"]:
        # A child of compare_parent: the checkout at argv[1]'s package.
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device")
        sys.path.insert(0, argv[1])
        from photohive_dsp_tpu_torch.config import ReportConfig
        print("KERNEL_TIMES " + json.dumps(kernel_times(ReportConfig(),
                                                        argv[2:])),
              flush=True)
        return 0
    parent = argv[1] if argv[:1] == ["--parent"] else None
    smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from photohive_dsp_tpu_torch.config import ReportConfig
    from photohive_dsp_tpu_torch.models.pipeline import ReportTables

    phase_build()
    cfg = ReportConfig()
    images = smoke_images()
    tables = ReportTables.build(H, W, cfg, DEVICE)
    log("phase 3: kernels vs plain versions")
    err, kin = phase_kernels(images, cfg, tables)
    sharp_err, skin = phase_sharpness_kernel(images)
    err["K5"] = sharp_err
    flat_err, fkin = phase_flat_kernels(kin, cfg, tables)
    err.update(flat_err)
    blur_err, bkin = phase_blur_kernels(images, cfg)
    err.update(blur_err)
    phase_row_fft_edges()
    phase_col_fft_edges()
    phase_palette_sums_edges(cfg)
    phase_near_tie_frame(cfg)
    phase_cell_and_polar_edges(cfg)
    log("phase 4: main path")
    main_out = phase_main_path(images, cfg, parent)
    launches = {"main path": main_out[0]}
    log("phase 5: corpus path (bench.py config #3)")
    by_variant, corpus_mps = phase_corpus(cfg, smi)
    launches["corpus path (candidate)"] = by_variant["candidate"]
    launches["corpus path (cwide)"] = by_variant["cwide"]
    log("phase 6: spatial path")
    launches["spatial path"], spatial_ms, spatial_err = phase_spatial(cfg)
    for key, e in spatial_err.items():
        err[key] = max(err[key], e)
    log("phase 7: timing (B=4 1080x1920: u8 for K1-K4, f32 for K11-K13, "
        "f32 luma for K5-K8, flat HSV for K9, K10, K14 and its cell ids for "
        "K15)")
    times, bounds, lat_ms, mps, single_ms = phase_timing(
        images, cfg, kin, bkin, skin, fkin, main_out, smi)
    log("phase 8: serving path (export_report, load_report in a fresh "
        "process)")
    serving = phase_serving(cfg, smi)
    launches["serving path"] = serving["launches"]
    log("phase 9: dp and dp x spatial on one NCCL rank (parallel/sharding, "
        "build_dp_spatial_report, run_corpus and load_report with a mesh)")
    meshed = phase_mesh(cfg, images, serving["blob"], smi)
    launches["mesh path"] = meshed["launches"]
    log("phase 10: single-image API on the card (full_report, "
        "jitted_full_report, the dev utilities, utils.viz)")
    launches["single-image path"] = phase_single_image(images, cfg)
    if parent:
        compare_parent(parent, cfg, smi)

    kernels = [dict(id=key, name=name, route="cuda", source=src, replaces=rep,
                    launches=launches.get(path, {}).get(counter, 0),
                    launches_from=path,
                    serving_launches=launches["serving path"][counter],
                    mesh_launches=launches["mesh path"][counter],
                    single_image_launches=launches["single-image path"][
                        counter],
                    max_abs_err=err[key], ms=times[key][0],
                    plain_ms=times[key][1], bound_ms=bounds[key][0],
                    bound_by=bounds[key][1], library_ms=times[key][2],
                    library=LIBRARY[key])
               for key, name, counter, src, rep in KERNELS
               for path in [LAUNCHES_FROM.get(key, "main path")]]
    for entry in kernels:
        if entry["id"] == "K2":
            entry["launch_floor_ms"] = times["launch floor"][0]
        if entry["id"] in ("K6a", "K6b"):
            entry.update(k6_ms=times["K6"][0], k6_bound_ms=bounds["K6"][0],
                         k6_bound_by=bounds["K6"][1])
    log(f"  K6 (K6a+K6b) {times['K6'][0]:.4f} ms against the bound of "
        f"|rfft2|^2 itself, {bounds['K6'][0]:.5f} ms "
        f"({times['K6'][0] / bounds['K6'][0]:.1f}x)")
    log(f"serving {H}x{W} B={SERVE_B}: export {serving['export_s']:.1f} s "
        f"(dynamic {serving['dynamic_export_s']:.1f} s), artifact call "
        f"{serving['artifact_ms']:.4f} ms, live call "
        f"{serving['live_ms']:.4f} ms")
    log(f"mesh (1 NCCL rank): dp B={MESH_DP_B} {H}x{W} {meshed['dp_ms']:.4f}"
        f" ms against full_report_batched {meshed['live_ms']:.4f} ms; "
        f"build_dp_spatial_report B={MESH_DPS_B} {SH}x{SW} "
        f"{meshed['dp_spatial_ms']:.1f} ms")
    log(f"single image {H}x{W}, warm medians: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in single_ms.items()) + f" ({smi})")
    log(f"get_report warm median {lat_ms:.3f} ms; full_report_batched B=8 "
        f"{mps:.1f} MP/s; build_spatial_report {SH}x{SW} {spatial_ms:.1f} ms")
    log(f"corpus path (config #3, {CORPUS_IMAGES} u8 frames, batch "
        f"{CORPUS_BATCH}): run_corpus "
        + ", ".join(f"{v} {corpus_mps[v]:.1f}" for v in VARIANTS)
        + f" MP/s; on the same {'x'.join(map(str, CORPUS_SHAPES[1]))} "
        f"batches, medians: run_corpus {corpus_mps['same_run_corpus_mps']:.1f}"
        f", run_stream_u8 prefetch 0 {corpus_mps['same_prefetch0_mps']:.1f}, "
        f"prefetch 2 {corpus_mps['same_prefetch2_mps']:.1f} MP/s; "
        f"process_corpus resume {corpus_mps['txt_mps']:.1f} MP/s ({smi})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
