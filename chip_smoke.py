"""Smoke test of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Drives photohive_dsp_tpu_torch's main path — get_report on 1080x1920 frames
and full_report_batched on a batch of 8 — through its CUDA kernels, and
checks every result against the same call on the CPU (the plain PyTorch
path).  Phases, each of which raises on failure:

  1. device: a CUDA device must be present; prints its name and power limit;
  2. build: compiles the kernels from photohive_dsp_tpu_torch/csrc;
  3. kernels against their plain versions on the card, at 1080x1920, B=4,
     float32 and uint8 input;
  4. main path, with the kernel launch counts of that run;
  5. timing: warm get_report latency, batch-8 throughput, each kernel's
     time beside its plain version's.

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
SEED = 0
DEVICE = "cuda"
K1_S_RTOL = 1e-6          # saturation sum vs its plain version
SUMS_RTOL = 1e-5          # palette hue/s/v sums vs their plain versions


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- inputs ---

def noise_image(rng) -> np.ndarray:
    return rng.integers(0, 256, (H, W, 3), dtype=np.uint8)


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


def hue_wheel_image(rng) -> np.ndarray:
    """All 18 hues at one (s, v) plus a gray band: the gray cell is
    populated but not a parent and ties across every hue, so the palette
    needs the full candidate width."""
    hue = np.broadcast_to(np.arange(W)[None, :] / W * 360.0, (H, W))
    s, v = 0.8, 0.8
    c = v * s
    xx = c * (1 - np.abs((hue / 60) % 2 - 1))
    sec = (hue // 60).astype(int) % 6
    r = np.choose(sec, [c, xx, 0, 0, xx, c])
    g = np.choose(sec, [xx, c, c, xx, 0, 0])
    b = np.choose(sec, [0, 0, xx, c, c, xx])
    rgb = np.stack([r, g, b], axis=-1) + (v - c)
    rgb[: H // 40] = 0.5
    rgb = rgb + rng.normal(0, 0.002, rgb.shape)
    return np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def planar(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(img, -1, 0))


# --------------------------------------------------------------- checks ---

def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())


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


def compare_reports(gpu: dict, cpu: dict, label: str) -> None:
    """The port on the card against the same call on the CPU, at the bars
    the port is held to against the JAX package."""
    for f in ("palette_ids", "palette_n", "palette_pct"):
        if not np.array_equal(gpu[f], cpu[f]):
            raise AssertionError(f"{label}: {f} differs from the CPU path")
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
            raise AssertionError(f"{label}: {f} differs from the CPU path")
    if not (np.isfinite(gpu["blur_bins"]).all()
            and np.isfinite(gpu["rgb_stats"]).all()):
        raise AssertionError(f"{label}: non-finite report values")
    log(f"  {label}: matches the CPU path (hsv {hsv:.2e}, sat {sat:.2e}, "
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
    return err, dict(u8=u8, slot=slot, off=off, sal=sal, assign=assign)


def phase_main_path(images, cfg):
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import _cuda

    noise, structured, wheel = images[:3]
    boxes = pt.set_bounding_boxes([
        dict(top=H // 10, bottom=H * 2 // 3, left=W // 10, right=W * 5 // 8),
        dict(top=H * 3 // 10, bottom=H * 5 // 6, left=W // 2, right=W - 20),
        dict(top=H // 2, bottom=H // 2 + 2, left=W // 20,
             right=W * 3 // 4)])                              # thin: 2 px
    calls = [("noise", noise, None), ("structured", structured, None),
             ("structured+3 boxes", structured, boxes),
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
                        f"full_report_batched B=8, image {i}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return launches, tables_gpu, batch_gpu, bboxes, bvalid


def phase_timing(images, cfg, kin, main):
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.ops import palette_kernels as pk
    from photohive_dsp_tpu_torch.ops import quantize as qz
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
    log(f"  full_report_batched B=8 1080x1920 u8 (device-resident, 3 boxes):"
        f" {1e3 * dt:.3f} ms per batch, {mps:.1f} MP/s")

    c = cfg.num_cells
    _, q_full = qz.palette_widths(cfg)
    x = kin["u8"]
    assign = kin["assign"]
    c8 = pk.palette_candidate_table(assign, tables.octree, c, 8)
    cf = pk.palette_candidate_table(assign, tables.octree, c, q_full)
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
    }
    times = {}
    for key, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain; report the mean of each pair
        p1 = cuda_ms(plain, 3)
        k1 = cuda_ms(kern, 20)
        k2 = cuda_ms(kern, 20)
        p2 = cuda_ms(plain, 3)
        times[key] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"  {key}: kernel {times[key][0]:.4f} ms, plain "
            f"{times[key][1]:.4f} ms (B=4 u8 1080x1920)")
    return times, lat_ms, mps


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
]


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
    log("phase 3: kernels vs plain versions, 1080x1920, B=4")
    err, kin = phase_kernels(images, cfg, tables)
    log("phase 4: main path")
    main_out = phase_main_path(images, cfg)
    launches = main_out[0]
    log("phase 5: timing")
    times, lat_ms, mps = phase_timing(images, cfg, kin, main_out)

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[counter], max_abs_err=err[key],
                    ms=times[key][0], plain_ms=times[key][1])
               for key, name, counter, src, rep in KERNELS]
    log(f"get_report warm median {lat_ms:.3f} ms; full_report_batched B=8 "
        f"{mps:.1f} MP/s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
