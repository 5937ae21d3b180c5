"""Per-stage timing and profiling (counterpart of
``photohive_dsp_tpu/utils/profiling.py``).

The reference wraps every pipeline stage in printf wall-clock timers
(START_TIMING/END_TIMING, src/utilities.h:10-18, used throughout
src/interface.c:38-92).  Here:

  * ``span``: a named range inside the program (``SPANS`` lists every
    name: the entry point, the corpus layer's staging, the pipeline, its
    stages, its graph replays and the masked sharpness route, the copies
    to and from the device, the collectives).
    Under ``torch.profiler`` it is ``record_function``, a
    ``user_annotation`` range on the same timeline as the device's kernels
    and copies, so a trace charges each interval the device sat idle to
    the span the host was in.  With the profiler off, and while
    ``torch.export`` or ``torch.compile`` traces, it returns one shared
    no-op context after reading one flag: it costs the program nothing
    else and leaves an exported graph as it was;
  * ``stage_timings``: each stage of the report run on its own, warm, and
    timed with CUDA events on the card (``perf_counter`` on the CPU),
    under the reference transcript's labels (README.md:63-75).  A stage's
    time includes the host's work of launching it; the "full report
    (fused)" row, one ``full_report_batched`` call, is the total;
  * ``trace``: a ``torch.profiler`` trace of a block (CPU and CUDA
    activities) written as a Chrome trace.  The kernels appear in it under
    their operator names (``photohive::margin_sort``, ...,
    ops/library.py), inside the spans.

Span names start with ``photohive.``, never with ``photohive::``: a kernel
belongs to the outermost ``photohive::`` range that launched it, and the
spans sit outside the operators.  A span never holds a ``yield``, so a
generator's consumer is never charged to the program.

    python -m photohive_dsp_tpu_torch.utils.profiling [H W B [device]]
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from ..config import MAX_CROP_BOXES, ReportConfig

# Every span the program opens, by layer.
SPANS = (
    # entry: get_report and the report's JSON
    "photohive.get_report", "photohive.entry.planar",
    "photohive.entry.report", "photohive.to_json",
    # corpus: run_corpus's staging around each batch
    "photohive.corpus.stack", "photohive.corpus.split",
    # copies: a frame to the device; a device read the host waits for
    "photohive.h2d", "photohive.d2h",
    # pipeline: full_report_batched, the row-sharded body, their stages
    "photohive.pipeline", "photohive.stage.decode",
    "photohive.stage.palette", "photohive.stage.stats",
    "photohive.stage.sharpness", "photohive.stage.blur",
    "photohive.stage.vectors",
    # a replay of one of full_report's CUDA graphs, inside photohive.pipeline
    "photohive.pipeline.replay",
    # the masked sharpness route, inside photohive.stage.sharpness
    "photohive.stage.sharpness.masked",
    # parallel: each torch.distributed call
    "photohive.collective.all_gather", "photohive.collective.all_to_all",
    "photohive.collective.all_reduce",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """The context ``with span(name):`` opens: ``record_function(name)``
    while a profiler records (the autograd profiler's module flag) and
    nothing traces the program, else one shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled \
            or torch.compiler.is_compiling():
        return _OFF
    return torch.profiler.record_function(name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn: Callable, device: torch.device, iters: int = 5):
    """(seconds a call, the last output) of ``fn`` run ``iters`` times
    after one warm call: CUDA events around the calls on the card, the
    host clock around calls that end in a sync on the CPU."""
    out = fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) / iters, out


def stage_timings(height: int = 1080, width: int = 1920, batch: int = 16,
                  cfg: ReportConfig | None = None, seed: int = 0,
                  device="cuda", iters: int = 5) -> Dict[str, float]:
    """Seconds a call of each stage (warm) on ``device``, for ``batch``
    seeded uint8 noise frames of ``height`` x ``width``, each with one crop
    box.  The stages take the frames decoded to float32; the palette stage
    is the flat-HSV route (K9, K2, K10), as the JAX package times it; the
    blur stages are the FFT kernels (on shapes inside their gate, else
    torch's FFT) and the polar kernel; the full report takes the uint8
    frames (K1-K8, the main path)."""
    from ..models.pipeline import (cached_tables, full_report_batched,
                                   resolve_device)
    from ..ops import colorspace, sharpness, stats
    from ..ops.blur import lognorm_bin_means, vectorize_blur_profile
    from ..ops.fft import magnitude_fft
    from ..ops.fft_kernels import magnitude2
    from ..ops.fft_plan import FftPlan, fft_kernel_eligible
    from ..ops.quantize import color_palette_batched

    cfg = cfg or ReportConfig()
    dev = resolve_device(device)
    tables = cached_tables(height, width, cfg, dev)
    rng = np.random.default_rng(seed)
    u8 = torch.as_tensor(rng.integers(0, 256, (batch, 3, height, width),
                                      dtype=np.uint8), device=dev)
    rgb = colorspace.u8_to_unit_f32(u8)
    boxes = np.zeros((batch, MAX_CROP_BOXES, 4), np.int32)
    boxes[:, 0] = (height // 8, height // 2, width // 8, width // 2)
    valid = np.zeros((batch, MAX_CROP_BOXES), bool)
    valid[:, 0] = True
    a, r = cfg.angle_partitions, cfg.radius_partitions

    out: Dict[str, float] = {}

    def stage(name, fn):
        out[name], res = _time(fn, dev, iters)
        return res

    h, s, v = stage("rgb2hsv", lambda: colorspace.rgb_to_hsv(
        rgb[:, 0], rgb[:, 1], rgb[:, 2]))
    pgm = stage("rgb2pgm", lambda: colorspace.rgb_to_pgm(
        rgb[:, 0], rgb[:, 1], rgb[:, 2]))
    st = stage("rgb statistics", lambda: stats.rgb_statistics(rgb))
    stage("hsv average", lambda: stats.mean_saturation(s))
    stage("color palette", lambda: color_palette_batched(
        h, s, v, cfg, tables.octree, "bf16"))
    stage("sharpness", lambda: sharpness.variance_sharpness_batched(
        pgm, boxes, valid))
    pgm_dc = pgm - stats.blur_dc(st)[:, None, None]
    if fft_kernel_eligible(height, width):
        plan = FftPlan.for_shape(height, width, dev)
        mag = stage("magnitude fft", lambda: magnitude2(pgm_dc, plan))
    else:
        mag = stage("magnitude fft", lambda: magnitude_fft(pgm_dc))
    bins = stage("blur profile bins", lambda: lognorm_bin_means(
        mag.reshape(batch, -1), tables.polar, a, r))
    stage("blur vectors", lambda: vectorize_blur_profile(bins, cfg))
    stage("full report (fused)", lambda: full_report_batched(
        u8, boxes, valid, tables, cfg))
    return out


def print_stage_timings(height: int = 1080, width: int = 1920,
                        batch: int = 16, cfg: ReportConfig | None = None,
                        device="cuda") -> Dict[str, float]:
    """Reference-transcript-style printout (cf. reference README.md:62-75)
    of ``stage_timings``; returns them."""
    timings = stage_timings(height, width, batch, cfg, device=device)
    mp = batch * height * width / 1e6
    name = (torch.cuda.get_device_name(torch.device(device))
            if torch.device(device).type == "cuda" else "cpu")
    print(f"per-stage timings on {name}, batch of {batch} {width}x{height} "
          f"({mp:.1f} MP):")
    for stage, t in timings.items():
        print(f"  {stage} took {t:.6f} seconds to execute")
    print(f"  => full report throughput "
          f"{mp / timings['full report (fused)']:.1f} MP/s")
    return timings


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a block, CPU and (when present) CUDA
    activities; on exit writes ``<log_dir>/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto).  Yields the profiler, whose
    ``key_averages()`` sums time by operator."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


if __name__ == "__main__":
    import sys

    args = [int(x) for x in sys.argv[1:4]]
    print_stage_timings(*args, device=(sys.argv[4] if len(sys.argv) > 4
                                       else "cuda"))
