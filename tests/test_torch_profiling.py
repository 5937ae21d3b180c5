"""photohive_dsp_tpu_torch/utils/profiling.py on the CPU, at a tiny shape:
``stage_timings`` returns the JAX package's stage names
(photohive_dsp_tpu/utils/profiling.py:83-111) with positive times, and
``trace`` writes a Chrome trace in which the kernels' operators and the
program's ``photohive.`` spans appear."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import json

import numpy as np

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.utils import profiling

STAGES = ["rgb2hsv", "rgb2pgm", "rgb statistics", "hsv average",
          "color palette", "sharpness", "magnitude fft", "blur profile bins",
          "blur vectors", "full report (fused)"]


def test_stage_timings_names_and_times():
    t = profiling.stage_timings(60, 80, 2, device="cpu", iters=1)
    assert list(t) == STAGES
    assert all(v > 0 for v in t.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (360, 400, 3),
                                            dtype=np.uint8)
    with profiling.trace(str(tmp_path)) as prof:
        pt.get_report(img, device="cpu")
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"photohive::cell_counts_s", "photohive::margin_sort",
            "photohive::fft_rows", "photohive::polar_lognorm"} <= names
    assert {"photohive.get_report", "photohive.entry.planar",
            "photohive.h2d", "photohive.pipeline", "photohive.stage.palette",
            "photohive.stage.blur", "photohive.d2h",
            "photohive.entry.report"} <= names
    assert {n for n in names if n and n.startswith("photohive.")} <= \
        set(profiling.SPANS)
    assert any(e.key == "photohive::fft_cols" for e in prof.key_averages())
