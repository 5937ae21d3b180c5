"""The metric arithmetic on synthetic inputs: percentiles and rates over
the whole window, idle share and attribution from a synthetic trace, the
roofline from shapes."""

import collections

import numpy as np
import pytest

from portbench import roofline
from portbench.loops import Reservoir, SlotSample, Window, sample_size
from portbench.spec import ROOT, load_reader
from portbench.trace import TraceView, launch_count, memcpy, owned_seconds


class Run:
    def __init__(self, window, trace=None, setup_s=None, config=None):
        self.window, self.trace, self.setup_s = window, trace, setup_s
        self.config = config or {"report_config": dict(
            h_partitions=18, s_partitions=2, v_partitions=3,
            angle_partitions=72, radius_partitions=40)}
        self.attribution = {}


def read(name, run):
    return load_reader(ROOT, name)(run)


def test_latency_percentiles_cover_every_request():
    lat = list(np.linspace(0.001, 0.100, 100))      # 1 .. 100 ms
    run = Run(Window(latencies_s=lat, reports=100, seconds=5.0))
    assert read("latency_p50_ms", run) == pytest.approx(50.5)
    assert read("latency_p95_ms", run) == pytest.approx(95.05)
    assert read("latency_p50_ms", Run(Window())) is None


def test_throughput_is_megapixels_over_the_whole_window():
    run = Run(Window(reports=10, megapixels=20.7, seconds=2.0))
    assert read("throughput_mps", run) == pytest.approx(10.35)
    assert read("throughput_mps", Run(Window(seconds=2.0))) is None


def _event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1 if cat not in ("kernel", "gpu_memcpy",
                                               "gpu_memset") else 7,
            "args": args}


def synthetic_trace():
    """A 1000 us window: a palette operator launching one kernel (100 us),
    an aten op launching one (50 us), a 6.2 MB HtoD copy (150 us)."""
    ev = [
        _event("user_annotation", "portbench.window", 0, 1000),
        _event("cpu_op", "photohive::palette_sums", 100, 30),
        _event("cuda_runtime", "cudaLaunchKernel", 110, 5, correlation=1),
        _event("kernel", "void (anonymous namespace)::palette_sums_kernel<8>"
               "((anonymous namespace)::Src, int)", 200, 100,
               correlation=1),
        _event("cpu_op", "aten::mul", 400, 10),
        _event("cuda_runtime", "cudaLaunchKernel", 402, 5, correlation=2),
        _event("kernel", "void at::native::mul_kernel(int)", 450, 50,
               correlation=2),
        _event("cpu_op", "aten::copy_", 600, 200),
        _event("cuda_runtime", "cudaMemcpyAsync", 610, 180, correlation=3),
        _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 620, 150,
               correlation=3, bytes=6_220_800),
    ]
    return TraceView(ev)


def test_idle_share_from_a_synthetic_timeline():
    view = synthetic_trace()
    assert view.window_s == pytest.approx(1e-3)
    assert view.busy_s == pytest.approx(300e-6)
    run = Run(Window(reports=1), trace=view)
    assert read("device.idle_pct.throughput", run) == pytest.approx(70.0)
    gaps = dict(view.breakdown()["idle_gaps"])
    # 770 .. 1000 inside the copy's runtime call; the rest in no range
    assert gaps["cudaMemcpyAsync"] == pytest.approx(230e-6)
    assert gaps["python (no profiled range)"] == pytest.approx(470e-6)
    assert [n for n, _ in view.breakdown()["device_ops"]] == [
        "Memcpy HtoD (Pageable -> Device)", "palette_sums_kernel<8>",
        "at::native::mul_kernel"]


def test_mesh_idle_share_averages_the_cards():
    run = Run(Window(reports=1, busy_s=0.5, window_s=2.0),
              trace=synthetic_trace())
    assert read("device.idle_pct.latency", run) == pytest.approx(75.0)


def test_kernels_belong_to_the_operator_that_launched_them():
    view = synthetic_trace()
    owners = {k.name: k.owner for k in view.kernels}
    assert owners["void (anonymous namespace)::palette_sums_kernel<8>"
                  "((anonymous namespace)::Src, int)"] == \
        "photohive::palette_sums"
    assert owners["void at::native::mul_kernel(int)"] is None
    sec, how = owned_seconds(view, ("photohive::palette_sums",), ())
    assert (sec, how) == (pytest.approx(100e-6), "operator range")
    assert launch_count(view) == 3


def test_copies_per_report_and_their_bandwidth():
    run = Run(Window(reports=2), trace=synthetic_trace())
    assert read("entry.h2d_ms", run) == pytest.approx(0.075)
    assert read("corpus.h2d_gbps", run) == pytest.approx(6_220_800 / 150e-6
                                                         / 1e9)
    assert memcpy(run.trace, "DtoH") == (0, 0)
    assert read("pipeline.launches_per_image.latency", run) == 1.5


def test_palette_roofline_from_the_shapes():
    run = Run(Window(reports=1, shapes=collections.Counter({(1080, 1920):
                                                            1})),
              trace=synthetic_trace())
    least = roofline.palette_s(1080, 1920, 112)
    # 6.2 MB at 3.35 TB/s: bytes bound (31 ops/px over 67 TFLOP/s is less)
    assert least == pytest.approx((3 * 1080 * 1920 + 8 * 112 + 8
                                   + 16 * 112) / 3.35e12)
    assert read("kernels.palette_roofline_pct", run) == \
        pytest.approx(100 * least / 100e-6)
    assert run.attribution == {"kernels.palette_roofline_pct":
                               "operator range"}
    assert read("kernels.blur_roofline_pct", run) is None   # no FFT kernel


def test_blur_bound_counts_the_luma_once_and_the_bins():
    px = 1080 * 1920
    want = max((4 * px + 4 * 72 * 40) / 3.35e12,
               (2.5 * px * np.log2(px) + 6 * 1080 * 961) / 67e12)
    assert roofline.blur_s(1080, 1920, 72, 40) == pytest.approx(want)


def test_collective_time_per_report():
    ev = [_event("user_annotation", "portbench.window", 0, 1000),
          _event("kernel", "ncclDevKernel_AllGather_RING_LL(x)", 10, 40,
                 correlation=9)]
    run = Run(Window(reports=4), trace=TraceView(ev))
    assert read("parallel.collective_ms_per_image", run) == \
        pytest.approx(0.01)


def test_reservoir_is_uniform_and_seeded():
    hits = collections.Counter()
    for seed in range(400):
        r = Reservoir(3, seed)
        for i in range(30):
            r.offer(lambda i=i: i)
        hits.update(r.items)
        assert len(r.items) == 3
    assert min(hits.values()) > 15 and max(hits.values()) < 70
    a, b = Reservoir(3, 7), Reservoir(3, 7)
    for i in range(50):
        a.offer(lambda i=i: i)
        b.offer(lambda i=i: i)
    assert a.items == b.items


def test_slot_sample_holds_every_batch_position():
    s = SlotSample(2, 2**31 + 5)
    for batch in range(40):
        for slot in range(16):
            s.offer(slot, lambda b=batch, j=slot: (b, j))
    assert len(s.items) == 32
    assert collections.Counter(j for _, j in s.items) == \
        collections.Counter({j: 2 for j in range(16)})
    again = SlotSample(2, 2**31 + 5)
    for batch in range(40):
        for slot in range(16):
            again.offer(slot, lambda b=batch, j=slot: (b, j))
    assert again.items == s.items
    assert sample_size({"loop": "device_batches", "sample_per_slot": 2},
                       {"batch_size": 16}) == 32
    assert sample_size({"loop": "mesh_corpus", "sample_per_slot": 2},
                       {"mesh": {"data": 2, "spatial": 2}}) == 4
