"""The readers of the program's spans (portbench/spans.py) on synthetic
timelines: nested spans are subtracted, only the main thread counts, the
idle by layer adds up to the window's idle, and a trace without spans
reads nothing."""

import pytest

from portbench import spans
from portbench.loops import Window
from portbench.trace import TraceView

from .test_portbench_metrics import Run, _event, read

MAIN, PREFETCH = 1, 2
NEW = ("entry.idle_ms", "pipeline.idle_ms_per_image.latency",
       "pipeline.idle_ms_per_image.throughput", "corpus.idle_ms_per_image",
       "stages.sync_wait_ms_per_image")


def _span(name, ts, dur, tid=MAIN):
    e = _event("user_annotation", name, ts, dur)
    e["tid"] = tid
    return e


def _kernel(ts, dur, n):
    return [_event("cuda_runtime", "cudaLaunchKernel", ts - 5, 2,
                   correlation=n),
            _event("kernel", f"k{n}", ts, dur, correlation=n)]


def upload_trace(prefetch=False):
    """A 1000 us window, one request: get_report 0-700 (planar 0-100, h2d
    100-200, pipeline 200-500 with a palette stage 220-400 holding the
    tier read 300-350, Report 500-650 with its read 520-600), to_json
    700-800, the harness 800-1000.  Device busy 150-250, 350-450 and
    610-620: idle 790 us, 440 of it in the entry, 150 in the pipeline,
    200 outside."""
    ev = [_event("user_annotation", "portbench.window", 0, 1000),
          _span("photohive.get_report", 0, 700),
          _span("photohive.entry.planar", 0, 100),
          _span("photohive.h2d", 100, 100),
          _span("photohive.pipeline", 200, 300),
          _span("photohive.stage.palette", 220, 180),
          _span("photohive.d2h", 300, 50),
          _span("photohive.entry.report", 500, 150),
          _span("photohive.d2h", 520, 80),
          _span("photohive.to_json", 700, 100)]
    ev += _kernel(150, 100, 1) + _kernel(350, 100, 2) + _kernel(610, 10, 3)
    if prefetch:    # a copy on another thread, across the whole window
        ev.append(_span("photohive.h2d", 0, 1000, tid=PREFETCH))
    return TraceView(ev)


def corpus_trace():
    """A 1000 us window, one batch of 4: stack 0-200, h2d 200-300,
    pipeline 300-700 (tier read 400-450), d2h 700-750, split 750-800, the
    consumer 800-1000; device busy 250-350 and 500-600."""
    ev = [_event("user_annotation", "portbench.window", 0, 1000),
          _span("photohive.corpus.stack", 0, 200),
          _span("photohive.h2d", 200, 100),
          _span("photohive.pipeline", 300, 400),
          _span("photohive.d2h", 400, 50),
          _span("photohive.d2h", 700, 50),
          _span("photohive.corpus.split", 750, 50)]
    ev += _kernel(250, 100, 1) + _kernel(500, 100, 2)
    return TraceView(ev)


def test_nested_pipeline_idle_is_not_entry_idle():
    run = Run(Window(reports=1), trace=upload_trace())
    # idle in get_report or to_json outside the pipeline (200-500):
    # 0-150, 500-610 and 620-800
    assert read("entry.idle_ms", run) == pytest.approx(0.440)
    # idle in the pipeline: 250-350 and 450-500
    assert read("pipeline.idle_ms_per_image.latency", run) == \
        pytest.approx(0.150)
    assert read("stages.sync_wait_ms_per_image", run) == \
        pytest.approx(0.050)


def test_only_the_main_thread_counts():
    plain = Run(Window(reports=1), trace=upload_trace())
    busy_thread = Run(Window(reports=1), trace=upload_trace(prefetch=True))
    for name in NEW:
        assert read(name, busy_thread) == read(name, plain), name


def test_corpus_idle_counts_staging_and_copies_outside_the_pipeline():
    run = Run(Window(reports=4), trace=corpus_trace())
    # idle: 0-250, 350-500, 600-1000; corpus 0-300 and 700-800 -> 250 +
    # 100, over 4 reports
    assert read("corpus.idle_ms_per_image", run) == pytest.approx(0.0875)
    assert read("pipeline.idle_ms_per_image.throughput", run) == \
        pytest.approx((150 + 100) * 1e-3 / 4)
    # the tier read inside the pipeline, not the copy-back after it
    assert read("stages.sync_wait_ms_per_image", run) == \
        pytest.approx(0.0125)
    assert read("entry.idle_ms", run) is None


@pytest.mark.parametrize("make,readers", [
    (upload_trace, ("entry.idle_ms", "pipeline.idle_ms_per_image.latency")),
    (corpus_trace, ("corpus.idle_ms_per_image",
                    "pipeline.idle_ms_per_image.throughput"))])
def test_idle_by_layer_adds_up_to_the_idle_share(make, readers):
    view = make()
    run = Run(Window(reports=1), trace=view)
    out = spans.split(view)
    assert out["idle_s"] / view.window_s * 100 == \
        pytest.approx(read("device.idle_pct.latency", run))
    assert sum(out["layers_s"].values()) == pytest.approx(out["idle_s"])
    assert sum(out["idle_by_span_s"].values()) == pytest.approx(out["idle_s"])
    assert out["idle_by_span_s"][spans.OUTSIDE] == \
        pytest.approx(out["layers_s"]["outside"]) == pytest.approx(200e-6)
    assert out["inside_program_pct"] == \
        pytest.approx(100 * (1 - 200e-6 / out["idle_s"]))
    # the cell's two readers and the idle outside add up to its idle
    read_ms = sum(read(name, run) for name in readers)
    assert read_ms * 1e-3 + 200e-6 == pytest.approx(out["idle_s"])


def test_idle_by_innermost_span():
    by = spans.idle_by_span(upload_trace())
    assert by == pytest.approx({
        "photohive.entry.planar": 100e-6, "photohive.h2d": 50e-6,
        "photohive.stage.palette": 50e-6, "photohive.d2h": 50e-6 + 80e-6,
        "photohive.pipeline": 50e-6, "photohive.entry.report": 60e-6,
        "photohive.get_report": 50e-6, "photohive.to_json": 100e-6,
        spans.OUTSIDE: 200e-6})


def test_a_trace_without_spans_reads_nothing():
    bare = TraceView([_event("user_annotation", "portbench.window", 0, 1000)]
                     + _kernel(100, 50, 1))
    run = Run(Window(reports=3), trace=bare)
    for name in NEW:
        assert read(name, run) is None, name
    assert read("entry.idle_ms", Run(Window(reports=3))) is None


def test_interval_arithmetic():
    x = spans.covered([_span("photohive.h2d", a, b - a)
                       for a, b in [(5, 9), (0, 2), (1, 3), (8, 12)]],
                      lambda name: True)
    assert x == [(0, 3), (5, 12)]
    assert spans.intersect(x, [(2, 6), (10, 20)]) == [(2, 3), (5, 6),
                                                      (10, 12)]
    assert spans.subtract(x, [(2, 6), (10, 20)]) == [(0, 2), (6, 10)]
    assert spans.subtract(x, []) == x
