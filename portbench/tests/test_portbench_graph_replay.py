"""``pipeline.graph_replay_pct.latency`` on synthetic timelines: nothing
to read without replay spans, the share of pipeline ranges that hold one
on a mixed trace, and only the main thread's ranges inside the window."""

import pytest

from portbench.loops import Window
from portbench.trace import TraceView

from .test_portbench_metrics import Run, _event, read
from .test_portbench_spans import MAIN, PREFETCH, _span, upload_trace

METRIC = "pipeline.graph_replay_pct.latency"


def mixed_trace():
    """A 1000 us window of four requests' pipelines: the first eager (no
    replay), the second with one replay, the last two with two; a replay
    on another thread and a pipeline range that starts after the window
    count for nothing."""
    ev = [_event("user_annotation", "portbench.window", 0, 1000),
          _span("photohive.pipeline", 0, 200),
          _span("photohive.pipeline", 250, 200),
          _span("photohive.pipeline.replay", 260, 20),
          _span("photohive.pipeline", 500, 200),
          _span("photohive.pipeline.replay", 510, 20),
          _span("photohive.pipeline.replay", 600, 20),
          _span("photohive.pipeline", 750, 200),
          _span("photohive.pipeline.replay", 760, 20),
          _span("photohive.pipeline.replay", 800, 20),
          _span("photohive.pipeline.replay", 50, 20, tid=PREFETCH),
          _span("photohive.pipeline", 1100, 50),
          _span("photohive.pipeline.replay", 1110, 20)]
    return TraceView(ev)


def test_no_replay_span_reads_nothing():
    assert read(METRIC, Run(Window(reports=1), trace=upload_trace())) is None
    assert read(METRIC, Run(Window(reports=1))) is None


def test_share_of_pipelines_that_replay():
    assert read(METRIC, Run(Window(reports=4), trace=mixed_trace())) == \
        pytest.approx(75.0)


def test_every_pipeline_replayed_reads_100():
    ev = [_event("user_annotation", "portbench.window", 0, 100),
          _span("photohive.pipeline", 10, 50),
          _span("photohive.pipeline.replay", 10, 20, tid=MAIN)]
    assert read(METRIC, Run(Window(reports=1), trace=TraceView(ev))) == \
        pytest.approx(100.0)
