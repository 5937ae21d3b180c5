"""The port's spans (``utils/profiling.span``) on the CPU: with the
profiler off a span enters no ``record_function`` and the reports equal a
traced run's; under ``profiling.trace`` ``get_report`` nests its spans as
the catalogue says, ``run_corpus`` charges its consumer's time to no span,
the exported serving graph holds no profiler op, and two gloo ranks open
the collective spans."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import io
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.models import batch
from photohive_dsp_tpu_torch.serving import export_report, load_report
from photohive_dsp_tpu_torch.utils import profiling

from .torch_spatial_ranks import spawn_ranks, traced_mesh_main

H, W = 360, 400
BOXES = [dict(top=10, bottom=120, left=20, right=200)]
STAGES = ["photohive.stage." + s for s in
          ("decode", "palette", "stats", "sharpness", "blur", "vectors")]
EPS = 0.01      # us: the Chrome trace's rounding


def frame(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3),
                                                dtype=np.uint8)


def upload():
    """An upload request: get_report with a crop box, then its JSON."""
    rep = pt.get_report(frame(0), pt.set_bounding_boxes(BOXES),
                        device="cpu")
    return rep.to_json()


def corpus(consume=lambda: None):
    """run_corpus over five frames in batches of two (two full batches and
    a padded one), each report's arrays, ``consume`` called after each."""
    out = []
    for key, data in batch.run_corpus(((i, frame(i)) for i in range(5)),
                                      pt.ReportConfig(), batch_size=2,
                                      device="cpu"):
        out.append((key, [t.numpy().copy() for t in data]))
        consume()
    return out


ENTRY_POINTS = {"get_report": upload, "run_corpus": corpus}


class Span:
    def __init__(self, e):
        self.name, self.tid = e["name"], (e.get("pid"), e.get("tid"))
        self.start, self.end = float(e["ts"]), float(e["ts"]) + e["dur"]

    def inside(self, other: "Span") -> bool:
        return (self.tid == other.tid and other.start - EPS <= self.start
                and self.end <= other.end + EPS)

    def overlaps(self, other: "Span") -> bool:
        return (self.tid == other.tid and self.start < other.end
                and other.start < self.end)


def traced(tmp_path, fn):
    """(fn's result, the user ranges of its trace)."""
    with profiling.trace(str(tmp_path)):
        result = fn()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    return result, [Span(e) for e in events
                    if e.get("cat") == "user_annotation"]


def named(spans, name):
    return [s for s in spans if s.name == name]


class Refused(torch.profiler.record_function):
    """Stands for record_function where no span may open (a class still:
    torch.export's tracer tests values against it)."""

    def __init__(self, *args, **kwargs):
        raise AssertionError("record_function entered")


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_off_spans_enter_no_record_function(monkeypatch, entry):
    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    assert profiling.span("photohive.pipeline") is \
        profiling.span("photohive.d2h")
    ENTRY_POINTS[entry]()


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_reports_equal_with_the_profiler_on(tmp_path, entry):
    off = ENTRY_POINTS[entry]()
    on, spans = traced(tmp_path, ENTRY_POINTS[entry])
    assert named(spans, "photohive.pipeline")
    if entry == "get_report":
        assert on == off
        return
    assert [k for k, _ in on] == [k for k, _ in off]
    for (_, a), (_, b) in zip(on, off):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_get_report_spans_nest_as_the_catalogue_says(tmp_path):
    _, spans = traced(tmp_path, upload)
    spans = [s for s in spans if s.name.startswith("photohive.")]
    assert {s.name for s in spans} == {
        "photohive.get_report", "photohive.entry.planar", "photohive.h2d",
        "photohive.pipeline", *STAGES, "photohive.d2h",
        "photohive.entry.report", "photohive.to_json"}
    assert len({s.tid for s in spans}) == 1
    (call,) = named(spans, "photohive.get_report")
    (pipe,) = named(spans, "photohive.pipeline")
    (json_span,) = named(spans, "photohive.to_json")
    assert pipe.inside(call) and not json_span.overlaps(call)
    for name in STAGES:
        (stage,) = named(spans, name)
        assert stage.inside(pipe), name
    for name in ("photohive.entry.planar", "photohive.h2d",
                 "photohive.entry.report"):
        (s,) = named(spans, name)
        assert s.inside(call) and not s.overlaps(pipe), name
    # Two device reads: the palette tier's, inside its stage, and the
    # report's, inside Report.
    (palette,) = named(spans, "photohive.stage.palette")
    (report,) = named(spans, "photohive.entry.report")
    tier, rows = sorted(named(spans, "photohive.d2h"),
                        key=lambda s: s.start)
    assert tier.inside(palette) and rows.inside(report)


def test_run_corpus_charges_its_consumer_to_no_span(tmp_path):
    def consume():
        with torch.profiler.record_function("consumer.sleep"):
            time.sleep(0.02)

    _, spans = traced(tmp_path, lambda: corpus(consume))
    sleeps = named(spans, "consumer.sleep")
    program = [s for s in spans if s.name.startswith("photohive.")]
    assert len(sleeps) == 5
    for name in ("photohive.corpus.stack", "photohive.corpus.split",
                 "photohive.h2d", "photohive.pipeline", "photohive.d2h"):
        assert named(program, name), name
    # Three batches: stack, copy, pipeline, read and split each.
    assert len(named(program, "photohive.corpus.split")) == 3
    for s in program:
        assert not any(s.overlaps(z) for z in sleeps), s.name


def test_catalogue_names():
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    for name in profiling.SPANS:
        assert name.startswith("photohive.") and \
            not name.startswith("photohive::"), name


def test_every_span_site_is_catalogued():
    package = Path(pt.__file__).parent
    opened = set()
    for path in package.rglob("*.py"):
        opened |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert opened == set(profiling.SPANS)


def test_exported_graph_has_no_profiler_op(tmp_path, monkeypatch):
    # Under the profiler too: while torch.export traces, a span is off.
    with profiling.trace(str(tmp_path)):
        monkeypatch.setattr(torch.profiler, "record_function", Refused)
        blob = export_report(H, W, batch_size=1, device="cpu")
        monkeypatch.undo()
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t]
    u8 = torch.from_numpy(frame(3)[None])
    boxes, valid = (torch.from_numpy(a[None])
                    for a in pt.set_bounding_boxes(BOXES))
    got = load_report(blob)(u8, boxes, valid)
    want = pt.full_report_batched(u8.permute(0, 3, 1, 2).contiguous(),
                                  boxes, valid,
                                  pt.ReportTables.build(H, W,
                                                        pt.ReportConfig()),
                                  pt.ReportConfig())
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_two_gloo_ranks_open_the_collective_spans(tmp_path):
    rgb = np.stack([frame(s) for s in (5, 6)]).transpose(0, 3, 1, 2).copy()
    boxes = np.zeros((2, 10, 4), np.int32)
    boxes[:, 0] = (10, 120, 20, 200)
    valid = np.zeros((2, 10), bool)
    valid[:, 0] = True
    ranks = spawn_ranks(2, tmp_path, traced_mesh_main, pt.ReportConfig(),
                        rgb, boxes, valid, str(tmp_path))
    for got in ranks:
        spans = [Span({"name": str(n), "ts": t[0], "dur": t[1] - t[0]})
                 for n, t in zip(got["names"], got["times"])]
        names = {s.name for s in spans}
        assert {"photohive.collective.all_reduce",
                "photohive.collective.all_gather",
                "photohive.collective.all_to_all", "photohive.h2d",
                "photohive.pipeline", *STAGES[1:]} <= names
        pipes = named(spans, "photohive.pipeline")
        # The report's gather over the data axis follows the pipeline;
        # every other collective runs inside it.
        for s in spans:
            if s.name.startswith("photohive.collective."):
                assert any(s.inside(p) for p in pipes) or \
                    s.start >= max(p.end for p in pipes), s.name
        assert named(spans, "photohive.collective.all_reduce")
        assert all(any(s.inside(p) for p in pipes) for s in
                   named(spans, "photohive.collective.all_reduce"))
