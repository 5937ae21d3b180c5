"""The single-image report's graph route (models/replay.py).

On the CPU: the palette's two halves around the tier read against the
palette's kernels called one by one; CPU tensors and torch.export never
take the graph route; the cached angle table; and the route's control
flow (copies in, the two halves, the tier's graphs, the hand-back, the
counters, the key bound) with a stand-in for CUDA graphs that runs the
captured function again at each replay.  On the card (``cuda``-marked,
skipped without one): replayed reports equal the eager path's bit for bit
on each tier and sharpness route, on an unaligned shape too, a held
report survives the next call, the oldest key's graphs go, the counters
count, a capture works under the profiler, and threads share the graphs.
This file imports no JAX, so the machine with the card runs it with

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_report_graphs.py
"""

from . import torch_threads  # noqa: F401 (this worker's cores)

import contextlib
import threading

import numpy as np
import pytest
import torch

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.models import pipeline, replay
from photohive_dsp_tpu_torch.ops import _cuda
from photohive_dsp_tpu_torch.ops import blur
from photohive_dsp_tpu_torch.ops import palette_kernels as tpk
from photohive_dsp_tpu_torch.ops import quantize as tq
from photohive_dsp_tpu_torch.ops.margin_sort import margin_sort
from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv, \
    u8_to_unit_f32
from photohive_dsp_tpu_torch.utils import profiling

from tests.test_torch_cuda import noise_rgb, smooth_rgb, wheel_rgb

CFG = pt.ReportConfig()
C = CFG.num_cells
COUNTERS = ("report_graph_captures", "report_graph_replays",
            "report_graph_eager")
# name -> (frame maker (B, 3, H, W) float32, the palette tier it takes)
TIERS = {"smooth": (smooth_rgb, 1), "noise": (lambda b, h, w:
                                              noise_rgb(b, h, w, seed=9), 8),
         "wheel": (wheel_rgb, 40)}


def u8(rgb: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.round(rgb * 255).astype(np.uint8))


def boxes_for(route: str, h: int, w: int):
    """The boxes of a sharpness route: none, two K5 boxes, or a K5 box
    and a 2 px one (the masked route)."""
    if route == "none":
        return pipeline.empty_boxes()
    second = dict(top=0, bottom=h, left=w // 2, right=w) if route == "kernel" \
        else dict(top=h // 2, bottom=h // 2 + 2, left=w // 20, right=3 * w // 4)
    return pt.set_bounding_boxes([dict(top=4, bottom=h * 2 // 3, left=6,
                                       right=w * 2 // 3), second])


def counters():
    return {k: _cuda.LAUNCHES[k] for k in COUNTERS}


def eager(x, boxes, valid, tables, cfg=CFG):
    """full_report_batched at B=1, the fields without their batch; the
    launch counters left as they were."""
    before = dict(_cuda.LAUNCHES)
    data = pt.full_report_batched(x[None], torch.as_tensor(boxes)[None],
                                  torch.as_tensor(valid)[None], tables, cfg)
    _cuda.LAUNCHES.update(before)
    return pt.ReportData(*(f[0] for f in data))


def assert_same(got, want):
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


# ------------------------------------------------------------- the CPU ---

@pytest.mark.parametrize("name", list(TIERS))
def test_palette_halves_compose_to_the_palette(name):
    """Front, read and back equal the palette's kernels called one by
    one, with the tier switch written out, and the flat-HSV route."""
    make, tier = TIERS[name]
    x = u8(make(2, 48, 96))
    tables = tq.OctreeTables.for_config(CFG)
    front = tq.palette_front_from_rgb(x, CFG, tables)
    width = tq.read_tier(front.width)
    assert int(width) == tier
    got = tq.palette_back_from_rgb(front, width, CFG, tables)

    total = x.shape[2] * x.shape[3]
    counts, s_sum = tpk.cell_counts_s_from_rgb(x, CFG)
    order = margin_sort(tq.saliency_f32(counts, tables.s_v_f32, CFG))
    assign = tq.parent_assignment_from_order(counts, order, total, CFG,
                                             tables)
    if tier == 1:
        sums = tpk.palette_sums_by_k_rgb_q1(
            x, *tpk.palette_offset_table(assign, tables, C), CFG)
    else:
        sums = tpk.palette_sums_by_k_rgb(
            x, *tpk.palette_candidate_table(assign, tables, C, tier), CFG)
    want = tq.palette_finalize_by_k(sums, assign, total, tables)
    for field, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), field
    assert torch.equal(front.s_sum, s_sum)
    whole, whole_s = tq.color_palette_batched_from_rgb(x, CFG, tables)
    assert all(torch.equal(a, b) for a, b in zip(whole, got))
    assert torch.equal(whole_s, s_sum)

    f = x.float() / 255
    flat = tq.color_palette_batched(*rgb_to_hsv(f[:, 0], f[:, 1], f[:, 2]),
                                    CFG, tables, "bf16")
    for field in ("parent_ids", "n_valid", "percentages"):
        assert torch.equal(getattr(flat, field), getattr(got, field)), field


class _Report(torch.nn.Module):
    def __init__(self, tables):
        super().__init__()
        self.tables = tables

    def forward(self, x, boxes, valid):
        return pipeline.full_report(x, boxes, valid, self.tables, CFG)


def test_cpu_tensors_and_export_never_replay():
    h, w = 48, 64
    tables = pt.ReportTables.build(h, w, CFG)
    x = u8(noise_rgb(1, h, w)[0])
    boxes, valid = (torch.from_numpy(a) for a in boxes_for("kernel", h, w))
    _cuda.reset_launch_counts()
    first = pipeline.full_report(x, boxes, valid, tables, CFG)
    assert_same(pipeline.full_report(x, boxes, valid, tables, CFG), first)
    assert not replay.replayable(x)
    program = torch.export.export(_Report(tables), (x, boxes, valid))
    assert_same(pt.ReportData(*program.module()(x, boxes, valid)), first)
    assert counters() == dict.fromkeys(COUNTERS, 0)
    # A CUDA tensor while a tracer's mode runs (a fake one: no card here).
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        assert not replay.replayable(torch.empty(3, h, w, device="cuda"))


def test_cached_angle_table_equals_the_host_table(monkeypatch):
    for a in (72, 36, 7):
        table = blur.angle_table(a, torch.device("cpu"))
        assert np.array_equal(table.numpy(), blur._angle_table(a))
        assert blur.angle_table(a, torch.device("cpu")) is table
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    fresh = blur.angle_table(72, torch.device("cpu"))
    assert fresh is not blur._angle_table_on(72, torch.device("cpu"))
    assert np.array_equal(fresh.numpy(), blur._angle_table(72))


class _NoGraph:
    """Stands for ``torch.cuda.CUDAGraph``: capture and replay do nothing
    (``_RerunGraph`` runs the function instead)."""

    def replay(self):
        pass


class _Inert:
    """Stands for a CUDA event or stream."""

    def __init__(self, *args, **kwargs):
        pass

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class _RerunGraph(replay._Graph):
    """What a CUDA graph does, on the CPU: each replay runs the captured
    function again and copies its outputs into the first run's tensors."""

    def __init__(self, fn):
        self.fn = fn
        super().__init__(fn)

    def replay(self):
        out = super().replay()
        for static, new in zip(_leaves(out), _leaves(self.fn())):
            static.copy_(new)
        return out


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [leaf for y in x for leaf in _leaves(y)]
    return []


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The graph route on CPU tensors, with ``_RerunGraph`` for graphs."""
    empty = torch.empty
    monkeypatch.setattr(replay, "replayable", lambda rgb: True)
    monkeypatch.setattr(replay, "_Graph", _RerunGraph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _NoGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _Inert)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Inert())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k:
                        empty(*a, **k))
    monkeypatch.setattr(replay, "_reports", type(replay._reports)())
    _cuda.reset_launch_counts()


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("route", ["none", "kernel", "masked"])
def test_graph_route_on_the_cpu(route, dtype, cpu_graphs):
    """Every call equals the eager path bit for bit while the route goes
    from eager to captured to replayed, tier by tier; a report held across
    the next call keeps its values; the counters count each half."""
    h, w = 48, 96
    tables = pt.ReportTables.build(h, w, CFG)
    boxes = boxes_for(route, h, w)
    frames = {name: make(1, h, w)[0] for name, (make, _) in TIERS.items()}
    seq = ["noise", "noise", "noise", "wheel", "smooth", "wheel", "smooth",
           "noise"]
    held = None
    for name in seq:
        x = u8(frames[name])
        if dtype == "f32":      # the same pixels, so the same tiers
            x = u8_to_unit_f32(x)
        got = pipeline.full_report(x, *boxes, tables, CFG)
        assert_same(got, eager(x, *boxes, tables))
        if held is not None:
            assert_same(*held)
        held = (got, pt.ReportData(*(f.clone() for f in got)))
    # Call 1 eager (two halves); 2 captures the front, the tier's back
    # eager; 3 captures the back; wheel and smooth each eager, then
    # captured; 8 replays both.
    assert counters() == {"report_graph_captures": 4,
                          "report_graph_replays": 11,
                          "report_graph_eager": 5}


def test_graph_route_drops_the_oldest_key(cpu_graphs):
    boxes = boxes_for("none", 0, 0)
    heights = [40 + 4 * i for i in range(replay.REPORT_GRAPHS + 1)]
    for h in heights + heights[:1]:
        tables = pt.ReportTables.build(h, 64, CFG)
        x = u8(noise_rgb(1, h, 64)[0])
        for _ in range(2):
            assert_same(pipeline.full_report(x, *boxes, tables, CFG),
                        eager(x, *boxes, tables))
    kept = [key[0][2] for key in replay._reports]
    assert kept == heights[2:] + heights[:1]
    assert all(replay._reports[k] is not None for k in replay._reports)


# ------------------------------------------------------------ the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.cuda.synchronize()
    replay._reports.clear()
    return torch.device("cuda", torch.cuda.current_device())


def _replays_match(frames, boxes, tables, device, calls=3):
    """Each frame ``calls`` times through full_report: every report equals
    the eager path's, and is unchanged after the next call."""
    held = []
    for _ in range(calls):
        for f in frames:
            x = f.to(device)
            got = pipeline.full_report(x, *boxes, tables, CFG)
            assert_same(got, eager(x, *boxes, tables))
            held.append((got, pt.ReportData(*(t.clone() for t in got))))
    torch.cuda.synchronize()
    for got, copy in held:
        assert_same(got, copy)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["none", "kernel", "masked"])
@pytest.mark.parametrize("h,w", [(360, 512), (1080, 1920)])
def test_cuda_replayed_reports_equal_eager(route, h, w, cuda_device):
    tables = pt.cached_tables(h, w, CFG, cuda_device)
    frames = [u8(make(1, h, w)[0]) for make, _ in TIERS.values()]
    _cuda.reset_launch_counts()
    _replays_match(frames, boxes_for(route, h, w), tables, cuda_device)
    # Every tier's kernels ran, and the later calls replayed.
    for name in ("palette_sums_q1", "palette_sums_q8", "palette_sums_qfull"):
        assert _cuda.LAUNCHES[name] == 3, name
    assert _cuda.LAUNCHES["masked_sharpness"] == (9 if route == "masked"
                                                  else 0)
    assert _cuda.LAUNCHES["sharpness_sums"] == (9 if route == "kernel"
                                                else 0)
    assert counters() == {"report_graph_captures": 4,
                          "report_graph_replays": 13,
                          "report_graph_eager": 5}


@pytest.mark.cuda
def test_cuda_unaligned_shape_and_float_frames_replay(cuda_device):
    """362x514 lies outside the FFT kernels' gate (torch.fft, then the
    polar kernel); float32 frames feed the float32 palette kernels."""
    h, w = 362, 514
    tables = pt.cached_tables(h, w, CFG, cuda_device)
    frames = [u8(make(1, h, w)[0]) for make, _ in TIERS.values()]
    _cuda.reset_launch_counts()
    _replays_match(frames, boxes_for("kernel", h, w), tables, cuda_device)
    floats = [u8_to_unit_f32(x) for x in frames]
    _replays_match(floats, boxes_for("none", h, w), tables, cuda_device)
    assert _cuda.LAUNCHES["fft_rows"] == 0
    assert _cuda.LAUNCHES["palette_sums_q1_f32"] == 3
    assert _cuda.LAUNCHES["report_graph_replays"] == 26


@pytest.mark.cuda
def test_cuda_graph_key_bound_drops_the_oldest(cuda_device):
    boxes = boxes_for("none", 0, 0)
    heights = [360 + 8 * i for i in range(replay.REPORT_GRAPHS + 1)]
    for h in heights:
        tables = pt.cached_tables(h, 512, CFG, cuda_device)
        x = u8(noise_rgb(1, h, 512)[0]).to(cuda_device)
        for _ in range(3):
            assert_same(pipeline.full_report(x, *boxes, tables, CFG),
                        eager(x, *boxes, tables))
    assert [key[0][2] for key in replay._reports] == heights[1:]


@pytest.mark.cuda
def test_cuda_get_report_replays_in_its_spans(cuda_device, tmp_path):
    """get_report under the profiler: the captures run traced, every
    replay lies in a pipeline span, and the JSON equals the eager
    path's."""
    import json

    h, w = 360, 512
    img = np.ascontiguousarray(np.moveaxis(
        np.round(noise_rgb(1, h, w)[0] * 255).astype(np.uint8), 0, -1))
    boxes = pt.set_bounding_boxes([dict(top=10, bottom=300, left=20,
                                        right=480)])
    with profiling.trace(str(tmp_path)):
        texts = [pt.get_report(img, boxes, config=CFG).to_json()
                 for _ in range(4)]
    tables = pt.cached_tables(h, w, CFG, cuda_device)
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(img, -1, 0)))
    want = pt.Report(eager(x.to(cuda_device), *boxes, tables), h, w, 1,
                     CFG).to_json()
    assert texts == [want] * 4
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    pipes = [e for e in spans if e["name"] == "photohive.pipeline"]
    replays = [e for e in spans if e["name"] == "photohive.pipeline.replay"]
    assert len(pipes) == 4 and len(replays) == 5
    for r in replays:
        assert any(p["ts"] <= r["ts"] <= p["ts"] + p["dur"] for p in pipes)


@pytest.mark.cuda
def test_cuda_threads_share_the_graphs(cuda_device):
    """Four threads, each on its own stream, through one key: every
    report equals its frame's eager one."""
    h, w = 360, 512
    tables = pt.cached_tables(h, w, CFG, cuda_device)
    boxes = boxes_for("kernel", h, w)
    frames = [u8(noise_rgb(1, h, w, seed=s)[0]).to(cuda_device)
              for s in range(4)]
    want = [eager(x, *boxes, tables) for x in frames]
    for x in frames[:2]:                  # eager, then captured
        pipeline.full_report(x, *boxes, tables, CFG)
    torch.cuda.synchronize()
    errors = []

    def work(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(10):
                    got = pipeline.full_report(frames[i], *boxes, tables,
                                               CFG)
                    torch.cuda.current_stream().synchronize()
                    assert_same(got, want[i])
        except Exception as exc:       # reported by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
