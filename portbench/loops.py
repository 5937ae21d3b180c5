"""The traffic generator: one measured loop per kind of traffic file
(``portbench/traffic/<name>.json``, key ``loop``), each driving the
program's own entry point over the configuration's frames.

    closed_loop     one caller: get_report + Report.to_json per request
    corpus_stream   run_corpus over an endless cycle of host frames
    device_batches  BatchRunner.run_u8 on batches held on the device
    mesh_corpus     run_corpus on a (data, spatial) mesh, one process a card

Each warms its own shapes up first, then measures for ``seconds`` and
returns a ``Window``: what was delivered, when, and a sample of the
outputs drawn from the seed for the check (``sample_per_slot`` reports
of each position in a batch).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import random
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np

from .trace import TRACE_SECONDS, Tracer

# Launch counters of the palette-sums kernel by candidate width: uint8 and
# float32 RGB frames, and flat HSV (the row-sharded route).
PALETTE_TIERS = {"q=1": ("palette_sums_q1", "palette_sums_q1_f32"),
                 "q_small": ("palette_sums_q8", "palette_sums_q8_f32",
                             "palette_sums_flat_q8"),
                 "q_full": ("palette_sums_qfull", "palette_sums_qfull_f32",
                            "palette_sums_flat_qfull"),
                 "cwide": ("palette_sums_cwide",)}


@dataclasses.dataclass
class Window:
    seconds: float = 0.0            # wall time of the measured window
    attempted: int = 0
    failed: int = 0
    reports: int = 0                # reports delivered in the window
    megapixels: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    shapes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    sample: list = dataclasses.field(default_factory=list)
    tiers: Dict[str, int] = dataclasses.field(default_factory=dict)
    trace: object = None            # TraceView of a traced window
    busy_s: Optional[float] = None  # averaged over the cards (mesh)
    window_s: Optional[float] = None
    memory_peak_bytes: int = 0
    boxes_sent: bool = True         # the configuration's crop boxes went in


class Reservoir:
    """A uniform sample of ``k`` of all items offered, drawn from the seed
    (algorithm R); only the kept items are built."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n, self.items = k, random.Random(seed), 0, []

    def offer(self, make: Callable[[], object]) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.items[j] = make()


class SlotSample:
    """``per_slot`` of the reports at each position of a batch (a request
    of a closed loop is position 0; on a mesh a position is a data
    shard's image), each a ``Reservoir`` drawn from the seed: a fault
    confined to one position is sampled in every run."""

    def __init__(self, per_slot: int, seed: int):
        self.per_slot, self.seed, self.slots = per_slot, seed, {}

    def offer(self, slot: int, make: Callable[[], object]) -> None:
        if slot not in self.slots:
            self.slots[slot] = Reservoir(self.per_slot,
                                         self.seed * 1009 + slot)
        self.slots[slot].offer(make)

    @property
    def items(self) -> list:
        return [x for s in sorted(self.slots) for x in self.slots[s].items]


def sample_size(traffic: dict, config: dict) -> int:
    """How many reports a run of the cell samples, once every position of
    its batches has delivered ``sample_per_slot``."""
    if traffic["loop"] == "closed_loop":
        slots = 1
    elif traffic["loop"] == "mesh_corpus":
        slots = config["mesh"]["data"]
    else:
        slots = config["batch_size"]
    return traffic["sample_per_slot"] * slots


def _launch_counts() -> Dict[str, int]:
    from photohive_dsp_tpu_torch.ops import _cuda
    return dict(_cuda.LAUNCHES)


def _tiers(before: Dict[str, int]) -> Dict[str, int]:
    after = _launch_counts()
    return {tier: sum(after[k] - before[k] for k in keys)
            for tier, keys in PALETTE_TIERS.items()}


def _measure_s(ctx) -> float:
    return min(ctx.seconds, TRACE_SECONDS) if ctx.trace else ctx.seconds


def _fail(win: Window, what: str) -> None:
    win.failed += 1
    if win.failed == 1:
        print(f"portbench: {what} failed:", file=sys.stderr)
        traceback.print_exc()


def closed_loop(ctx) -> Window:
    """One caller, each request the upload scorer's: get_report on a host
    frame of the pool, round robin, then its JSON string; the next request
    starts when this one has its string."""
    import photohive_dsp_tpu_torch as pt

    frames, boxes, cfg = ctx.frames, ctx.boxes, ctx.report_config

    def request(i):
        frame = frames[i % len(frames)]
        rep = pt.get_report(frame, salient_characters=pt.set_bounding_boxes(
            boxes[i % len(frames)]), config=cfg, device=ctx.device)
        return rep, rep.to_json()

    for i in range(ctx.traffic.get("warmup", 3)):
        request(i)
    ctx.sync()
    win, res = Window(), SlotSample(ctx.traffic["sample_per_slot"], ctx.seed)
    before = _launch_counts()
    limit = _measure_s(ctx)
    ctx.mark_setup()
    with Tracer(ctx.trace) as tracer:
        t0 = time.perf_counter()
        for i in itertools.count():
            if time.perf_counter() - t0 >= limit:
                break
            win.attempted += 1
            a = time.perf_counter()
            try:
                rep, text = request(i)
            except Exception:   # a failed request counts, the caller goes on
                _fail(win, "request")
                continue
            b = time.perf_counter()
            if rep is None:
                win.failed += 1
                continue
            win.latencies_s.append(b - a)
            h, w = frames[i % len(frames)].shape[:2]
            win.reports += 1
            win.megapixels += h * w / 1e6
            win.shapes[(h, w)] += 1
            res.offer(0, lambda: (i % len(frames), rep, text))
        win.seconds = time.perf_counter() - t0
    win.trace = tracer.view
    win.tiers = _tiers(before)
    win.sample = res.items
    return win


def _deliver(win: Window, res: SlotSample, ctx, key, slot, row) -> None:
    idx = key % len(ctx.frames)
    h, w = ctx.frames[idx].shape[:2]
    win.reports += 1
    win.megapixels += h * w / 1e6
    win.shapes[(h, w)] += 1
    res.offer(slot, lambda: (idx, row))


class _StopWindow(Exception):
    """Raised by the frame stream to end the window between batches."""


def _corpus(ctx, mesh=None, go: Callable[[bool], bool] = None) -> Window:
    """run_corpus over an endless cycle of the frames.  The window opens
    after one warm pass and closes when ``seconds`` are up, at the next
    frame run_corpus asks for: every batch it ran by then has yielded all
    its reports, and the frames waiting in its buckets are dropped unrun.
    ``go(want)`` is asked before each frame (the mesh's ranks agree on
    it).  run_corpus takes no crop boxes: a configuration's boxes are not
    sent, and the check compares no sharpness here."""
    from photohive_dsp_tpu_torch.models import batch

    frames, cfg = ctx.frames, ctx.report_config
    warm = len(frames)
    win = Window(boxes_sent=False)
    res = SlotSample(ctx.traffic["sample_per_slot"], ctx.seed)
    if ctx.config.get("boxes"):
        print(f"portbench: run_corpus takes no crop boxes: the "
              f"configuration's {len(ctx.config['boxes'])} boxes are not "
              f"sent", file=sys.stderr)
    limit = _measure_s(ctx)
    tracer = Tracer(ctx.trace)
    # A batch's reports are yielded one after another, in batch order,
    # before run_corpus asks for its next frame: the count of reports
    # since the last frame asked for is the position in the batch.
    state = {"open": False, "t0": 0.0, "before": None, "asked": 0}

    def stream():
        for i in itertools.count():
            state["asked"] += 1
            if i == warm:
                ctx.sync()
                ctx.mark_setup()
                state["before"] = _launch_counts()
                tracer.__enter__()
                state["open"], state["t0"] = True, time.perf_counter()
            want = not (state["open"]
                        and time.perf_counter() - state["t0"] >= limit)
            if not (go(want) if go else want):
                raise _StopWindow
            yield i, frames[i % len(frames)]

    route = {k: ctx.config[k] for k in ("spatial_route_mp",)
             if k in ctx.config}
    gen = batch.run_corpus(stream(), cfg, mesh=mesh,
                           batch_size=ctx.config["batch_size"],
                           device=ctx.device, **route)
    asked, slot = 0, 0
    try:
        for key, row in gen:
            slot = slot + 1 if state["asked"] == asked else 0
            asked = state["asked"]
            if state["open"]:
                win.attempted += 1
                _deliver(win, res, ctx, key, slot, row)
    except _StopWindow:
        pass
    except Exception:
        _fail(win, "run_corpus")
    if state["open"]:
        win.seconds = time.perf_counter() - state["t0"]
        tracer.__exit__(None, None, None)
        win.tiers = _tiers(state["before"])
    win.trace = tracer.view
    win.sample = res.items
    return win


def corpus_stream(ctx) -> Window:
    """The batch job: ``run_corpus`` on host frames, reports counted as they
    are yielded (host staging: np.stack, the pageable copy, one copy of
    each batch's reports back)."""
    return _corpus(ctx)


def device_batches(ctx) -> Window:
    """The same corpus's full batches held on the device, with the
    configuration's crop boxes, ``BatchRunner.run_u8`` on one bucket after
    another, each batch's reports copied to the host once as run_corpus
    does: the corpus layer's staging bypassed."""
    import torch
    import photohive_dsp_tpu_torch as pt
    from photohive_dsp_tpu_torch.models import batch, pipeline

    cfg, b = ctx.report_config, ctx.config["batch_size"]
    per_shape = ctx.traffic["batches_per_shape"]
    by_shape = collections.defaultdict(list)
    for i, f in enumerate(ctx.frames):
        by_shape[f.shape[:2]].append(i)
    batches = []   # (frame indices, device batch, boxes, valid), by bucket
    for k in range(per_shape):
        for shape, idx in by_shape.items():
            take = idx[k * b:(k + 1) * b]
            if len(take) == b:
                x = torch.from_numpy(np.stack([ctx.frames[i] for i in take]))
                boxes = [pt.set_bounding_boxes(ctx.boxes[i]) for i in take]
                batches.append((take, x.to(ctx.device),
                                np.stack([bx for bx, _ in boxes]),
                                np.stack([v for _, v in boxes])))
    runner = batch.BatchRunner(cfg, device=ctx.device)

    def run(x, boxes, valid):
        out = runner.run_u8(x, boxes, valid)
        return pipeline.ReportData(*(t.cpu() for t in out))

    for _, x, boxes, valid in batches:
        run(x, boxes, valid)
    ctx.sync()
    win, res = Window(), SlotSample(ctx.traffic["sample_per_slot"], ctx.seed)
    before = _launch_counts()
    limit = _measure_s(ctx)
    ctx.mark_setup()
    with Tracer(ctx.trace) as tracer:
        t0 = time.perf_counter()
        for take, x, boxes, valid in itertools.cycle(batches):
            if time.perf_counter() - t0 >= limit:
                break
            win.attempted += len(take)
            try:
                host = run(x, boxes, valid)
            except Exception:
                _fail(win, "run_u8")
                win.failed += len(take) - 1
                break
            for j, i in enumerate(take):
                _deliver(win, res, ctx, i, j,
                         pipeline.ReportData(*(t[j] for t in host)))
        win.seconds = time.perf_counter() - t0
    win.trace = tracer.view
    win.tiers = _tiers(before)
    win.sample = res.items
    return win


def mesh_corpus(ctx) -> Optional[Window]:
    """``run_corpus`` on a (data, spatial) mesh: every rank streams the same
    frames and gets every report; rank 0 decides when the window closes,
    counts the reports and keeps the sample.  Returns None on other
    ranks."""
    import torch
    import torch.distributed as dist
    from photohive_dsp_tpu_torch.parallel import mesh as pmesh

    shape = ctx.config["mesh"]
    m = pmesh.make_mesh(data=shape["data"], spatial=shape["spatial"],
                        timeout_s=ctx.collective_timeout_s)
    rank = dist.get_rank()
    check = torch.tensor([sum(int(f.sum(dtype=np.int64)) for f in
                              ctx.frames)], dtype=torch.int64)
    lo, hi = check.clone(), check.clone()
    dist.all_reduce(lo, dist.ReduceOp.MIN)
    dist.all_reduce(hi, dist.ReduceOp.MAX)
    if int(lo) != int(hi):
        raise RuntimeError("the ranks made different frames from one seed")

    def go(want: bool) -> bool:
        flag = torch.tensor([int(want)], dtype=torch.int32)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    win = _corpus(ctx, mesh=m, go=go)
    busy = torch.tensor([win.trace.busy_s if win.trace else 0.0,
                         win.trace.window_s if win.trace else 0.0],
                        dtype=torch.float64)
    dist.all_reduce(busy)
    peak = torch.tensor([ctx.memory_peak()], dtype=torch.int64)
    dist.all_reduce(peak, dist.ReduceOp.MAX)
    win.memory_peak_bytes = int(peak)
    world = dist.get_world_size()
    if ctx.trace:
        win.busy_s, win.window_s = (float(x) / world for x in busy)
    return win if rank == 0 else None


LOOPS = {"closed_loop": closed_loop, "corpus_stream": corpus_stream,
         "device_batches": device_batches, "mesh_corpus": mesh_corpus}
