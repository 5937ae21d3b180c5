"""``full_report`` on the card, replayed from CUDA graphs.

One image's report is about 220 launches of small kernels and custom
operators, each costing the host 5-22 us while the card waits for it.  Its
shapes are fixed per (frame shape, config), and it reads the device once:
the palette tier's width (``quantize.read_tier``).  So on the card
``full_report`` runs as two graph replays around that read:

  front (a graph per key): decode, the palette up to its tier's width
      (``quantize.palette_front_from_rgb``), luma and statistics, on the
      ``kernel`` sharpness route K5 and its finish with the boxes as
      inputs, the blur bins and the blur vectors;
  between, on the host: the width's read and, on the ``masked`` route, the
      masked sharpness operator (``variance_sharpness_batched``, eager: it
      replays its own graph inside its operator range);
  back (a graph per key and tier): the tier's pixel pass and the palette's
      finish (``quantize.palette_back_from_rgb``), then every field of the
      report packed into one buffer, which the caller gets a clone of.

A key is the frame's shape and dtype, the config, the palette variant, the
device and the sharpness route (``none``, ``kernel`` or ``masked``, from
the host boxes).  A key's first call runs ``full_report_batched`` eagerly
and its second captures the front; a tier's first request runs the back
eagerly and its second captures it, so a shape or tier seen once holds no
graph.  The graphs run the same kernels in the same order within each
stage, on the same data, as the eager path: the reports are the same bits.
``REPORT_GRAPHS`` keys are kept, the least recently used dropped first.

``_cuda.LAUNCHES`` counts each half of a call on this route:
``report_graph_captures`` the graphs captured, ``report_graph_replays``
the graphs replayed (a capture's first run included) and
``report_graph_eager`` the halves run eagerly on the way to their graph (a
key's first call two, a tier's first request one).  A replay adds its
graph's kernels to their own counters, so they still count kernels run.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..config import MAX_CROP_BOXES, ReportConfig
from ..ops import _cuda
from ..ops.blur import vectorize_blur_profile
from ..ops.fft_plan import FftPlan, fft_kernel_eligible
from ..ops.quantize import (PaletteFront, palette_back_from_rgb,
                            palette_front_from_rgb, palette_kernel_variant,
                            read_tier)
from ..ops.sharpness import (kernel_sharpness, thin_boxes,
                             variance_sharpness_batched)
from ..ops.sharpness_kernels import tickets
from ..ops.stats import div_const
from ..utils.profiling import span
from .pipeline import (ReportData, ReportTables, blur_bins, decode,
                       full_report_batched, luma_and_stats)

# Keys whose graphs are kept at once; the least recently used is dropped.
REPORT_GRAPHS = 4
# The front's box input: the (K, 4) boxes, invalid slots zeroed, then the
# K validity flags, int32.
BOX_WORDS = MAX_CROP_BOXES * 5


def replayable(rgb: torch.Tensor) -> bool:
    """Whether ``full_report`` takes the graph route for the frame ``rgb``:
    a contiguous CUDA tensor, nothing tracing the call (torch.export,
    torch.compile, a TorchDispatchMode), no capture under way, and the
    palette off the ``cwide`` parity route."""
    return (rgb.is_cuda and rgb.is_contiguous()
            and not torch.compiler.is_compiling()
            and _get_current_dispatch_mode() is None
            and not torch.cuda.is_current_stream_capturing()
            and palette_kernel_variant() != "cwide")


def sharpness_route(boxes: np.ndarray, valid: np.ndarray) -> str:
    """``variance_sharpness_batched``'s route for host boxes: ``none``
    without a valid box, ``masked`` with a thin one, else ``kernel``."""
    if not valid.any():
        return "none"
    return "masked" if bool(thin_boxes(boxes, valid).any()) else "kernel"


class _Front(NamedTuple):
    """What the front leaves for the read and the back."""

    palette: PaletteFront
    s_bar: torch.Tensor
    stats: torch.Tensor
    pgm: torch.Tensor
    sharp: Optional[torch.Tensor]   # None on the masked route
    bins: torch.Tensor
    angles: torch.Tensor
    mags: torch.Tensor


def _front(rgb, box_words, tables: ReportTables, cfg: ReportConfig,
           variant: str, route: str) -> _Front:
    """``full_report_batched``'s stages but the palette's back half and
    the masked sharpness route, on a (1, 3, H, W) frame; ``box_words``:
    (1, BOX_WORDS) int32 on the kernel route."""
    rgb, pal_in = decode(rgb, cfg, variant)
    pal_in = pal_in.contiguous()
    palette = palette_front_from_rgb(pal_in, cfg, tables.octree)
    s_bar = div_const(palette.s_sum, pal_in.shape[2] * pal_in.shape[3])
    pgm, stats = luma_and_stats(rgb)
    sharp = None
    if route == "none":
        sharp = pgm.new_zeros((pgm.shape[0], MAX_CROP_BOXES))
    elif route == "kernel":
        cut = MAX_CROP_BOXES * 4
        sharp = kernel_sharpness(
            pgm, box_words[:, :cut].view(-1, MAX_CROP_BOXES, 4),
            box_words[:, cut:].bool())
    bins = blur_bins(pgm, stats, tables, cfg)
    angles, mags = vectorize_blur_profile(bins, cfg)
    return _Front(palette, s_bar, stats, pgm, sharp, bins, angles, mags)


def _back(front: _Front, width, tables: ReportTables, cfg: ReportConfig):
    """The palette's back half at the tier ``width`` (on the host), then
    the report's fields packed: (one uint8 buffer of their bytes, each
    field's (shape less the batch, dtype), None for the masked route's
    sharpness, which is not in the buffer)."""
    palette = palette_back_from_rgb(front.palette, width, cfg, tables.octree)
    fields = ReportData(
        rgb_stats=front.stats, average_saturation=front.s_bar,
        palette_hsv=palette.hsv, palette_pct=palette.percentages,
        palette_n=palette.n_valid, palette_ids=palette.parent_ids,
        sharpness=front.sharp, blur_bins=front.bins,
        blur_vector_angles=front.angles, blur_vector_mags=front.mags)
    # Every field is float32 or int32, so each lies 4-byte aligned.
    return (torch.cat([f.reshape(-1).view(torch.uint8) for f in fields
                       if f is not None]),
            [None if f is None else (f.shape[1:], f.dtype) for f in fields])


def _unpack(buf: torch.Tensor, layout, sharp) -> ReportData:
    """The fields of ``_back``'s buffer, as views of it; ``sharp`` where
    the layout holds None."""
    out, at = [], 0
    for spec in layout:
        if spec is None:
            out.append(sharp)
            continue
        shape, dtype = spec
        n = math.prod(shape) * dtype.itemsize
        out.append(buf[at:at + n].view(dtype).view(shape))
        at += n
    return ReportData(*out)


class _Graph:
    """``fn()`` captured in one CUDA graph; ``replay`` runs it again on
    what its inputs hold and returns its outputs, at fixed addresses."""

    def __init__(self, fn):
        before = dict(_cuda.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(False):
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.out = fn()
        # The wrappers counted launches that were only captured.
        self.launches = {k: n - before[k] for k, n in _cuda.LAUNCHES.items()
                         if n != before[k]}
        _cuda.LAUNCHES.update(before)
        _cuda.LAUNCHES["report_graph_captures"] += 1

    def replay(self):
        with span("photohive.pipeline.replay"):
            self.graph.replay()
        for k, n in self.launches.items():
            _cuda.LAUNCHES[k] += n
        _cuda.LAUNCHES["report_graph_replays"] += 1
        return self.out


class _Report:
    """The graphs of one key and their inputs.  ``done`` makes a call's
    copies in wait for the previous call's replays and clone, on whatever
    stream either runs."""

    def __init__(self, x, route: str, tables: ReportTables,
                 cfg: ReportConfig, variant: str):
        self.route, self.tables, self.cfg = route, tables, cfg
        h, w = x.shape[2:]
        # The graphs read these tensors: keep them alive.
        self.plan = FftPlan.for_shape(h, w, x.device) \
            if fft_kernel_eligible(h, w) else None
        self.tickets = tickets(x.device, MAX_CROP_BOXES) \
            if route == "kernel" else None
        with torch.inference_mode(False):
            self.rgb = torch.empty_like(x)
            self.box_words = torch.empty(
                (1, BOX_WORDS), dtype=torch.int32, device=x.device) \
                if route == "kernel" else None
        self.front = _Graph(lambda: _front(self.rgb, self.box_words, tables,
                                           cfg, variant, route))
        self.backs = {}     # tier -> its _Graph, None after its first request
        self.done = torch.cuda.Event()

    def __call__(self, x, boxes: np.ndarray, valid: np.ndarray) -> ReportData:
        stream = torch.cuda.current_stream()
        stream.wait_event(self.done)
        self.rgb.copy_(x)
        if self.box_words is not None:
            # One copy from a pinned block, which the caching host allocator
            # hands out again only once this copy's event has completed.
            host = torch.empty((1, BOX_WORDS), dtype=torch.int32,
                               pin_memory=True)
            words = host.numpy()[0]
            cut = MAX_CROP_BOXES * 4
            words[:cut] = np.where(valid[:, None], boxes, 0).reshape(-1)
            words[cut:] = valid
            self.box_words.copy_(host, non_blocking=True)
        front = self.front.replay()
        width = read_tier(front.palette.width)
        sharp = None
        if self.route == "masked":
            with span("photohive.stage.sharpness"):
                sharp = variance_sharpness_batched(front.pgm, boxes[None],
                                                   valid[None])[0]
        tier = int(width)
        if tier not in self.backs:
            self.backs[tier] = None
            _cuda.LAUNCHES["report_graph_eager"] += 1
            buf, layout = _back(front, width, self.tables, self.cfg)
        else:
            if self.backs[tier] is None:
                self.backs[tier] = _Graph(lambda: _back(
                    front, width, self.tables, self.cfg))
            buf, layout = self.backs[tier].replay()
            buf = buf.clone()
        self.done.record(stream)
        return _unpack(buf, layout, sharp)


_reports: collections.OrderedDict = collections.OrderedDict()
_lock = threading.Lock()


def full_report(rgb: torch.Tensor, boxes, boxes_valid, tables: ReportTables,
                cfg: ReportConfig) -> ReportData:
    """``pipeline.full_report`` of a frame ``replayable`` allows: eager at
    a key's first call, replayed from CUDA graphs after.  The lock keeps
    two threads from sharing the graphs' inputs."""
    boxes = torch.as_tensor(boxes).cpu().numpy()
    valid = torch.as_tensor(boxes_valid).cpu().numpy().astype(bool)
    route = sharpness_route(boxes, valid)
    variant = palette_kernel_variant()
    x = rgb[None]
    key = (tuple(x.shape), x.dtype, cfg, variant, x.device, route)
    with _lock, torch.cuda.device(x.device):
        if key not in _reports:
            _reports[key] = None
            _cuda.LAUNCHES["report_graph_eager"] += 2
            data = full_report_batched(x, boxes[None], valid[None], tables,
                                       cfg)
            out = ReportData(*(f[0] for f in data))
        else:
            _reports.move_to_end(key)
            with span("photohive.pipeline"):
                if _reports[key] is None:
                    _reports[key] = _Report(x, route, tables, cfg, variant)
                out = _reports[key](x, boxes, valid)
        while len(_reports) > REPORT_GRAPHS:
            dropped = _reports.popitem(last=False)[1]
            if dropped is not None:     # its memory may be reused at once
                dropped.done.synchronize()
        return out
