"""Laplacian-variance sharpness over salient-character crop boxes
(counterpart of ``photohive_dsp_tpu/ops/sharpness.py``).

reference: src/filtering.c:151-183 — for each crop box, crop the grayscale
image, run the zero-padded 3x3 Laplacian over the *crop*, and report
variance(response)/mean(response).

The routes of the JAX package's ``variance_sharpness_batched``, picked by
graph conditionals (``library.branch``, ``torch.cond``) on the boxes alone,
as its ``lax.cond``s do: no work at all when no box is valid; the masked
crop-then-filter form, plain PyTorch (``_masked_sharpness``, replayed
from a CUDA graph on the card) behind the operator
``photohive::masked_sharpness`` (ops/library.py), when any valid box is
thinner than TINY_BOX_PX (the masked route); otherwise the
crop-box sums of K5 (ops/sharpness_kernels.py, the JAX package's Pallas
route) and ``finish_sharpness``.
"""

from __future__ import annotations

import collections
import threading

import torch

from ..utils.profiling import span
from .filtering import laplacian_3x3
from .library import branch, masked_sharpness
from .sharpness_kernels import box_tensor, sharpness_sums

# Boxes under this many px in either dimension take the masked route: the
# kernel route's s2/n - mean^2 cancels terms ~1e3 larger than a tiny crop's
# variance, leaving ~1e-6 absolute f32 cancellation noise.
TINY_BOX_PX = 4
# CUDA graphs of the masked route kept at once, by the inputs' shapes,
# dtypes and device; the least recently used is dropped first.
MASKED_GRAPHS = 4


def _ring_weight_map(ys, xs, box):
    """Weights W(y, x) with sum(resp_crop) == sum(pgm * W) over the crop:
    W = 9 - rows_in * cols_in (5 at corners, 3 on edges, 0 inside), the
    telescoped response sum of the zero-padded crop Laplacian."""
    top, bottom, left, right = box
    rows_in = ((ys - 1 >= top).to(torch.int32) + 1
               + (ys + 1 < bottom).to(torch.int32))
    cols_in = ((xs - 1 >= left).to(torch.int32) + 1
               + (xs + 1 < right).to(torch.int32))
    return (9 - rows_in * cols_in).to(torch.float32)


def _masked_sharpness(pgm, boxes, boxes_valid):
    """Exact masked crop-then-filter per box: (B, H, W) -> (B, K)."""
    bsz, h, w = pgm.shape
    ys = torch.arange(h, device=pgm.device)[None, :, None]
    xs = torch.arange(w, device=pgm.device)[None, None, :]
    out = []
    for k in range(boxes.shape[1]):      # one box slot at a time bounds memory
        box = [boxes[:, k, i][:, None, None] for i in range(4)]
        top, bottom, left, right = box
        inside = (ys >= top) & (ys < bottom) & (xs >= left) & (xs < right)
        insf = inside.to(pgm.dtype)
        resp = laplacian_3x3(pgm * insf)
        n = torch.clamp((bottom - top) * (right - left), min=1).to(
            pgm.dtype)[:, 0, 0]
        wmap = _ring_weight_map(ys, xs, box) * insf
        mean = (pgm * wmap).sum(dim=(1, 2)) / n
        var = (torch.square(resp - mean[:, None, None]) * insf).sum(
            dim=(1, 2)) / n
        out.append(torch.where(boxes_valid[:, k], var / mean,
                               torch.zeros_like(mean)))
    return torch.stack(out, dim=1)


class _MaskedGraph:
    """``_masked_sharpness`` captured in one CUDA graph at fixed shapes: the
    same kernels in the same order as the eager call, so the same bits,
    launched at once in place of about fifty launches a box slot.  Each
    call copies its inputs into the graph's own tensors and clones the
    output; ``done`` makes the next call's copies wait for this call's
    replay, on whatever stream either runs."""

    def __init__(self, pgm, boxes, valid):
        with torch.inference_mode(False):
            self.args = (pgm.clone(), boxes.clone(), valid.clone())
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.out = _masked_sharpness(*self.args)
        self.done = torch.cuda.Event()

    def __call__(self, pgm, boxes, valid):
        stream = torch.cuda.current_stream()
        stream.wait_event(self.done)
        for dst, src in zip(self.args, (pgm, boxes, valid)):
            dst.copy_(src)
        self.graph.replay()
        out = self.out.clone()
        self.done.record(stream)
        return out


_graphs: collections.OrderedDict = collections.OrderedDict()
_graphs_lock = threading.Lock()


def masked_sharpness_graphed(pgm, boxes, boxes_valid):
    """``_masked_sharpness`` on CUDA tensors: eager at the first call of a
    shape, replayed from a CUDA graph captured at its second call and
    after, so a shape seen once holds no graph.  Eager inside another
    graph's capture (which then holds the kernels) and on inputs that are
    not contiguous."""
    args = (pgm, boxes, boxes_valid)
    if torch.cuda.is_current_stream_capturing() or \
            not all(t.is_contiguous() for t in args):
        return _masked_sharpness(*args)
    key = tuple((t.shape, t.dtype) for t in args) + (pgm.device,)
    with _graphs_lock, torch.cuda.device(pgm.device):
        if key not in _graphs:
            _graphs[key] = None
            out = _masked_sharpness(*args)
        else:
            _graphs.move_to_end(key)
            if _graphs[key] is None:
                _graphs[key] = _MaskedGraph(*args)
            out = _graphs[key](*args)
        while len(_graphs) > MASKED_GRAPHS:
            dropped = _graphs.popitem(last=False)[1]
            if dropped is not None:     # its memory may be reused at once
                dropped.done.synchronize()
        return out


def finish_sharpness(s1, s2, boxes, boxes_valid) -> torch.Tensor:
    """K5's sums -> (B, K) float32 variance / mean, zero in invalid slots:
    mean = s1/n and var = s2/n - mean^2 in float32, as the JAX package
    finishes its kernel's sums.  ``boxes`` and ``boxes_valid``: host arrays
    or tensors."""
    dev = s1.device
    boxes = torch.as_tensor(boxes, device=dev)
    n = torch.clamp((boxes[..., 1] - boxes[..., 0])
                    * (boxes[..., 3] - boxes[..., 2]), min=1).float()
    mean = s1.float() / n
    var = s2.float() / n - mean * mean
    # Unguarded division like the reference (src/filtering.c:174).
    return torch.where(torch.as_tensor(boxes_valid, device=dev), var / mean,
                       torch.zeros_like(mean))


def kernel_sharpness(pgm, boxes: torch.Tensor, boxes_valid) -> torch.Tensor:
    """The kernel route: K5's sums of ``pgm`` over ``boxes`` (``box_tensor``'s
    (B, K, 4) int32 on pgm's device) and ``finish_sharpness``."""
    s1, s2 = sharpness_sums(pgm.contiguous(), boxes)
    return finish_sharpness(s1, s2, boxes, boxes_valid)


def variance_sharpness_batched(pgm: torch.Tensor, boxes,
                               boxes_valid) -> torch.Tensor:
    """Sharpness per crop box: (B, H, W) x (B, K, 4) x (B, K) -> (B, K)
    float32, zero in invalid slots.

    pgm is the full-resolution luma before DC removal (the reference
    computes sharpness before remove_dc_bias, src/interface.c:73 vs :79).
    ``boxes`` ([top, bottom, left, right), int) and ``boxes_valid`` (bool)
    are host arrays or CPU tensors: the route's predicates are computed
    from them without reading the device (device tensors work too, at the
    cost of a read each)."""
    boxes = torch.as_tensor(boxes)
    boxes_valid = torch.as_tensor(boxes_valid).bool()
    dev = pgm.device

    def nothing(pgm, boxes, boxes_valid):
        return pgm.new_zeros(boxes_valid.shape)

    def masked(pgm, boxes, boxes_valid):
        bt, valid = box_tensor(boxes, boxes_valid, dev), boxes_valid.to(dev)
        with span("photohive.stage.sharpness.masked"):
            return masked_sharpness(pgm, bt, valid)

    def kernel(pgm, boxes, boxes_valid):
        return kernel_sharpness(pgm, box_tensor(boxes, boxes_valid, dev),
                                boxes_valid)

    def some_valid(pgm, boxes, boxes_valid):
        return branch(thin_boxes(boxes, boxes_valid).any(), masked, kernel,
                      (pgm, boxes, boxes_valid))

    return branch(boxes_valid.any(), some_valid, nothing,
                  (pgm, boxes, boxes_valid))


def thin_boxes(boxes, boxes_valid) -> torch.Tensor:
    """Valid boxes under TINY_BOX_PX in either dimension (host arrays or
    tensors; a tensor on the boxes' device)."""
    boxes, boxes_valid = torch.as_tensor(boxes), torch.as_tensor(boxes_valid)
    return boxes_valid & ((boxes[..., 1] - boxes[..., 0] < TINY_BOX_PX)
                          | (boxes[..., 3] - boxes[..., 2] < TINY_BOX_PX))
