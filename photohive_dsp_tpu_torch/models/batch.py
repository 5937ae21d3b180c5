"""Batched, bucketed report execution (counterpart of
``photohive_dsp_tpu/models/batch.py``, without its device mesh).

The reference processes one image per call (src/interface.c:20); the
throughput comes from running same-shape images as one batch through
``full_report_batched``.  Mixed-resolution corpora are grouped into shape
buckets, and a bucket's partial batch is padded up to the batch size with
copies of its last image, whose reports are dropped.  PyTorch runs eagerly,
so there is no compiled program to cache: what is built once per
(H, W, config, device) is the tables (``pipeline.cached_tables``) and the
FFT plan (``FftPlan.for_shape``).  The palette route follows
``PHOTOHIVE_PALETTE_KERNEL``, read at each batch.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MAX_CROP_BOXES, ReportConfig
from ..ops.fft_plan import FftPlan, fft_kernel_eligible
from .pipeline import (ReportData, cached_tables, full_report_batched,
                       resolve_device)


def _pad_tail(x: np.ndarray, pad: int) -> np.ndarray:
    """Append ``pad`` copies of the last batch row."""
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])


class BatchRunner:
    """Runs same-shape image batches through ``full_report_batched`` on
    ``device`` ("cuda" by default; raises when CUDA is missing)."""

    def __init__(self, cfg: ReportConfig, device="cuda"):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)

    def _norm_boxes(self, b, boxes, boxes_valid):
        if boxes is None:
            return (np.zeros((b, MAX_CROP_BOXES, 4), np.int32),
                    np.zeros((b, MAX_CROP_BOXES), bool))
        if boxes_valid is None:
            raise ValueError("boxes_valid must accompany boxes "
                             "(use set_bounding_boxes to build both)")
        return np.asarray(boxes), np.asarray(boxes_valid)

    def _run(self, rgb: torch.Tensor, boxes, boxes_valid) -> ReportData:
        b, _, h, w = rgb.shape
        boxes, boxes_valid = self._norm_boxes(b, boxes, boxes_valid)
        tables = cached_tables(h, w, self.cfg, self.device)
        return full_report_batched(rgb, boxes, boxes_valid, tables, self.cfg)

    def run_u8(self, images_u8, boxes=None, boxes_valid=None) -> ReportData:
        """images_u8: (B, H, W, 3) uint8, numpy or a tensor; it travels to
        the device as uint8 and is made planar there."""
        x = torch.as_tensor(images_u8)
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected (B, H, W, 3) uint8, got "
                             f"{tuple(x.shape)} {x.dtype}")
        x = x.to(self.device, non_blocking=True)
        return self._run(x.permute(0, 3, 1, 2).contiguous(), boxes,
                         boxes_valid)

    def run(self, images, boxes: Optional[np.ndarray] = None,
            boxes_valid: Optional[np.ndarray] = None) -> ReportData:
        """images: (B, 3, H, W) float32 in [0, 1]; returns batched
        ReportData (B, ...) on the device."""
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        return self._run(x.contiguous(), boxes, boxes_valid)

    def _staged(self, batches):
        """(images_u8, boxes, valid) batches with the images copied to the
        device ahead of use: from pinned host memory on a side stream on
        CUDA, each with an event the compute stream waits on."""
        if self.device.type != "cuda":
            for images_u8, boxes, valid in batches:
                yield torch.as_tensor(images_u8), boxes, valid, None
            return
        side = torch.cuda.Stream(self.device)
        for images_u8, boxes, valid in batches:
            host = torch.as_tensor(images_u8).pin_memory()
            with torch.cuda.stream(side):
                x = host.to(self.device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(side)
            yield x, boxes, valid, ready

    def run_stream_u8(self, batches, prefetch: int = 0)\
            -> Iterator[ReportData]:
        """Reports for a stream of (images_u8, boxes, valid) batches.

        With ``prefetch`` > 0 a background thread copies up to that many
        batches to the device ahead of the compute (``_staged``); the
        results equal the sequential run's.  A consumer that stops early
        releases the thread (``utils.io.prefetch_iter``)."""
        if prefetch <= 0:
            for images_u8, boxes, valid in batches:
                yield self.run_u8(images_u8, boxes, valid)
            return
        from ..utils.io import prefetch_iter

        staged = prefetch_iter(self._staged(batches), prefetch)
        try:
            for x, boxes, valid, ready in staged:
                if ready is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(ready)
                    x.record_stream(compute)
                yield self.run_u8(x, boxes, valid)
        finally:
            staged.close()


def warmup(shapes: Sequence[Tuple[int, int]], cfg: ReportConfig,
           batch_size: int = 32, device="cuda") -> int:
    """Prepare each (H, W) shape before the first batch: build and cache
    its tables and FFT plan on the device, and on CUDA load (building if
    needed) the kernel library.  Runs no batch; nothing here depends on
    ``batch_size``, kept for the JAX package's signature.  Returns the
    number of shapes prepared."""
    del batch_size
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import _cuda
        _cuda.lib()
    for h, w in shapes:
        cached_tables(h, w, cfg, dev)
        if fft_kernel_eligible(h, w):
            FftPlan.for_shape(h, w, dev)
    return len(shapes)


def image_hw(img: np.ndarray) -> Tuple[int, int]:
    """Spatial shape of either a (3, H, W) float or (H, W, 3) uint8 image.

    The layout contract is enforced (a float (H, W, 3) image would
    otherwise flow through with transposed dims and produce a silently
    garbage report)."""
    if img.ndim != 3:
        raise ValueError(f"expected a 3-D image array, got {img.shape}")
    if img.dtype == np.uint8:
        if img.shape[-1] != 3:
            raise ValueError(f"uint8 images must be (H, W, 3), "
                             f"got {img.shape}")
        return img.shape[0], img.shape[1]
    if img.shape[0] != 3:
        raise ValueError(f"float images must be planar (3, H, W), "
                         f"got {img.shape} {img.dtype}")
    return img.shape[1], img.shape[2]


def _bucket_key(img: np.ndarray) -> Tuple[int, int, bool]:
    """Bucket images by (H, W, is_uint8): the two layouts stack into
    different array shapes, so they must never share a bucket."""
    h, w = image_hw(img)
    return h, w, img.dtype == np.uint8


def bucket_by_shape(items: Iterable[Tuple[object, np.ndarray]])\
        -> Dict[Tuple[int, int], List[Tuple[object, np.ndarray]]]:
    """Group (key, image) pairs by spatial shape."""
    buckets: Dict[Tuple[int, int], list] = collections.defaultdict(list)
    for key, img in items:
        buckets[image_hw(img)].append((key, img))
    return dict(buckets)


def run_corpus(images: Iterable[Tuple[object, np.ndarray]],
               cfg: ReportConfig, batch_size: int = 32, device="cuda")\
        -> Iterator[Tuple[object, ReportData]]:
    """Stream reports for a mixed-resolution corpus.

    Images, (H, W, 3) uint8 or (3, H, W) float, accumulate into per-shape
    buckets; a bucket runs as soon as it holds ``batch_size`` images, and
    the remainders at the end of the stream, padded with copies of their
    last image.  Memory stays O(number of shapes x batch_size).  Yields
    (key, per-image ReportData) for the real images only, as CPU tensors:
    each batch's reports are copied to the host once."""
    runner = BatchRunner(cfg, device)
    buckets: Dict[Tuple[int, int, bool], list] = collections.defaultdict(list)

    def flush(group):
        arr = np.stack([img for _, img in group])
        if len(group) < batch_size:
            arr = _pad_tail(arr, batch_size - len(group))
        if arr.dtype == np.uint8:
            out = runner.run_u8(arr)
        else:
            out = runner.run(arr.astype(np.float32))
        host = ReportData(*(x.cpu() for x in out))
        for j, (key, _) in enumerate(group):
            yield key, ReportData(*(x[j] for x in host))

    for key, img in images:
        bkey = _bucket_key(img)
        buckets[bkey].append((key, img))
        if len(buckets[bkey]) >= batch_size:
            yield from flush(buckets.pop(bkey))
    for group in buckets.values():
        yield from flush(group)
