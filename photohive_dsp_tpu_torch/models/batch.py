"""Batched, bucketed report execution (counterpart of
``photohive_dsp_tpu/models/batch.py``).

The reference processes one image per call (src/interface.c:20); the
throughput comes from running same-shape images as one batch through
``full_report_batched``.  Mixed-resolution corpora are grouped into shape
buckets, and a bucket's partial batch is padded up to the batch size with
copies of its last image, whose reports are dropped.  A batch of host
frames is staged by ``staging.host_batch`` and sent by
``staging.device_batch``, or on the row-sharded route by each rank's copy
of its own rows (``parallel.spatial``).  PyTorch runs eagerly, so there is
no compiled program to cache: what is built once per (H, W, config,
device) is the tables (``pipeline.cached_tables``) and the FFT plan
(``FftPlan.for_shape``).  The palette route follows
``PHOTOHIVE_PALETTE_KERNEL``, read at each batch.

With a mesh (``parallel.mesh.make_mesh``: process groups, one process per
rank, every rank running the same calls on the same inputs) a batch is
split over all ranks as one data axis (``parallel.sharding``), and images
of ``spatial_route_mp`` megapixels or more, when the mesh has a spatial
axis, run row-sharded over it with the batch over its data axis
(``parallel.spatial.build_dp_spatial_report``).  Every rank gets every
report.
"""

from __future__ import annotations

import collections
import functools
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MAX_CROP_BOXES, ReportConfig
from ..ops.fft_plan import FftPlan, fft_kernel_eligible
from ..utils.profiling import span
from .pipeline import (ReportData, cached_tables, full_report_batched,
                       resolve_device)
from .staging import device_batch, host_batch


def _pad_tail(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` copies of the last batch row."""
    return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])


# Images at or above this many megapixels route to the row-sharded path
# when the mesh has a spatial axis: small images replicate over ``data``,
# 4K-class and larger ones shard over ``spatial``, so each rank holds 1/n
# of their rows.
SPATIAL_ROUTE_MP = float(os.environ.get("PHOTOHIVE_SPATIAL_MP", "8.0"))


@functools.lru_cache(maxsize=4)
def _dp_spatial_u8_fn(mesh, batch: int, height: int, width: int,
                      cfg: ReportConfig, device: torch.device):
    """fn(u8 (B, H, W, 3), boxes, valid) -> ReportData on the dp x
    spatial body (float32 frames in [0, 1] too); each rank moves only its
    own rows to ``device``, and the tables are built once per mesh and
    shape."""
    from ..parallel.spatial import build_dp_spatial_report

    run = build_dp_spatial_report(mesh, batch, height, width, cfg, device)

    def fn(u8, boxes, valid):
        return run(torch.as_tensor(u8).permute(0, 3, 1, 2), boxes, valid)

    return fn


class BatchRunner:
    """Runs same-shape image batches through ``full_report_batched`` on
    ``device`` ("cuda" by default; raises when CUDA is missing).

    With a ``mesh`` each rank runs its share of every batch and returns the
    whole batch's reports: batches are padded to a multiple of all the
    mesh's ranks (one data axis, ``sharding.flat_data_mesh``), and, on
    meshes with a spatial axis, images of at least ``spatial_route_mp``
    megapixels run row-sharded (rows over ``spatial`` x batch over
    ``data``), padded to a multiple of the data axis instead."""

    def __init__(self, cfg: ReportConfig, mesh=None,
                 spatial_route_mp: float = SPATIAL_ROUTE_MP, device="cuda"):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.spatial_route_mp = spatial_route_mp
        if mesh is not None:
            from ..parallel.sharding import flat_data_mesh
            # Small images fold the spatial axis into data (all ranks
            # data-parallel); only the spatial route uses the 2-D mesh.
            self._flat_mesh = flat_data_mesh(mesh)

    def routes_spatially(self, height: int, width: int) -> bool:
        """True when (height, width) images run on the row-sharded path."""
        return bool(self.mesh is not None and self.mesh.spatial > 1
                    and height * width >= self.spatial_route_mp * 1e6)

    def quantum(self, height: int, width: int) -> int:
        """The batch multiple (height, width) images run at: the mesh's
        data axis on the row-sharded path, all its ranks on the
        data-parallel one, 1 without a mesh."""
        if self.mesh is None:
            return 1
        if self.routes_spatially(height, width):
            return self.mesh.data
        return self._flat_mesh.data

    def _norm_boxes(self, b, boxes, boxes_valid):
        if boxes is None:
            return (torch.zeros((b, MAX_CROP_BOXES, 4), dtype=torch.int32),
                    torch.zeros((b, MAX_CROP_BOXES), dtype=torch.bool))
        if boxes_valid is None:
            raise ValueError("boxes_valid must accompany boxes "
                             "(use set_bounding_boxes to build both)")
        return torch.as_tensor(boxes), torch.as_tensor(boxes_valid)

    def _run(self, x: torch.Tensor, boxes, boxes_valid) -> ReportData:
        """x: the whole batch, (B, H, W, 3) uint8 or (B, 3, H, W) float32,
        on the host or the device."""
        b = x.shape[0]
        u8 = x.dtype == torch.uint8
        h, w = x.shape[1:3] if u8 else x.shape[2:]
        boxes, boxes_valid = self._norm_boxes(b, boxes, boxes_valid)
        if self.mesh is None:
            tables = cached_tables(h, w, self.cfg, self.device)
            return full_report_batched(device_batch(x, self.device), boxes,
                                       boxes_valid, tables, self.cfg)
        pad = (-b) % self.quantum(h, w)
        if pad:
            x, boxes, boxes_valid = (_pad_tail(t, pad)
                                     for t in (x, boxes, boxes_valid))
        if self.routes_spatially(h, w):
            out = _dp_spatial_u8_fn(self.mesh, b + pad, h, w, self.cfg,
                                    self.device)(
                x if u8 else x.permute(0, 2, 3, 1), boxes, boxes_valid)
        else:
            from ..parallel.sharding import data_parallel_report
            fn, tables = data_parallel_report(h, w, self.cfg,
                                              self._flat_mesh, self.device)
            out = fn(x, boxes, boxes_valid, tables)
        return ReportData(*(t[:b] for t in out)) if pad else out

    def run_u8(self, images_u8, boxes=None, boxes_valid=None) -> ReportData:
        """images_u8: (B, H, W, 3) uint8, a tensor or host frames of any
        strides (staged by ``host_batch``); it travels to the device as
        uint8 and is made planar there."""
        x = images_u8 if isinstance(images_u8, torch.Tensor) \
            else host_batch(images_u8, len(images_u8), self.device)
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected (B, H, W, 3) uint8, got "
                             f"{tuple(x.shape)} {x.dtype}")
        return self._run(x, boxes, boxes_valid)

    def run(self, images, boxes: Optional[np.ndarray] = None,
            boxes_valid: Optional[np.ndarray] = None) -> ReportData:
        """images: (B, 3, H, W) float32 in [0, 1]; returns batched
        ReportData (B, ...) on the device."""
        return self._run(torch.as_tensor(images, dtype=torch.float32),
                         boxes, boxes_valid)

    def _staged(self, batches):
        """(images_u8, boxes, valid) batches with the images copied to the
        device ahead of use: from a ``host_batch`` on a side stream on
        CUDA, each with an event the compute stream waits on."""
        if self.device.type != "cuda":
            for images_u8, boxes, valid in batches:
                yield images_u8, boxes, valid, None
            return
        side = torch.cuda.Stream(self.device)
        for images_u8, boxes, valid in batches:
            with span("photohive.h2d"):
                host = host_batch(images_u8, len(images_u8), self.device)
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
           mesh=None, batch_size: int = 32, device="cuda") -> int:
    """Prepare each (H, W) shape before the first batch: build and cache
    its tables and FFT plan on the device, and on CUDA load (building if
    needed) the kernel library.  Runs no batch; nothing here depends on
    ``batch_size``, kept for the JAX package's signature.  Shapes that
    ``mesh`` routes row-sharded are skipped, as the JAX package skips them
    (their tables depend on the batch and the mesh; they are built at
    first use).  Returns the number of shapes prepared."""
    del batch_size
    runner = BatchRunner(cfg, mesh=mesh, device=device)
    if runner.device.type == "cuda":
        from ..ops import _cuda
        _cuda.lib()
    n = 0
    for h, w in shapes:
        if runner.routes_spatially(h, w):
            continue
        cached_tables(h, w, cfg, runner.device)
        if fft_kernel_eligible(h, w):
            FftPlan.for_shape(h, w, runner.device)
        n += 1
    return n


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
               cfg: ReportConfig, mesh=None, batch_size: int = 32,
               spatial_route_mp: float = SPATIAL_ROUTE_MP, device="cuda")\
        -> Iterator[Tuple[object, ReportData]]:
    """Stream reports for a mixed-resolution corpus.

    Images, (H, W, 3) uint8 or (3, H, W) float, accumulate into per-shape
    buckets; a bucket runs as soon as it holds ``batch_size`` images, and
    the remainders at the end of the stream, padded with copies of their
    last image.  Memory stays O(number of shapes x batch_size).  A batch
    is staged by ``staging.host_batch`` and sent from there.  Yields
    (key, per-image ReportData) for the real images only, as CPU tensors:
    each batch's reports are copied to the host once.  With a ``mesh``
    every rank streams the same images and gets every report; images of
    ``spatial_route_mp`` MP or more run row-sharded on meshes with a
    spatial axis (see BatchRunner), in batches of the mesh's data axis."""
    runner = BatchRunner(cfg, mesh=mesh, spatial_route_mp=spatial_route_mp,
                         device=device)
    buckets: Dict[Tuple[int, int, bool], list] = collections.defaultdict(list)

    def quantum(bkey) -> int:
        # Row-sharded shapes run in batches of the data axis, not
        # batch_size: a batch_size-wide batch of 8+ MP images would hold
        # gigabytes of host frames and of per-image intermediates at once,
        # and the rows already supply the parallelism.
        h, w = bkey[:2]
        return runner.quantum(h, w) if runner.routes_spatially(h, w) \
            else batch_size

    def flush(group, size):
        with span("photohive.corpus.stack"):
            staged = host_batch([img for _, img in group], size,
                                runner.device)
        out = runner.run_u8(staged) if staged.dtype == torch.uint8 \
            else runner.run(staged)
        with span("photohive.d2h"):
            host = ReportData(*(x.cpu() for x in out))
        # Split before yielding: a span must not hold the consumer's time.
        with span("photohive.corpus.split"):
            rows = [(key, ReportData(*(x[j] for x in host)))
                    for j, (key, _) in enumerate(group)]
        yield from rows

    for key, img in images:
        bkey = _bucket_key(img)
        buckets[bkey].append((key, img))
        if len(buckets[bkey]) >= quantum(bkey):
            yield from flush(buckets.pop(bkey), quantum(bkey))
    for bkey, group in buckets.items():
        yield from flush(group, quantum(bkey))
