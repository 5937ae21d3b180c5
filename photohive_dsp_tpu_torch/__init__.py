"""photohive_dsp_tpu_torch — the PhotoHive photo report in PyTorch, with the
colour palette's kernels written in CUDA for NVIDIA Hopper (sm_90a).

A port of ``photohive_dsp_tpu`` (JAX), which stays the reference: the same
public API, module names and results.  This package imports torch and
numpy and never jax.

Public API:
    get_report(image, salient_characters=None, *, config=None,
               device="cuda", **knobs)
    set_bounding_boxes(list_of_dicts) -> crop-box arrays
    ReportConfig, Report, ReportData, ReportTables, full_report (one
    image), full_report_batched, crop_image, crop_pgm

The batch and corpus layer: ``models.batch`` (BatchRunner, warmup,
run_corpus) and ``utils.io`` (process_corpus, image IO).  Across process
groups: ``parallel.mesh`` (initialize_distributed, make_mesh),
``parallel.sharding`` (data-parallel) and ``parallel.spatial`` (row-
sharded, and dp x spatial), which the batch layer and ``serving`` take as
their ``mesh``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .config import MAX_CROP_BOXES, ReportConfig, check_image_dims
from .models.pipeline import (ReportData, ReportTables, cached_tables,
                              full_report, full_report_batched,
                              jitted_full_report, resolve_device)
from .ops import _cuda
from .ops.colorspace import crop_image, crop_pgm
from .report import Report
from .utils.profiling import span

__version__ = "0.1.0"

__all__ = [
    "ReportConfig", "Report", "ReportData", "ReportTables", "full_report",
    "full_report_batched", "get_report", "set_bounding_boxes", "crop_image",
    "crop_pgm", "__version__",
]


def set_bounding_boxes(bounding_boxes: Sequence[dict])\
        -> Tuple[np.ndarray, np.ndarray]:
    """Build the fixed-shape crop-box arrays.

    Same input contract as the reference set_bounding_boxes (core.py:489-515):
    a list of dicts with 'top', 'bottom', 'left', 'right'; at most
    MAX_CROP_BOXES boxes.  Returns (boxes (10, 4) int32, valid (10,) bool).
    """
    n = len(bounding_boxes)
    if n > MAX_CROP_BOXES:
        raise ValueError(f"at most {MAX_CROP_BOXES} bounding boxes supported")
    boxes = np.zeros((MAX_CROP_BOXES, 4), np.int32)
    valid = np.zeros((MAX_CROP_BOXES,), bool)
    for i, bb in enumerate(bounding_boxes):
        boxes[i] = (bb["top"], bb["bottom"], bb["left"], bb["right"])
        valid[i] = True
    return boxes, valid


def _image_array(image) -> np.ndarray:
    """PIL image or (H, W, C >= 3) array -> the array as it comes (RGB or
    RGBA, possibly strided or flipped)."""
    arr = np.asarray(image)
    if arr.ndim != 3 or arr.shape[2] < 3:
        raise ValueError("expected an RGB image (H, W, 3)")
    return arr


def _stage_u8(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint8 frame copied once into an (H, W, C) host tensor: the whole
    frame where it is C-contiguous (an RGBA frame's alpha goes too, and is
    dropped on the device), else its RGB view.  For a CUDA ``device`` the
    tensor is page-locked, from the caching host allocator, so its copy to
    the card is a DMA the host need not wait for; the allocator hands the
    same block back request after request, once the event that the
    non-blocking copy in ``get_report`` records on it has completed: that
    event guards the reuse.

    ``np.copyto`` fills it on the calling thread, from any strides, a
    read-only array (a PIL image's) included.  ``Tensor.copy_`` splits
    the fill over all intra-op threads: on a quiet 8-core H100 host 0.3 ms
    against 0.9-1.4 ms for a 1080p frame, but with other load on the
    cores it waits for its slowest thread (p95 7-8 ms against 1.6-2.0)."""
    src = arr if arr.flags.c_contiguous else arr[:, :, :3]
    host = torch.empty(src.shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    np.copyto(host.numpy(), src)
    return host


def get_report(image, salient_characters=None, *,
               config: Optional[ReportConfig] = None, device="cuda",
               **knobs) -> Optional[Report]:
    """Compute the full photo report for one image.

    ``image`` is a PIL image or an (H, W, 3) array, uint8 or float in
    [0, 1].  ``salient_characters`` is the output of set_bounding_boxes (or
    None), the reference's name for the crop boxes.
    Extra keyword arguments are ReportConfig fields (h_partitions=18, ...),
    mirroring the reference get_report signature (core.py:442-448).

    Returns None (with a message) on invalid input, like the reference's
    NULL-report path (core.py:476-478, src/utilities.c:64-87)."""
    with span("photohive.get_report"):
        dev = resolve_device(device)
        cfg = config if config is not None else ReportConfig(**knobs)
        cfg.validate()
        with span("photohive.entry.planar"):
            arr = _image_array(image)
            u8 = arr.dtype == np.uint8
            # uint8 frames travel as uint8 (4x fewer bytes than float32)
            # and are made planar on the device, not by a strided host
            # transpose; the pipeline decodes them exactly.
            host = _stage_u8(arr, dev) if u8 else torch.from_numpy(
                np.ascontiguousarray(np.moveaxis(
                    arr[:, :, :3].astype(np.float32), -1, 0)))
            if salient_characters is None:
                box_arr = np.zeros((MAX_CROP_BOXES, 4), np.int32)
                valid = np.zeros((MAX_CROP_BOXES,), bool)
            else:
                box_arr, valid = (np.asarray(a) for a in salient_characters)
        height, width = arr.shape[:2]
        ok, msg = check_image_dims(height, width)
        if not ok:
            print(f"Failed to get report data: {msg}")
            return None

        tables = cached_tables(height, width, cfg, dev)
        with span("photohive.h2d"):
            rgb = host.to(dev, non_blocking=True)
            if u8:
                _cuda.LAUNCHES["entry_hwc"] += 1
                rgb = rgb[:, :, :3].permute(2, 0, 1).contiguous()
        data = full_report(rgb, box_arr, valid, tables, cfg)
        return Report(data, height, width, num_boxes=int(valid.sum()),
                      config=cfg)
