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

from .config import MAX_CROP_BOXES, ReportConfig, check_image_dims
from .models.pipeline import (ReportData, ReportTables, cached_tables,
                              full_report, full_report_batched,
                              jitted_full_report, resolve_device)
from .models.staging import device_batch, host_batch
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
            # A C-contiguous uint8 frame is staged whole (RGBA too: one block
            # copy, not a 16-18 ms strided RGB view); the card drops alpha.
            frame = (arr if arr.flags.c_contiguous else arr[:, :, :3]) if u8 \
                else np.moveaxis(arr[:, :, :3], -1, 0)
            host = host_batch([frame], 1, dev)
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
        if u8:
            _cuda.LAUNCHES["entry_hwc"] += 1
        data = full_report(device_batch(host, dev)[0], box_arr, valid,
                           tables, cfg)
        return Report(data, height, width, num_boxes=int(valid.sum()),
                      config=cfg)
