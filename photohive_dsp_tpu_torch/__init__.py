"""photohive_dsp_tpu_torch — the PhotoHive photo report in PyTorch, with the
colour palette's kernels written in CUDA for NVIDIA Hopper (sm_90a).

A port of ``photohive_dsp_tpu`` (JAX), which stays the reference: the same
public API, module names and results.  This package imports torch and
numpy and never jax.

Public API:
    get_report(image, boxes=None, *, config=None, device="cuda", **knobs)
    set_bounding_boxes(list_of_dicts) -> crop-box arrays
    ReportConfig, Report, ReportData, ReportTables, full_report_batched
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .config import MAX_CROP_BOXES, ReportConfig, check_image_dims
from .models.pipeline import ReportData, ReportTables, full_report_batched
from .report import Report

__version__ = "0.1.0"

__all__ = [
    "ReportConfig", "Report", "ReportData", "ReportTables",
    "full_report_batched", "get_report", "set_bounding_boxes",
    "__version__",
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


def _image_to_planar(image) -> np.ndarray:
    """PIL image or HxWx3 uint8/float array -> (3, H, W) uint8 or float32."""
    arr = np.asarray(image)
    if arr.ndim != 3 or arr.shape[2] < 3:
        raise ValueError("expected an RGB image (H, W, 3)")
    arr = arr[:, :, :3]
    if arr.dtype != np.uint8:
        arr = arr.astype(np.float32)
    return np.ascontiguousarray(np.moveaxis(arr, -1, 0))


def _resolve_device(device) -> torch.device:
    """The torch device to compute on; raises if CUDA is asked for and is
    not there (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    return dev


def get_report(image, boxes=None, *, config: Optional[ReportConfig] = None,
               device="cuda", **knobs) -> Optional[Report]:
    """Compute the full photo report for one image.

    ``image`` is a PIL image or an (H, W, 3) array, uint8 or float in
    [0, 1].  ``boxes`` is the output of set_bounding_boxes (or None).
    Extra keyword arguments are ReportConfig fields (h_partitions=18, ...),
    mirroring the reference get_report signature (core.py:442-448).

    Returns None (with a message) on invalid input, like the reference's
    NULL-report path (core.py:476-478, src/utilities.c:64-87)."""
    dev = _resolve_device(device)
    cfg = config if config is not None else ReportConfig(**knobs)
    cfg.validate()
    planar = _image_to_planar(image)
    _, height, width = planar.shape
    ok, msg = check_image_dims(height, width)
    if not ok:
        print(f"Failed to get report data: {msg}")
        return None

    if boxes is None:
        box_arr = np.zeros((MAX_CROP_BOXES, 4), np.int32)
        valid = np.zeros((MAX_CROP_BOXES,), bool)
    else:
        box_arr, valid = boxes
    tables = _tables(height, width, cfg, dev)
    # uint8 frames travel to the device as uint8 (4x fewer bytes); the
    # pipeline decodes them exactly.
    rgb = torch.from_numpy(planar)[None].to(dev)
    data = full_report_batched(rgb, np.asarray(box_arr)[None],
                               np.asarray(valid)[None], tables, cfg)
    data = ReportData(*(x[0] for x in data))
    return Report(data, height, width, num_boxes=int(np.sum(valid)),
                  config=cfg)


@functools.lru_cache(maxsize=16)
def _tables(height: int, width: int, cfg: ReportConfig,
            device: torch.device) -> ReportTables:
    """ReportTables per (shape, config, device), built once."""
    return ReportTables.build(height, width, cfg, device)
