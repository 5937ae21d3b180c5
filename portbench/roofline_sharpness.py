"""The least time the chip could take for one image's crop-box sharpness
on the masked route (``photohive::masked_sharpness``), from the crops the
work was done on, in ``portbench.roofline``'s terms: each crop of the
float32 luma read once and each box's sharpness written once, or the
crop's float32 operations, whichever bound is larger.  It counts what the
crops need, so it reads the same whatever implements the operator."""

from __future__ import annotations

from typing import Sequence

from . import roofline
from .run import box_dicts

# float32 operations a crop pixel needs (chip_smoke.OPS_SHARP_PX: the
# masked 3x3 Laplacian, its square and sum, the ring weight, its product
# and sum).
OPS_SHARP_PX = 20


def crop_px(box: dict, height: int, width: int) -> int:
    """Pixels of the frame inside ``box`` ([top, bottom) x [left, right))."""
    rows = min(box["bottom"], height) - max(box["top"], 0)
    cols = min(box["right"], width) - max(box["left"], 0)
    return max(rows, 0) * max(cols, 0)


def masked_sharpness_s(spec: Sequence, height: int, width: int) -> float:
    """One image of ``height`` x ``width`` with the configuration's boxes
    (``spec``, as ``run.box_dicts`` reads them): 4 bytes a crop pixel
    read, 4 bytes a box written, OPS_SHARP_PX a crop pixel."""
    areas = [crop_px(b, height, width) for b in box_dicts(spec, height,
                                                          width)]
    return roofline.bound_s(4 * sum(areas) + 4 * len(areas),
                            OPS_SHARP_PX * sum(areas))
