"""K5: crop-box sharpness sums, and their plain version (counterpart of
``photohive_dsp_tpu/ops/pallas_sharpness.sharpness_sums``).

For each image and each of its MAX_CROP_BOXES slots [top, bottom, left,
right), the sums the caller turns into the crop's Laplacian variance over
mean (ops/sharpness.finish_sharpness):

    s1 = sum over the box of pgm * (9 - rows_in * cols_in), the telescoped
         ring weights (ops/sharpness._ring_weight_map);
    s2 = sum over the box of the squared zero-padded 3x3 Laplacian of the
         masked crop.

Box rows are global: the rows handed in are rows ``row_offset`` onwards of
a taller image, and ``halo`` (B, 2, W) holds the rows just above and below
them (zeros at the image's edges), so per-rank sums of a row-sharded image
add up to the whole image's.  Empty slots are all zero.

Both versions evaluate every pixel's stencil in the JAX kernel's float32
operation order and return float64 sums: the kernel (csrc/sharpness.cu)
adds pixels in float32 per thread and combines in float64 in a fixed order,
the plain version adds the same float32 values in float64, so the two
differ only by the kernel's float32 partial sums.  The wrapper launches the
kernel for CUDA tensors and takes the plain version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MAX_CROP_BOXES
from . import _cuda

# csrc/sharpness.cu's tile (kTileRows x kTileCols).
TILE_ROWS = 32
TILE_COLS = 128


def _check(pgm, boxes, halo) -> None:
    _cuda.require(pgm, "pgm", (torch.float32,), 3)
    _cuda.require(boxes, "boxes", (torch.int32,), 3)
    b, _, w = pgm.shape
    if tuple(boxes.shape) != (b, MAX_CROP_BOXES, 4):
        raise ValueError(f"boxes: expected {(b, MAX_CROP_BOXES, 4)}, got "
                         f"{tuple(boxes.shape)}")
    tensors = [boxes]
    if halo is not None:
        _cuda.require(halo, "halo", (torch.float32,), 3)
        if tuple(halo.shape) != (b, 2, w):
            raise ValueError(f"halo: expected {(b, 2, w)}, got "
                             f"{tuple(halo.shape)}")
        tensors.append(halo)
    for t in tensors:
        if t.device != pgm.device:
            raise ValueError(f"{t.device} tensor beside pgm on {pgm.device}")


def box_crops(pgm, boxes, halo=None, row_offset: int = 0):
    """For each (image, slot) whose box meets the rows handed in, yield
    (i, k, xc, resp, wgt): the box's pixels on these rows (rows, cols)
    float32, their masked-crop Laplacian response and their ring weights
    9 - rows_in * cols_in, in the kernel's operation order."""
    b, h, w = pgm.shape
    if halo is None:
        halo = pgm.new_zeros((b, 2, w))
    # Row y of the rows handed in is row y + 1 here; columns padded by 1.
    ext = F.pad(torch.cat([halo[:, :1], pgm, halo[:, 1:]], dim=1), (1, 1))
    for i, per_image in enumerate(boxes.tolist()):
        for k, (top, bottom, left, right) in enumerate(per_image):
            y0, y1 = max(top - row_offset, 0), min(bottom - row_offset, h)
            x0, x1 = max(left, 0), min(right, w)
            if y0 >= y1 or x0 >= x1:
                continue
            gy = torch.arange(y0 - 1, y1 + 1, device=pgm.device) + row_offset
            gx = torch.arange(x0 - 1, x1 + 1, device=pgm.device)
            row_in = (gy >= top) & (gy < bottom)
            col_in = (gx >= left) & (gx < right)
            m = ext[i, y0:y1 + 2, x0:x1 + 2] * (row_in[:, None]
                                                 & col_in[None, :])
            trip = (m[:, :-2] + m[:, 1:-1]) + m[:, 2:]
            box3 = (trip[:-2] + trip[1:-1]) + trip[2:]
            xc = m[1:-1, 1:-1]
            resp = 9.0 * xc - box3
            rows_in = (row_in[:-2].float() + 1.0) + row_in[2:].float()
            cols_in = (col_in[:-2].float() + 1.0) + col_in[2:].float()
            wgt = 9.0 - rows_in[:, None] * cols_in[None, :]
            yield i, k, xc, resp, wgt


def sharpness_sums_plain(pgm, boxes, halo=None, row_offset: int = 0):
    """Plain version of K5: (s1, s2), each (B, MAX_CROP_BOXES) float64."""
    out = torch.zeros((pgm.shape[0], MAX_CROP_BOXES, 2), dtype=torch.float64,
                      device=pgm.device)
    for i, k, xc, resp, wgt in box_crops(pgm, boxes, halo, row_offset):
        out[i, k, 0] = (xc * wgt).double().sum()
        out[i, k, 1] = (resp * resp).double().sum()
    return out[..., 0], out[..., 1]


def sharpness_sums(pgm, boxes, halo=None, row_offset: int = 0):
    """K5: (B, H, W) float32 luma and (B, 10, 4) int32 boxes (empty slots
    zero) -> (s1, s2), each (B, 10) float64."""
    _check(pgm, boxes, halo)
    if pgm.device.type == "cpu":
        return sharpness_sums_plain(pgm, boxes, halo, row_offset)
    b, h, w = pgm.shape
    tiles = ((h + TILE_ROWS - 1) // TILE_ROWS) * ((w + TILE_COLS - 1)
                                                  // TILE_COLS)
    partial = torch.empty((b, tiles, MAX_CROP_BOXES, 2), dtype=torch.float64,
                          device=pgm.device)
    sums = torch.empty((b, MAX_CROP_BOXES, 2), dtype=torch.float64,
                       device=pgm.device)
    _cuda.launch("ph_sharpness_sums", pgm, _cuda.ptr(pgm), _cuda.ptr(halo), b,
                 h, w, row_offset, _cuda.ptr(boxes), _cuda.ptr(partial),
                 _cuda.ptr(sums))
    _cuda.LAUNCHES["sharpness_sums"] += 1
    return sums[..., 0], sums[..., 1]


def box_tensor(boxes, boxes_valid, device) -> torch.Tensor:
    """Host (B, K, 4) boxes and (B, K) validity -> K5's (B, K, 4) int32
    boxes on ``device``, invalid slots zeroed."""
    boxes = np.where(np.asarray(boxes_valid, bool)[..., None],
                     np.asarray(boxes), 0).astype(np.int32)
    return torch.as_tensor(boxes, device=device)
