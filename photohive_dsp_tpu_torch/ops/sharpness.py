"""Laplacian-variance sharpness over salient-character crop boxes
(counterpart of ``photohive_dsp_tpu/ops/sharpness.py``).

reference: src/filtering.c:151-183 — for each crop box, crop the grayscale
image, run the zero-padded 3x3 Laplacian over the *crop*, and report
variance(response)/mean(response).

The routes of the JAX package's ``variance_sharpness_batched``, picked on
the host from the boxes alone: no work at all when no box is valid; the
masked crop-then-filter form, plain PyTorch, when any valid box is thinner
than TINY_BOX_PX (the masked route); otherwise the crop-box sums of K5
(ops/sharpness_kernels.py, the JAX package's Pallas route) and
``finish_sharpness``.
"""

from __future__ import annotations

import numpy as np
import torch

from .filtering import laplacian_3x3
from .sharpness_kernels import box_tensor, sharpness_sums

# Boxes under this many px in either dimension take the masked route: the
# kernel route's s2/n - mean^2 cancels terms ~1e3 larger than a tiny crop's
# variance, leaving ~1e-6 absolute f32 cancellation noise.
TINY_BOX_PX = 4


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


def finish_sharpness(s1, s2, boxes: np.ndarray,
                     boxes_valid: np.ndarray) -> torch.Tensor:
    """K5's sums -> (B, K) float32 variance / mean, zero in invalid slots:
    mean = s1/n and var = s2/n - mean^2 in float32, as the JAX package
    finishes its kernel's sums."""
    dev = s1.device
    boxes = torch.as_tensor(boxes, device=dev)
    n = torch.clamp((boxes[..., 1] - boxes[..., 0])
                    * (boxes[..., 3] - boxes[..., 2]), min=1).float()
    mean = s1.float() / n
    var = s2.float() / n - mean * mean
    # Unguarded division like the reference (src/filtering.c:174).
    return torch.where(torch.as_tensor(boxes_valid, device=dev), var / mean,
                       torch.zeros_like(mean))


def variance_sharpness_batched(pgm: torch.Tensor, boxes,
                               boxes_valid) -> torch.Tensor:
    """Sharpness per crop box: (B, H, W) x (B, K, 4) x (B, K) -> (B, K)
    float32, zero in invalid slots.

    pgm is the full-resolution luma before DC removal (the reference
    computes sharpness before remove_dc_bias, src/interface.c:73 vs :79).
    ``boxes`` ([top, bottom, left, right), int) and ``boxes_valid`` (bool)
    are host arrays (numpy, or CPU tensors): the route is picked from them
    without reading the device."""
    boxes = np.asarray(boxes, np.int64)
    boxes_valid = np.asarray(boxes_valid, bool)
    if not boxes_valid.any():
        return torch.zeros(boxes_valid.shape, dtype=pgm.dtype,
                           device=pgm.device)
    if thin_boxes(boxes, boxes_valid).any():
        return _masked_sharpness(pgm, torch.as_tensor(boxes, device=pgm.device),
                                 torch.as_tensor(boxes_valid,
                                                 device=pgm.device))
    s1, s2 = sharpness_sums(pgm.contiguous(),
                            box_tensor(boxes, boxes_valid, pgm.device))
    return finish_sharpness(s1, s2, boxes, boxes_valid)


def thin_boxes(boxes: np.ndarray, boxes_valid: np.ndarray) -> np.ndarray:
    """Valid boxes under TINY_BOX_PX in either dimension."""
    return boxes_valid & ((boxes[..., 1] - boxes[..., 0] < TINY_BOX_PX)
                          | (boxes[..., 3] - boxes[..., 2] < TINY_BOX_PX))
