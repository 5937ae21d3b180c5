"""Laplacian-variance sharpness over salient-character crop boxes
(counterpart of ``photohive_dsp_tpu/ops/sharpness.py``).

reference: src/filtering.c:151-183 — for each crop box, crop the grayscale
image, run the zero-padded 3x3 Laplacian over the *crop*, and report
variance(response)/mean(response).

This is the JAX package's route off the TPU (``variance_sharpness_batched``
with its Pallas kernel off): one shared Laplacian per image with per-box sums
and exact ring corrections (the fast route), the masked crop-then-filter
form when any valid box is thinner than TINY_BOX_PX (the masked route), and
no work at all when no box is valid.  The box sums are float32 batched
matrix products: they need ``torch.backends.cuda.matmul.allow_tf32`` False,
PyTorch's default, to stay in full float32 (the JAX package uses
Precision.HIGHEST).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .filtering import laplacian_3x3

# Boxes under this many px in either dimension take the masked route: the
# fast route assembles the crop's sum(resp^2) from terms ~1e3 larger than
# a tiny crop's variance, leaving ~1e-6 absolute f32 cancellation noise.
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


def _box_ring_terms(pgm_pad, resp, boxes):
    """Ring correction per box, batched: sum over the crop's border ring of
    2*r*c + c^2, the difference between the crop's sum(resp^2) and the
    shared response's (see the JAX package's ``_box_ring_terms``).  Index
    clamping reproduces ``lax.dynamic_slice``'s."""
    bsz, h, w = resp.shape
    dev = resp.device
    t, b, l, r = (boxes[..., i] for i in range(4))           # (B, K)
    bi = torch.arange(bsz, device=dev)[:, None]
    xs = torch.arange(w, device=dev)
    ys = torch.arange(h, device=dev)

    def clamp(i, hi):
        return torch.clamp(i, 0, hi)

    # Vertical: pixels in rows t and b-1; outside neighbours are rows t-1
    # and b (padded coordinates shift by +1; image edges read zeros).
    row_above = pgm_pad[bi, clamp(t, h + 1)]                  # (B, K, W+2)
    row_below = pgm_pad[bi, clamp(b + 1, h + 1)]
    cv_t = row_above[..., :-2] + row_above[..., 1:-1] + row_above[..., 2:]
    cv_b = row_below[..., :-2] + row_below[..., 1:-1] + row_below[..., 2:]
    resp_t = resp[bi, clamp(t, h - 1)]                        # (B, K, W)
    resp_b = resp[bi, clamp(torch.clamp(b - 1, min=0), h - 1)]
    xin = (xs >= l[..., None]) & (xs < r[..., None])
    sum_v = torch.where(
        xin, 2.0 * (resp_t * cv_t + resp_b * cv_b) + cv_t * cv_t
        + cv_b * cv_b, 0.0).sum(dim=-1)

    # Horizontal: pixels in columns l and r-1; outside neighbours are the
    # columns l-1 and r restricted to rows inside the box.
    pad_t = F.pad(resp, (1, 1, 1, 1)).transpose(1, 2)         # (B, W+2, H+2)
    pgm_t = pgm_pad.transpose(1, 2)
    col_left = pgm_t[bi, clamp(l, w + 1)]                     # (B, K, H+2)
    col_right = pgm_t[bi, clamp(r + 1, w + 1)]

    def ch_of(col):
        # ch(y) = col[y-1]*[y-1>=t] + col[y] + col[y+1]*[y+1<b], y in [t,b)
        mid = col[..., 1:-1]
        up = torch.where(ys - 1 >= t[..., None], col[..., :-2], 0.0)
        dn = torch.where(ys + 1 < b[..., None], col[..., 2:], 0.0)
        return up + mid + dn                                  # (B, K, H)

    ch_l = ch_of(col_left)
    ch_r = ch_of(col_right)
    resp_l = pad_t[bi, clamp(l + 1, w + 1)][..., 1:h + 1]
    resp_r = pad_t[bi, clamp(torch.clamp(r, min=1), w + 1)][..., 1:h + 1]
    yin = (ys >= t[..., None]) & (ys < b[..., None])
    sum_h = torch.where(
        yin, 2.0 * (resp_l * ch_l + resp_r * ch_r) + ch_l * ch_l
        + ch_r * ch_r, 0.0).sum(dim=-1)

    # Corner cross terms 2*cV*cH at the four ring intersections.
    def at(vec, i):
        i = clamp(torch.clamp(i, min=0), vec.shape[-1] - 1)
        return torch.gather(vec, -1, i[..., None])[..., 0]

    cross = 2.0 * (at(cv_t, l) * at(ch_l, t) + at(cv_t, r - 1) * at(ch_r, t)
                   + at(cv_b, l) * at(ch_l, b - 1)
                   + at(cv_b, r - 1) * at(ch_r, b - 1))
    return sum_v + sum_h + cross


def _fast_sharpness(pgm, boxes, boxes_valid):
    """Shared-response route: (B, H, W) -> (B, K)."""
    bsz, h, w = pgm.shape
    dev = pgm.device
    resp = laplacian_3x3(pgm)
    resp2 = resp * resp
    t, b = boxes[..., 0, None], boxes[..., 1, None]           # (B, K, 1)
    l, r = boxes[..., 2, None], boxes[..., 3, None]
    hidx = torch.arange(h, device=dev)
    widx = torch.arange(w, device=dev)
    rm = ((hidx >= t) & (hidx < b)).to(pgm.dtype)             # (B, K, H)
    cm = ((widx >= l) & (widx < r)).to(pgm.dtype)             # (B, K, W)

    def boxsum(a, row_mask, col_mask):
        per_row = torch.bmm(a, col_mask.transpose(1, 2))      # (B, H, K)
        return (per_row.transpose(1, 2) * row_mask).sum(dim=-1)

    pgm_pad = F.pad(pgm, (1, 1, 1, 1))
    s2 = boxsum(resp2, rm, cm) + _box_ring_terms(pgm_pad, resp, boxes)

    # Exact response sum via the telescoped border-ring identity:
    # sum(resp_crop) = sum(pgm * (9 - rows_in * cols_in)) over the box,
    # with alpha = 3 - rows_in and beta = 3 - cols_in nonzero only on
    # border rows/cols: 9 - ab = 3*alpha + 3*beta - alpha*beta.
    alpha = rm * ((hidx - 1 < t).to(pgm.dtype) + (hidx + 1 >= b).to(pgm.dtype))
    beta = cm * ((widx - 1 < l).to(pgm.dtype) + (widx + 1 >= r).to(pgm.dtype))
    s1 = (3.0 * boxsum(pgm, alpha, cm) + 3.0 * boxsum(pgm, rm, beta)
          - boxsum(pgm, alpha, beta))

    n = torch.clamp((b - t) * (r - l), min=1)[..., 0].to(pgm.dtype)
    mean = s1 / n
    var = s2 / n - mean * mean
    # Unguarded division like the reference (src/filtering.c:174).
    return torch.where(boxes_valid, var / mean, torch.zeros_like(mean))


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
    route = (_masked_sharpness if thin_boxes(boxes, boxes_valid).any()
             else _fast_sharpness)
    return route(pgm, torch.as_tensor(boxes, device=pgm.device),
                 torch.as_tensor(boxes_valid, device=pgm.device))


def thin_boxes(boxes: np.ndarray, boxes_valid: np.ndarray) -> np.ndarray:
    """Valid boxes under TINY_BOX_PX in either dimension."""
    return boxes_valid & ((boxes[..., 1] - boxes[..., 0] < TINY_BOX_PX)
                          | (boxes[..., 3] - boxes[..., 2] < TINY_BOX_PX))
