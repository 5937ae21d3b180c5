"""Host-side (numpy, float64) precomputation of data-independent geometry.

Two families of constants are derived once per shape/config and shipped to the
device as arrays:

1. **Polar binning tables** for the blur profile.  The reference builds a
   per-pixel (r^2, phi) table (src/blur_profile.c:427-458) and then
   scatter-accumulates FFT magnitudes into (angle, radius) bins
   (src/blur_profile.c:34-126).  Both the bin index of every pixel and the
   per-bin pixel counts depend only on (H, W, angle_bins, radius_bins) — so we
   compute them exactly (including the reference's quirks: truncated PI
   constant, integer-division radius bin sizing, Newton integer sqrt, and the
   off-by-one bottom-half mirror) in float64 numpy, and reduce on device with
   a static gather + padded segment sum instead of a scatter.

2. **Octree (HSV-grid) tables** for color quantization: cell centers
   (src/color_quantization.c:22-101), the f32 saturation*value products used
   by the saliency sort (src/color_quantization.c:588-595), and an exact
   dense-rank encoding of the cell-to-cell distance heuristic
   (src/color_quantization.c:253-288) so that float64 distance *ties* — which
   trigger the reference's per-pixel reassignment branch — are detected
   exactly on a float32-only device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from ..config import REFERENCE_PI, ReportConfig


def newton_int_sqrt(val: np.ndarray) -> np.ndarray:
    """Vectorized replica of the reference's Newton integer sqrt.

    reference: src/utilities.c:43-52.  Iterates x <- (x + v/x)/2 starting at
    x = v and returns trunc(x) at the first step where |step| < 1.  This can
    differ from floor(sqrt(v)) near integer boundaries, so it must be
    emulated rather than replaced.
    """
    val = np.asarray(val, dtype=np.float64)
    out = np.zeros(val.shape, dtype=np.int64)
    active = val != 0
    x = np.where(active, val, 1.0)
    for _ in range(64):  # quadratic convergence; 64 covers any double
        if not active.any():
            break
        sqrt = 0.5 * (x + val / np.where(x == 0, 1.0, x))
        done = active & (np.abs(sqrt - x) < 1.0)
        out[done] = sqrt[done].astype(np.int64)
        active = active & ~done
        x = np.where(active, sqrt, x)
    return out


class PolarGeometry(NamedTuple):
    """Static tables for one (height, width, angle_bins, radius_bins)."""

    height: int          # spatial image height
    width: int           # spatial image width
    fft_width: int       # width of the half spectrum = width//2 + 1
    num_angle_bins: int
    num_radius_bins: int
    # Flat (angle*R + radius) bin id per FFT pixel, shape (H * fft_width,).
    bin_ids: np.ndarray
    # Per-bin pixel counts, shape (A*R,), int32.
    bin_counts: np.ndarray
    # Gather table: pad_index[b, l] is the flat FFT-pixel index of the l-th
    # member of bin b, or H*fft_width (a sentinel pointing at an appended
    # zero) when l >= bin_counts[b].  Shape (A*R, Lmax), int32.
    pad_index: np.ndarray


def _reference_polar_map(height: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """(r_sq, phi) per FFT pixel, replicating src/blur_profile.c:427-458.

    The C code fills the top half with phi = -atan2(y, x) and mirrors row
    ``height-1-y`` (not ``height-y``) with phi = +atan2(y, x); for odd heights
    the middle row is written twice and the +atan2 value wins.
    """
    fft_w = width // 2 + 1
    x = np.arange(fft_w, dtype=np.float64)[None, :]
    r_sq = np.empty((height, fft_w), dtype=np.int64)
    phi = np.empty((height, fft_w), dtype=np.float64)
    half = height // 2
    bound = half + 1 if height % 2 == 1 else half
    y_top = np.arange(bound, dtype=np.float64)[:, None]
    top_phi = np.arctan2(y_top, x)
    top_rsq = (x.astype(np.int64) ** 2 + y_top.astype(np.int64) ** 2)
    phi[:bound] = -top_phi
    r_sq[:bound] = top_rsq
    # Bottom mirror: row (height-1-y) gets +atan2(y, x).  Writing it second
    # reproduces the double-write on the middle row of odd heights.
    rows = height - 1 - np.arange(bound)
    phi[rows] = top_phi
    r_sq[rows] = top_rsq
    return r_sq, phi


def polar_chunk_tables(bin_ids: np.ndarray, num_bins: int,
                       chunk: int = 512):
    """Per-chunk bin dictionaries for the local polar kernel.

    In natural (row-major spectrum) order a 512-pixel chunk touches at
    most ~64 DISTINCT bins (measured: max 55 at 1080p, 46 at 4K, 63 at
    720p) even though the id SPAN can cover the whole table near DC — so
    the kernel can one-hot against a per-chunk dictionary instead of the
    full (A*R, chunk) table, cutting the contraction and the compare work
    ~45x.  Returns:

      dict_ids:  (n_chunks, K) int32 — global bin id per local slot,
                 sentinel ``num_bins`` in unused slots (and for the
                 padding pseudo-bin), K = max distinct rounded up to 8.
      local_ids: (n_chunks, chunk, 1) int32 — each pixel's local slot,
                 PRE-TRANSPOSED (pixels on sublanes) so the kernel's
                 one-hot is born in the GEMM's natural rhs layout.
    """
    p = bin_ids.size
    pad = (-p) % chunk
    ids = np.concatenate(
        [bin_ids, np.full(pad, num_bins, np.int32)]).reshape(-1, chunk)
    n = ids.shape[0]
    uniq = [np.unique(c) for c in ids]
    k = max(len(u) for u in uniq)
    k = max(8, -(-k // 8) * 8)
    # Chunks are padded to a multiple of 8 (the JAX package's TPU kernel
    # takes 8 per grid step); padded chunks match no bin: local id k,
    # dict slots sentinel.  Kept bit-equal to the JAX tables.
    n_pad = -(-n // 8) * 8
    dict_ids = np.full((n_pad, k), num_bins, np.int32)
    local = np.full((n_pad, chunk), k, np.int32)
    for i, u in enumerate(uniq):
        dict_ids[i, :len(u)] = u
        local[i] = np.searchsorted(u, ids[i])
    return dict_ids, local.reshape(n_pad, chunk, 1)


@functools.lru_cache(maxsize=32)
def polar_geometry(
    height: int, width: int, num_angle_bins: int, num_radius_bins: int
) -> PolarGeometry:
    """Build the full static polar-binning table for an image shape."""
    fft_w = width // 2 + 1
    r_sq, phi = _reference_polar_map(height, width)

    # phi bin (reference: src/blur_profile.c:94) with the truncated PI.
    a = num_angle_bins
    phi_bin = ((phi + REFERENCE_PI * 0.5) / REFERENCE_PI * (a - 1)).astype(
        np.int64
    )  # C (int) cast truncates toward zero; phi >= -pi/2 keeps this in range
    np.clip(phi_bin, 0, a - 1, out=phi_bin)

    # radius bin size squared with C integer division
    # (reference: src/blur_profile.c:61).
    r = num_radius_bins
    rbss = (fft_w * fft_w + (height * height) // 4) // (r * r)
    r_bin = newton_int_sqrt(r_sq.astype(np.float64) / float(rbss))
    r_bin = np.where(r_bin == r, r - 1, r_bin)  # reference: :97
    np.clip(r_bin, 0, r - 1, out=r_bin)  # guard vs pathological tiny shapes

    bin_ids = (phi_bin * r + r_bin).astype(np.int32).reshape(-1)
    num_bins = a * r
    counts = np.bincount(bin_ids, minlength=num_bins).astype(np.int32)

    order = np.argsort(bin_ids, kind="stable").astype(np.int32)
    l_max = max(int(counts.max()), 1)
    sentinel = np.int32(bin_ids.size)
    pad_index = np.full((num_bins, l_max), sentinel, dtype=np.int32)
    starts = np.zeros(num_bins + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    # Row-fill the ragged segments; vectorized via a flat assignment.
    seg_pos = np.arange(bin_ids.size, dtype=np.int64) - starts[
        bin_ids[order].astype(np.int64)
    ]
    pad_index[bin_ids[order].astype(np.int64), seg_pos] = order
    return PolarGeometry(
        height=height,
        width=width,
        fft_width=fft_w,
        num_angle_bins=a,
        num_radius_bins=r,
        bin_ids=bin_ids,
        bin_counts=counts,
        pad_index=pad_index,
    )


class OctreeGeometry(NamedTuple):
    """Static per-config tables for the HSV-grid color quantizer."""

    num_cells: int
    gray_start: int
    black_id: int
    # Cell centers (float64 exact; ship to device as f32), shape (C, 3).
    centers: np.ndarray
    # f32 saturation*value per cell as the C code computes it (float cast of
    # the double product), shape (C,), float32.
    s_v_f32: np.ndarray
    # Dense rank of the float64 cell-to-cell distance heuristic, per row:
    # ranks[c, p] == ranks[c, q] iff D[c, p] == D[c, q] exactly in float64.
    # Shape (C, C), int32.
    dist_ranks: np.ndarray
    # The float32 distances themselves (for reporting/debug), shape (C, C).
    dist_f32: np.ndarray
    # Static upper bound on the per-cell nearest-parent candidate count: the
    # candidates of any cell (tied parents of group_irregular_pixels,
    # src/color_quantization.c:376-400) all share one distance-rank value, so
    # no cell can ever have more candidates than the largest equal-rank group
    # in its dist_ranks row.  Sizes the Pallas palette kernel's tie tables.
    max_tie_candidates: int


@functools.lru_cache(maxsize=32)
def octree_geometry(cfg: ReportConfig) -> OctreeGeometry:
    cfg.validate()
    h_parts, s_parts, v_parts = (
        cfg.h_partitions,
        cfg.s_partitions,
        cfg.v_partitions,
    )
    num_grays = cfg.num_grays
    c_total = cfg.num_cells
    lh = float(360 // h_parts)  # C integer division (src/color_quantization.c:41)
    ls = (1.0 - cfg.gray_thresh) / s_parts
    lv = (1.0 - cfg.black_thresh) / v_parts

    centers = np.zeros((c_total, 3), dtype=np.float64)
    half_h = lh / 2.0
    s_offs = ls / 2.0 + cfg.gray_thresh
    v_offs = lv / 2.0 + cfg.black_thresh
    for h in range(h_parts):
        for s in range(s_parts):
            for v in range(v_parts):
                i = h * s_parts * v_parts + s * v_parts + v
                centers[i] = (h * lh + half_h, s * ls + s_offs, v * lv + v_offs)
    # Gray cells (reference: src/color_quantization.c:78-88): note they reuse
    # the *color* value offset v_offs and step L_gray = (1-black)/num_grays.
    l_gray = (1.0 - cfg.black_thresh) / num_grays
    base = h_parts * s_parts * v_parts
    for j in range(num_grays):
        centers[base + j] = (0.0, 0.0, l_gray * j + v_offs)
    centers[c_total - 1] = (0.0, 0.0, 0.0)  # black

    s_v_f32 = (centers[:, 1] * centers[:, 2]).astype(np.float32)

    # Cell-to-cell distance heuristic (src/color_quantization.c:253-288).
    gray_start = cfg.gray_start
    black_id = cfg.black_id
    ids = np.arange(c_total)
    is_color = ids < gray_start
    h_c, s_c, v_c = centers[:, 0], centers[:, 1], centers[:, 2]
    hd = np.abs(h_c[:, None] - h_c[None, :])
    hd = np.where(hd > 180.0, 360.0 - hd, hd) * (1.0 / 360.0)
    sd = s_c[:, None] - s_c[None, :]
    vd = v_c[:, None] - v_c[None, :]
    both_color = is_color[:, None] & is_color[None, :]
    is_gray = (ids >= gray_start) & (ids < black_id)
    gray_color = (is_gray[:, None] & is_color[None, :]) | (
        is_color[:, None] & is_gray[None, :]
    )
    dist = np.where(
        both_color,
        hd * hd + sd * sd + vd * vd,
        np.where(gray_color, sd * sd + vd * vd, vd * vd),
    )

    # Dense ranks per row, exact float64 tie detection.
    ranks = np.zeros((c_total, c_total), dtype=np.int32)
    max_tie = 1
    for c in range(c_total):
        uniq, inv = np.unique(dist[c], return_inverse=True)
        ranks[c] = inv.astype(np.int32)
        max_tie = max(max_tie, int(np.bincount(inv).max()))

    return OctreeGeometry(
        num_cells=c_total,
        gray_start=gray_start,
        black_id=black_id,
        centers=centers,
        s_v_f32=s_v_f32,
        dist_ranks=ranks,
        dist_f32=dist.astype(np.float32),
        max_tie_candidates=max_tie,
    )
