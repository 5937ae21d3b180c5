"""The least time the chip could take for a stage's work, from the shapes
the work was done on (NVIDIA's H100 SXM data sheet; see PERF.md): each
input byte read once and each output byte written once over the HBM rate,
or the algorithm's float32 operations over the peak float32 rate outside
the tensor cores, whichever is larger."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# float32 operations a palette pixel needs: decode, HSV and its cell
# (3 decodes, 4 max/min, 5 for the hue, 1 for s, 12 for the cell id),
# and the add into its parent's sums (wrapped hue, 3 conversions).  The
# tie-break distances of pixels in tied cells depend on the frame and are
# left out, so the share reads no higher than the truth.
OPS_PALETTE_PX = 25 + 6
# per half-spectrum value: |X|^2 (3), the log gate (2), the bin add (1).
OPS_BINS_PX = 6


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def palette_s(height: int, width: int, num_cells: int) -> float:
    """One image's palette: the uint8 frame read once; counts, saturation
    sum and per-slot sums written once."""
    px = height * width
    return bound_s(3 * px + 8 * num_cells + 8 + 16 * num_cells,
                   OPS_PALETTE_PX * px)


def blur_s(height: int, width: int, angles: int, radii: int) -> float:
    """One image's blur profile: the float32 luma read once, the bins
    written once; a real 2-D FFT's 2.5 N log2 N operations and the bins'
    per-value work."""
    px = height * width
    half = height * (width // 2 + 1)
    return bound_s(4 * px + 4 * angles * radii,
                   2.5 * px * math.log2(px) + OPS_BINS_PX * half)
