"""Report configuration.

The reference exposes 16 hyperparameters as positional arguments flowing from
Python defaults into the C entry point (reference: core.py:442-448,
src/interface.c:20-27).  Here they live in one frozen (hashable)
dataclass, the same as the JAX package's ``photohive_dsp_tpu.config`` (same
knobs, defaults and checks), so host tables can be cached per config.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Input-validation constants (reference: src/utilities.c:11-13,64-87).
MIN_SIDE = 350
MAX_NUM_PIXELS = 12000 * 10000
ASPECT_RATIO_MIN = 1.0 / 5.0
ASPECT_RATIO_MAX = 5.0 / 1.0

# The report always carries exactly 10 blur-vector slots and up to 10 crop
# boxes (reference: src/blur_profile.c:328, README ≤10 boxes).
NUM_BLUR_VECTORS = 10
MAX_CROP_BOXES = 10

# The C blur-profile binning uses a truncated value of pi
# (reference: src/blur_profile.c:10 `#define PI 3.14159265`).  The polar bin
# index map must reproduce it exactly.
REFERENCE_PI = 3.14159265

# HSV clamp used by the reference colorspace conversion
# (reference: src/image_processing.c:8-9).
MAX_SATURATION = 0.999999
MAX_VALUE = 0.999999


@dataclasses.dataclass(frozen=True)
class ReportConfig:
    """All 16 reference knobs, same defaults as reference core.py:442-448."""

    h_partitions: int = 18
    s_partitions: int = 2
    v_partitions: int = 3
    black_thresh: float = 0.1
    gray_thresh: float = 0.1
    coverage_thresh: float = 0.95
    linked_list_size: int = 1000  # unused by the dense pipeline; API parity
    downsample_rate: int = 1
    radius_partitions: int = 40
    angle_partitions: int = 72
    quantity_weight: float = 0.1
    saturation_value_weight: float = 0.9
    fft_streak_thresh: float = 1.20
    magnitude_thresh: float = 0.3
    blur_cutoff_ratio_denom: int = 2
    # Not a reference knob: compute dtype for the dense pipeline.  The
    # reference is float64 end to end (src/types.h:5); the pipeline computes
    # in float32, and parity is held by tolerance tests against the JAX
    # package.
    dtype: str = "float32"

    # ---- derived quantities -------------------------------------------------

    @property
    def num_grays(self) -> int:
        # reference: src/color_quantization.c:27 (num_grays = v_parts)
        return self.v_partitions

    @property
    def num_cells(self) -> int:
        """Total octree cells: h*s*v color cells + v gray cells + 1 black.

        reference: src/color_quantization.c:39
        """
        return (
            self.h_partitions * self.s_partitions * self.v_partitions
            + self.num_grays
            + 1
        )

    @property
    def gray_start(self) -> int:
        # First gray cell id (reference: src/color_quantization.c:255).
        return self.num_cells - (self.num_grays + 1)

    @property
    def black_id(self) -> int:
        return self.num_cells - 1

    @property
    def cell_Lh(self) -> float:
        # INT division, faithfully (reference: src/color_quantization.c:41).
        return float(360 // self.h_partitions)

    @property
    def cell_Ls(self) -> float:
        return (1.0 - self.gray_thresh) / self.s_partitions

    @property
    def cell_Lv(self) -> float:
        return (1.0 - self.black_thresh) / self.v_partitions

    def validate(self) -> None:
        if self.h_partitions <= 0:
            # Checked before the modulo: h_partitions=0 would raise
            # ZeroDivisionError and negatives pass `360 % -18 == 0`.
            raise ValueError("h_partitions must be positive")
        if 360 % self.h_partitions != 0:
            # The reference computes Lh with integer division
            # (src/color_quantization.c:41); a non-divisor h_partitions makes
            # its cell index overflow the groups array (undefined behavior).
            # We refuse instead of replicating memory corruption.
            raise ValueError(
                f"h_partitions={self.h_partitions} must divide 360 "
                "(the reference library corrupts memory otherwise)"
            )
        for name in ("s_partitions", "v_partitions", "radius_partitions",
                     "angle_partitions", "blur_cutoff_ratio_denom"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        if self.angle_partitions < 3:
            raise ValueError("angle_partitions must be >= 3")


def check_image_dims(height: int, width: int) -> Tuple[bool, str]:
    """Input guards, same rules as reference src/utilities.c:64-87."""
    if height < MIN_SIDE or width < MIN_SIDE:
        return False, (
            f"image height and width must be >= {MIN_SIDE} "
            f"(got {height}x{width})"
        )
    if height * width > MAX_NUM_PIXELS:
        return False, f"image must have <= {MAX_NUM_PIXELS} pixels"
    # Reference computes the ratio in float32 (src/utilities.c:77).
    import numpy as np

    aspect = np.float32(height) / np.float32(width)
    if aspect < ASPECT_RATIO_MIN or aspect > ASPECT_RATIO_MAX:
        return False, f"invalid aspect ratio {aspect}"
    return True, ""
