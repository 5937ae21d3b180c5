"""K7+K8: log-gated polar bin sums of a power spectrum, and their plain
version (counterpart of ``pallas_kernels.polar_bin_sums_local`` with
``log_gate=True`` and of its combine step ``pallas_kernels.polar_bin_sums``).

Per image and bin, the sum of g(x) over the spectrum pixels of the bin,
g(x) = 0 if x < 1 else log(x): the reference's log normalisation
(src/fft_processing.c:192-199) with its per-image gain left to the caller.
Pixel i of every image falls in bin ``bin_ids[i]``; an id outside
[0, num_bins) drops the pixel.  The inputs are finite.

The sums are exact on 64-bit fixed point (ops/fixed_point.py): each g(x)
is rounded to nearest once, then added as an integer, so the result is the
same for any order of addition and from run to run.  g(x) < 89 for any
finite float32 x, so 2^28 * 89 * 1.2e8 pixels (config.MAX_NUM_PIXELS) stays
below 2^64.  With ``fixed=True`` the wrapper returns the (B, num_bins) int64
accumulator instead, for a caller that adds it across ranks before
``fixed_point.from_fixed``.  The kernel is csrc/polar.cu; the wrapper
launches it for CUDA tensors and takes the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from .fixed_point import from_fixed, to_fixed


def _check(mag2: torch.Tensor, bin_ids: torch.Tensor) -> None:
    _cuda.require(mag2, "mag2", (torch.float32,), 2)
    _cuda.require(bin_ids, "bin_ids", (torch.int32,), 1)
    if bin_ids.shape[0] != mag2.shape[1]:
        raise ValueError(f"bin_ids: {bin_ids.shape[0]} ids for "
                         f"{mag2.shape[1]} pixels")
    if bin_ids.device != mag2.device:
        raise ValueError(f"bin_ids on {bin_ids.device}, mag2 on "
                         f"{mag2.device}")


def log_gate(x: torch.Tensor) -> torch.Tensor:
    """g(x) = 0 if x < 1 else log(x)."""
    below = x < 1.0
    return torch.where(below, 0.0, torch.log(torch.where(below, 1.0, x)))


def polar_bin_sums_lognorm_plain(mag2: torch.Tensor, bin_ids: torch.Tensor,
                                 num_bins: int, *, fixed: bool = False)\
        -> torch.Tensor:
    """Plain version of K7+K8: (B, P) float32 x (P,) int32 -> (B, num_bins)
    float32, on the kernel's fixed point (the int64 accumulator with
    ``fixed``)."""
    b = mag2.shape[0]
    ids = bin_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_bins), ids, num_bins)
    acc = torch.zeros((b, num_bins + 1), dtype=torch.int64,
                      device=mag2.device)
    acc.scatter_add_(1, ids.expand(b, -1), to_fixed(log_gate(mag2)))
    acc = acc[:, :num_bins]
    return acc if fixed else from_fixed(acc)


def polar_bin_sums_lognorm(mag2: torch.Tensor, bin_ids: torch.Tensor,
                           num_bins: int, *, fixed: bool = False)\
        -> torch.Tensor:
    """K7+K8: per image and bin, the exact sum of g(mag2), (B, P) float32
    and (P,) int32 -> (B, num_bins) float32, or with ``fixed`` the int64
    fixed-point accumulator."""
    _check(mag2, bin_ids)
    if mag2.device.type == "cpu":
        return polar_bin_sums_lognorm_plain(mag2, bin_ids, num_bins,
                                            fixed=fixed)
    b, p = mag2.shape
    sums = None if fixed else torch.empty((b, num_bins), dtype=torch.float32,
                                          device=mag2.device)
    acc = torch.empty((b, num_bins), dtype=torch.int64, device=mag2.device)
    _cuda.launch("ph_polar_bin_sums_lognorm", mag2, _cuda.ptr(mag2),
                 _cuda.ptr(bin_ids), b, p, num_bins, _cuda.ptr(acc),
                 _cuda.ptr(sums))
    _cuda.LAUNCHES["polar_bins"] += 1
    return acc if fixed else sums
