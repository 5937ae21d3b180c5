"""K7+K8: log-gated polar bin sums of a power spectrum with its per-image
maximum, and the normalised bin means made from them; their plain versions
(counterpart of ``pallas_kernels.polar_bin_sums_local`` with
``log_gate=True``, of its combine step ``pallas_kernels.polar_bin_sums``
and of the tail of ``pallas_fft.blur_bins_scrambled_lognorm``).

Per image and bin, the sum of g(x) over the spectrum pixels of the bin,
g(x) = 0 if x < 1 else log(x): the reference's log normalisation
(src/fft_processing.c:192-199) before its per-image gain.  Pixel i of every
image falls in bin ``bin_ids[i]``; an id outside [0, num_bins) drops the
pixel.  The inputs are finite.  The same pass returns each image's maximum
of the spectrum (at least 0), which the gain needs.

The sums are exact on 64-bit fixed point (ops/fixed_point.py): each g(x)
is rounded to nearest once, then added as an integer, so the result is the
same for any order of addition and from run to run.  g(x) < 89 for any
finite float32 x, so 2^28 * 89 * 1.2e8 pixels (config.MAX_NUM_PIXELS) stays
below 2^64.  With ``fixed=True`` the sums wrapper returns the (B, num_bins)
int64 accumulator instead, for a caller that adds it across ranks before
``fixed_point.from_fixed``.  The kernel is csrc/polar.cu; each wrapper
calls its registered operator (ops/library.py ``polar_lognorm``), which
launches it for CUDA tensors and runs the plain version for CPU tensors.
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


def lognorm_gain(mx: torch.Tensor) -> torch.Tensor:
    """The per-image gain G_s = 1 / (2 log(sqrt(max) + 1)) of the
    log-gated sums, 0 for a zero spectrum."""
    denom = 2.0 * torch.log(torch.sqrt(mx) + 1.0)
    return torch.where(denom > 0.0, 1.0 / torch.clamp(denom, min=1e-30),
                       torch.zeros_like(denom))


def mean_per_bin(sums: torch.Tensor, bin_counts: torch.Tensor)\
        -> torch.Tensor:
    """(B, A*R) bin sums and (A*R,) pixel counts -> (B, A*R) means; empty
    bins are 0."""
    counts = bin_counts.to(sums.dtype)
    return torch.where(bin_counts > 0, sums / torch.clamp(counts, min=1.0),
                       torch.zeros_like(sums))


def polar_bin_sums_lognorm_plain(mag2: torch.Tensor, bin_ids: torch.Tensor,
                                 num_bins: int, *, fixed: bool = False):
    """Plain version of K7+K8: (B, P) float32 x (P,) int32 -> ((B,
    num_bins) float32 sums on the kernel's fixed point, or the int64
    accumulator with ``fixed``; (B,) float32 maximum of each image, at
    least 0)."""
    b = mag2.shape[0]
    ids = bin_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_bins), ids, num_bins)
    acc = torch.zeros((b, num_bins + 1), dtype=torch.int64,
                      device=mag2.device)
    acc.scatter_add_(1, ids.expand(b, -1), to_fixed(log_gate(mag2)))
    acc = acc[:, :num_bins].contiguous()
    mx = mag2.amax(dim=1).clamp(min=0.0)
    return (acc if fixed else from_fixed(acc)), mx


def polar_bin_sums_lognorm(mag2: torch.Tensor, bin_ids: torch.Tensor,
                           num_bins: int, *, fixed: bool = False):
    """K7+K8: per image and bin, the exact sum of g(mag2), and each
    image's maximum: (B, P) float32 and (P,) int32 -> ((B, num_bins)
    float32, or with ``fixed`` the int64 fixed-point accumulator; (B,)
    float32)."""
    _check(mag2, bin_ids)
    acc, mx, sums = torch.ops.photohive.polar_lognorm(mag2, bin_ids, None,
                                                      num_bins)
    return (acc if fixed else sums), mx


def polar_bin_means_lognorm_plain(mag2: torch.Tensor, bin_ids: torch.Tensor,
                                  bin_counts: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's means: the sums times the gain of the
    maximum, over the counts, (B, num_bins) float32."""
    sums, mx = polar_bin_sums_lognorm_plain(mag2, bin_ids,
                                            bin_counts.shape[0])
    return mean_per_bin(sums * lognorm_gain(mx)[:, None], bin_counts)


def polar_bin_means_lognorm(mag2: torch.Tensor, bin_ids: torch.Tensor,
                            bin_counts: torch.Tensor) -> torch.Tensor:
    """K7+K8 with the blur tail: (B, P) float32 |X|^2, (P,) int32 bin ids
    and (num_bins,) int32 pixel counts -> (B, num_bins) float32 normalised
    bin means (empty bins 0; a zero spectrum has gain 0, so its means are
    0), in one kernel and its finish, bit for bit the plain version's
    float32 ops."""
    _check(mag2, bin_ids)
    _cuda.require(bin_counts, "bin_counts", (torch.int32,), 1)
    if bin_counts.device != mag2.device:
        raise ValueError(f"bin_counts on {bin_counts.device}, mag2 on "
                         f"{mag2.device}")
    return torch.ops.photohive.polar_lognorm(mag2, bin_ids, bin_counts,
                                             bin_counts.shape[0])[2]
