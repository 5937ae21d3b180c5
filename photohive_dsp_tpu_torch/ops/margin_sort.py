"""K2: the batched margin-comparator insertion argsort.

Counterpart of ``photohive_dsp_tpu/ops/pallas_kernels.py`` ``margin_sort``
(the kernel) and ``quantize.margin_insertion_argsort`` (its XLA twin).  The
CUDA kernel is csrc/margin_sort.cu; ``margin_insertion_argsort`` is its
plain PyTorch version.
"""

from __future__ import annotations

import torch

from . import _cuda


def margin_insertion_argsort(sal: torch.Tensor) -> torch.Tensor:
    """Exact emulation of the reference's custom_sort with comparator
    (int)(sal_b - sal_a), for a batch: (B, C) float32 -> (B, C) int32.

    Insertion sort bubbles element i left while the element to its left
    satisfies sal[left] - sal[i] <= -1 in float32 (C truncation toward zero
    makes (int)x < 0 iff x <= -1), so its final position is just past the
    last prefix element that does not (reference src/utilities.c:132-153,
    src/color_quantization.c:601-611).  One vectorised pass per step; the
    C-1 steps run in sequence."""
    b, c = sal.shape
    iota = torch.arange(c, device=sal.device)
    order = iota.expand(b, c).clone()
    so = sal.clone()
    for i in range(1, c):
        sal_i = so[:, i:i + 1]
        elem = order[:, i:i + 1]
        margin = (so - sal_i) <= -1.0
        blockers = ~margin & (iota < i)
        last = torch.where(blockers, iota, -1).amax(dim=1, keepdim=True)
        pos = last + 1
        inner = iota <= i
        keep = iota < pos
        at_pos = iota == pos
        so = torch.where(keep, so, torch.where(
            at_pos, sal_i, torch.where(inner, torch.roll(so, 1, 1), so)))
        order = torch.where(keep, order, torch.where(
            at_pos, elem, torch.where(inner, torch.roll(order, 1, 1), order)))
    return order.to(torch.int32)


def margin_sort(sal: torch.Tensor) -> torch.Tensor:
    """(B, C) float32 saliencies -> (B, C) int32 margin argsort.

    CUDA tensors launch the kernel (any C); CPU tensors take the plain
    version."""
    _cuda.require(sal, "margin_sort sal", (torch.float32,), 2)
    if sal.device.type == "cpu":
        return margin_insertion_argsort(sal)
    b, c = sal.shape
    out = torch.empty((b, c), dtype=torch.int32, device=sal.device)
    _cuda.launch("ph_margin_sort", sal, _cuda.ptr(sal), b, c, _cuda.ptr(out))
    _cuda.LAUNCHES["margin_sort"] += 1
    return out
