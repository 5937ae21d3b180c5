"""K2: the batched margin-comparator insertion argsort.

Counterpart of ``photohive_dsp_tpu/ops/pallas_kernels.py`` ``margin_sort``
(the kernel) and ``quantize.margin_insertion_argsort`` (its XLA twin).  The
CUDA kernel is csrc/margin_sort.cu; ``margin_insertion_argsort`` is its
plain PyTorch version.  The kernel tracks each element's position instead
of shifting the sorted prefix; ``sort_layout`` picks its (warps, registers)
instantiation for a C.
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


# csrc/margin_sort.cu's instantiations, (warps, registers a thread),
# smallest first: element e lives in lane e % 32 of warp (e // 32) % warps,
# register (e // 32) // warps, so a bucket holds 32 * warps * registers.
SORT_BUCKETS = ((1, 1), (1, 2), (1, 4), (1, 8), (1, 16), (4, 5), (4, 9),
                (4, 17), (16, 9), (16, 32), (32, 32))
MAX_SORT_C = 32 * 32 * 32


def sort_layout(c: int):
    """The (warps, registers) bucket of the kernel for C elements: the
    first that holds them."""
    for warps, regs in SORT_BUCKETS:
        if 32 * warps * regs >= c:
            return warps, regs
    raise ValueError(f"margin_sort: C={c} > {MAX_SORT_C}")


def margin_sort(sal: torch.Tensor) -> torch.Tensor:
    """(B, C) float32 saliencies -> (B, C) int32 margin argsort.

    By its registered operator (ops/library.py): CUDA tensors launch the
    kernel (C up to MAX_SORT_C), CPU tensors take the plain version."""
    _cuda.require(sal, "margin_sort sal", (torch.float32,), 2)
    return torch.ops.photohive.margin_sort(sal)
