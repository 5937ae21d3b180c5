"""K2's schedule (csrc/margin_sort.cu) emulated in torch on the CPU against
its plain version ``margin_insertion_argsort``: the same lane and register
layout (``sort_layout``), blocker masks, position updates and final
scatter, at C on both sides of each bucket's edge and on data that reach
the comparator's edges.  The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3)."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch

from photohive_dsp_tpu_torch.ops.margin_sort import (
    MAX_SORT_C, SORT_BUCKETS, margin_insertion_argsort, margin_sort,
    sort_layout)

# Both sides of each bucket's edge up to the 4-warp buckets' last (2176),
# the default C (112) and h_partitions=360's C (2164).
SORT_CS = [1, 2, 31, 32, 33, 64, 65, 112, 128, 129, 256, 257, 512, 513, 640,
           641, 1152, 1153, 2164, 2176]


def sort_data(kind: str, b: int, c: int) -> np.ndarray:
    """(B, C) float32 saliencies of one kind, from a seed."""
    rng = np.random.default_rng(c * 31 + len(kind))
    if kind == "uniform":
        x = rng.uniform(0.0, 50.0, (b, c))
    elif kind == "rounded+jitter":     # ties inside the margin
        x = np.round(rng.random((b, c)) * 30) + rng.random((b, c)) * 0.6
    elif kind == "all equal":
        x = np.full((b, c), 7.0)
    elif kind == "increasing":
        x = np.arange(c)[None] * 0.375 + rng.random((b, 1))
    elif kind == "decreasing":
        x = -np.arange(c)[None] * 0.375 + rng.random((b, 1))
    elif kind == "1.0 apart":          # differences of exactly -1
        x = rng.integers(0, max(2, c // 4), (b, c)).astype(np.float64)
    elif kind == "near 1e7":           # subtractions that round
        big = rng.choice([0.0, 1e7, 2.0 ** 24], (b, c))
        x = big + rng.integers(-3, 4, (b, c)) + rng.random((b, c)) * 0.9
    else:
        raise ValueError(kind)
    return x.astype(np.float32)


KINDS = ["uniform", "rounded+jitter", "all equal", "increasing", "decreasing",
         "1.0 apart", "near 1e7"]


def emulate_margin_sort(sal: torch.Tensor) -> torch.Tensor:
    """csrc/margin_sort.cu's schedule: element e in lane e % 32 of warp
    (e // 32) % warps, register (e // 32) // warps; positions -1 until
    placed; step i masks the positions by its blockers, takes the lane's
    max over its registers, the warp's max and the block's max, moves the
    positions past it one slot right and places i after it; then scatters
    order[posn[e]] = e."""
    b, c = sal.shape
    warps, regs = sort_layout(c)
    n = 32 * warps * regs
    s = torch.zeros((b, n), dtype=torch.float32)
    s[:, :c] = sal
    s = s.reshape(b, regs, warps, 32)
    p = torch.full((b, regs, warps, 32), -1, dtype=torch.int32)
    for i in range(c):
        r, w, lane = i // (32 * warps), (i // 32) % warps, i % 32
        si = s[:, r, w, lane].reshape(b, 1, 1, 1)
        blockers = ~((s - si) <= -1.0)
        lane_max = torch.where(blockers, p, -1).amax(dim=1)
        last = lane_max.amax(dim=2).amax(dim=1).reshape(b, 1, 1, 1)
        p = p + (p > last).to(torch.int32)
        p[:, r, w, lane] = last.reshape(b) + 1
    posn = p.reshape(b, n)[:, :c].long()
    written = torch.zeros((b, c), dtype=torch.int64)
    written.scatter_add_(1, posn, torch.ones_like(posn))
    assert torch.equal(written, torch.ones_like(written)), \
        "positions are not a permutation"
    order = torch.empty((b, c), dtype=torch.int32)
    order.scatter_(1, posn, torch.arange(c, dtype=torch.int32).expand(b, c))
    return order


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("c", SORT_CS)
def test_k2_schedule_matches_plain(c, kind):
    sal = torch.from_numpy(sort_data(kind, 3, c))
    assert torch.equal(emulate_margin_sort(sal), margin_insertion_argsort(sal))


def test_sort_layout_buckets():
    """Each C takes the smallest bucket that holds it; the one-warp buckets
    end at 512, the 4-warp ones at 2176; past MAX_SORT_C the wrapper
    refuses."""
    caps = [32 * w * r for w, r in SORT_BUCKETS]
    assert caps == sorted(caps) and caps[-1] == MAX_SORT_C
    for c in range(1, 2200):
        warps, regs = sort_layout(c)
        cap = 32 * warps * regs
        assert cap >= c
        assert all(other < c for other in caps if other < cap)
    assert sort_layout(112) == (1, 4)
    assert sort_layout(512) == (1, 16) and sort_layout(513) == (4, 5)
    assert sort_layout(2164) == (4, 17)
    with pytest.raises(ValueError):
        sort_layout(MAX_SORT_C + 1)


def test_margin_sort_on_cpu_is_plain():
    sal = torch.from_numpy(sort_data("rounded+jitter", 2, 65))
    assert torch.equal(margin_sort(sal), margin_insertion_argsort(sal))
