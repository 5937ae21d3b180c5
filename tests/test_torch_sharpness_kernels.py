"""K5's plain version (ops/sharpness_kernels.sharpness_sums_plain) against
the JAX package's Pallas kernel ``pallas_sharpness.sharpness_sums`` in
interpret mode, and the finished sharpness against the JAX package's
``variance_sharpness_batched``, on the same numpy inputs."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from photohive_dsp_tpu.ops import pallas_sharpness as jpsp
from photohive_dsp_tpu.ops import sharpness as jsharp

from photohive_dsp_tpu_torch.ops import sharpness as tsharp
from photohive_dsp_tpu_torch.ops import sharpness_kernels as tsk

H, W = 72, 256          # the Pallas kernel's tiling: H % 8, W % 128
CASES = {
    # corners and every image edge
    "edges": [(0, 8, 0, 16), (20, 72, 100, 256), (0, 72, 250, 256),
              (64, 72, 0, 256)],
    # inside one 8-row tile of the TPU kernel, and one 32-row tile of
    # the CUDA kernel; a box across both kernels' tile seams
    "one_tile": [(8, 16, 30, 90), (33, 40, 5, 250), (28, 44, 120, 140)],
    # slots 0, 3 and 9 only: the rest empty
    "sparse": [(5, 40, 10, 200), None, None, (10, 60, 60, 140), None, None,
               None, None, None, (1, 71, 1, 255)],
}


def _inputs(name, seed=13):
    rng = np.random.default_rng(seed)
    pgm = rng.random((2, H, W)).astype(np.float32)
    boxes = np.zeros((2, 10, 4), np.int32)
    valid = np.zeros((2, 10), bool)
    for k, bx in enumerate(CASES[name]):
        if bx is not None:
            boxes[:, k] = bx
            valid[:, k] = True
    boxes[1] = boxes[1] // 2 * 2       # image 1: other boxes, same slots
    boxes[1, :, 1] = np.maximum(boxes[1, :, 1], boxes[1, :, 0] + 4)
    return pgm, boxes, valid


@pytest.mark.parametrize("name", list(CASES))
def test_sharpness_sums_plain_matches_pallas_interpret(name):
    """s1 and s2 per (image, slot) within 1e-5 relative of the Pallas
    kernel (float32 (8, 128) accumulators there, float64 sums of the same
    float32 pixel values here); empty slots exactly 0."""
    pgm, boxes, valid = _inputs(name)
    zeroed = np.where(valid[..., None], boxes, 0)
    with pltpu.force_tpu_interpret_mode():
        js1, js2 = jpsp.sharpness_sums(jnp.asarray(pgm), jnp.asarray(zeroed))
    ts1, ts2 = tsk.sharpness_sums(torch.from_numpy(pgm),
                                  torch.from_numpy(zeroed))
    for want, got in ((js1, ts1), (js2, ts2)):
        want = np.asarray(want, np.float64)
        got = got.numpy()
        assert np.allclose(got[valid], want[valid], rtol=1e-5, atol=0)
        assert not got[~valid].any()


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_route_matches_jax_sharpness(name):
    """The finished sharpness on the kernel route against the JAX package's
    batched sharpness (its XLA route on the CPU) at rtol 1e-4."""
    pgm, boxes, valid = _inputs(name)
    want = np.asarray(jsharp.variance_sharpness_batched(
        jnp.asarray(pgm), jnp.asarray(boxes), jnp.asarray(valid)))
    got = tsharp.variance_sharpness_batched(torch.from_numpy(pgm), boxes,
                                            valid).numpy()
    assert np.allclose(got, want, rtol=1e-4, atol=0)
    assert not got[~valid].any()


def test_row_shards_with_halo_add_up():
    """Sums over row shards, each given its neighbours' edge rows as halo
    and its row offset, equal the whole image's to float64 rounding; a box
    spans the shards and one sits on a shard seam."""
    rng = np.random.default_rng(3)
    pgm = torch.from_numpy(rng.random((1, 90, 130)).astype(np.float32))
    boxes = torch.zeros((1, 10, 4), dtype=torch.int32)
    boxes[0, 0] = torch.tensor([3, 88, 2, 129])
    boxes[0, 1] = torch.tensor([29, 31, 10, 100])
    boxes[0, 2] = torch.tensor([0, 90, 0, 130])
    whole = tsk.sharpness_sums_plain(pgm, boxes)
    parts = []
    for y0, y1 in ((0, 30), (30, 61), (61, 90)):
        above = pgm[:, y0 - 1] if y0 > 0 else torch.zeros((1, 130))
        below = pgm[:, y1] if y1 < 90 else torch.zeros((1, 130))
        halo = torch.stack([above, below], dim=1)
        parts.append(tsk.sharpness_sums_plain(pgm[:, y0:y1], boxes, halo,
                                              row_offset=y0))
    for j in range(2):
        total = sum(p[j] for p in parts)
        assert torch.allclose(total, whole[j], rtol=1e-12, atol=0)


def test_wrapper_checks_its_inputs():
    pgm = torch.zeros((2, 16, 16))
    with pytest.raises(ValueError):
        tsk.sharpness_sums(pgm, torch.zeros((2, 9, 4), dtype=torch.int32))
    with pytest.raises(TypeError):
        tsk.sharpness_sums(pgm, torch.zeros((2, 10, 4)))
    with pytest.raises(ValueError):
        tsk.sharpness_sums(pgm, torch.zeros((2, 10, 4), dtype=torch.int32),
                           halo=torch.zeros((2, 1, 16)))
