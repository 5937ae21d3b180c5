"""The kernels' registered operators (``torch.ops.photohive.*``,
photohive_dsp_tpu_torch/ops/library.py) under ``torch.library.opcheck`` on
the CPU, at tiny shapes: schema, fake (shape-only) implementation against
the real one, a symbolic batch through AOT dispatch.  On the card,
tests/test_torch_cuda.py runs the same checks on the CUDA implementations.
The inputs come from ``op_cases``, which builds them on any device."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch

from photohive_dsp_tpu_torch.config import ReportConfig
from photohive_dsp_tpu_torch.ops import fft_plan
from photohive_dsp_tpu_torch.ops import library
from photohive_dsp_tpu_torch.ops import palette_kernels as pk
from photohive_dsp_tpu_torch.ops import quantize as tq
from photohive_dsp_tpu_torch.ops.margin_sort import margin_insertion_argsort

CFG = ReportConfig()
C = CFG.num_cells
GRID = pk.cell_grid(CFG)
OPS = torch.ops.photohive


def op_cases(device) -> dict:
    """name -> (operator, args) for every operator, on ``device``, from
    seeded numpy inputs."""
    rng = np.random.default_rng(0)
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(x).to(dev)

    u8 = t(rng.integers(0, 256, (2, 3, 8, 16), dtype=np.uint8))
    f32 = t(rng.random((2, 3, 8, 16), dtype=np.float32))
    h = rng.random((2, 64), dtype=np.float32) * 360
    h[:, -3:] = -1.0                      # the hue sentinel
    h, s, v = t(h), t(rng.random((2, 64), dtype=np.float32)), \
        t(rng.random((2, 64), dtype=np.float32))
    octree = tq.OctreeTables.for_config(CFG, dev)
    counts, _ = pk.cell_counts_s_from_rgb_plain(u8.cpu(), CFG)
    counts = counts.to(dev)
    sal = tq.saliency_f32(counts, octree.s_v_f32, CFG)
    assign = tq.parent_assignment_from_order(
        counts, margin_insertion_argsort(sal.cpu()).to(dev), 8 * 16, CFG,
        octree)
    slot, offset = pk.palette_offset_table(assign, octree, C)
    cand, centers = pk.palette_candidate_table(assign, octree, C, 8)
    allowed, _ = pk.cwide_tables(assign, octree)
    pgm = t(rng.random((2, 24, 40), dtype=np.float32))
    halo = t(rng.random((2, 2, 40), dtype=np.float32))
    boxes = np.zeros((2, 10, 4), np.int32)
    boxes[:, 0] = (2, 20, 3, 37)
    boxes[0, 1] = (0, 24, 0, 40)
    boxes[1, 2] = (5, 7, 30, 33)
    valid = (boxes != 0).any(axis=-1)
    plan = fft_plan.FftPlan.for_shape(6, 10, dev)
    spec = OPS.fft_rows.default(t(rng.random((2, 6, 10), dtype=np.float32)),
                                list(plan.rows.radices), plan.rows.twiddles,
                                plan.rows.stage_twiddles)
    mag2 = t(rng.random((2, 60), dtype=np.float32) * 10)
    ids = t(rng.integers(-1, 9, 60).astype(np.int32))
    bin_counts = torch.bincount(ids.clamp(min=0).long(),
                                minlength=8)[:8].int()
    rows = (list(plan.rows.radices), plan.rows.twiddles,
            plan.rows.stage_twiddles)
    cols = (list(plan.cols.radices), plan.cols.twiddles,
            plan.cols.stage_twiddles)
    return {
        "cell_counts_s u8": (OPS.cell_counts_s, (u8, GRID)),
        "cell_counts_s f32": (OPS.cell_counts_s, (f32, GRID)),
        "cell_counts_hsv": (OPS.cell_counts_hsv, (h, s, v, GRID)),
        "cell_counts_ids": (OPS.cell_counts_ids, (
            t(rng.integers(-1, C + 2, (2, 64)).astype(np.int32)), C)),
        "palette_sums_q1": (OPS.palette_sums_q1, (u8, slot, offset, GRID)),
        "palette_sums": (OPS.palette_sums, (f32, cand, centers, GRID)),
        "palette_sums_hsv": (OPS.palette_sums_hsv,
                             (h, s, v, cand, centers, GRID)),
        "palette_sums_cwide": (OPS.palette_sums_cwide,
                               (h, s, v, allowed, centers, GRID)),
        "margin_sort": (OPS.margin_sort, (sal,)),
        "sharpness_sums": (OPS.sharpness_sums, (pgm, None, t(boxes), 0)),
        "sharpness_sums halo": (OPS.sharpness_sums,
                                (pgm, halo, t(boxes), 3)),
        "masked_sharpness": (OPS.masked_sharpness, (pgm, t(boxes),
                                                    t(valid))),
        "fft_rows": (OPS.fft_rows, (spec.new_tensor(
            rng.random((2, 6, 10), dtype=np.float32)), *rows)),
        "fft_cols": (OPS.fft_cols, (spec, *cols)),
        "polar_lognorm sums": (OPS.polar_lognorm, (mag2, ids, None, 8)),
        "polar_lognorm means": (OPS.polar_lognorm,
                                (mag2, ids, bin_counts, 8)),
    }


CASES = list(op_cases("cpu"))


@pytest.mark.parametrize("name", CASES)
def test_opcheck_cpu(name):
    op, args = op_cases("cpu")[name]
    torch.library.opcheck(op, args)


def test_every_entry_point_has_an_operator():
    """One operator for each C entry point of the kernel library but the
    launch-floor probe, and one for the masked sharpness route, which has
    none; the cases above reach each of them."""
    from photohive_dsp_tpu_torch.ops import _cuda

    entry = {n[3:] for n in _cuda._SIGNATURES} - {"empty_kernel"}
    ops = {n for n in dir(OPS) if isinstance(getattr(OPS, n),
                                             torch._ops.OpOverloadPacket)}
    assert ops == entry | {"masked_sharpness"}
    assert {op._qualified_op_name.split("::")[1] for op, _ in
            op_cases("cpu").values()} == ops


@pytest.mark.parametrize("pred", [True, False])
def test_branch_eager_runs_the_branch_taken(pred):
    """Eagerly, ``branch`` reads a host predicate and runs one branch."""
    ran = []

    def yes(x):
        ran.append("yes")
        return x + 1

    def no(x):
        ran.append("no")
        return x - 1

    x = torch.zeros(3)
    out = library.branch(torch.tensor(pred), yes, no, (x,))
    assert ran == ["yes" if pred else "no"]
    assert torch.equal(out, x + (1 if pred else -1))
