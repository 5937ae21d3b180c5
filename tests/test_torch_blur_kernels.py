"""The port's blur-profile stage against the JAX package on the CPU: the
FFT plan and gate, the FFT kernels' plain version (K6a/K6b) against float64
and against ``pallas_fft.magnitude2_scrambled`` in interpret mode, the
polar kernel's plain version (K7+K8) against ``polar_bin_sums_local``, and
``blur_bins_lognorm`` against ``blur_bins_scrambled_lognorm``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.config import ReportConfig as JCfg
from photohive_dsp_tpu.ops import geometry as jgeom
from photohive_dsp_tpu.ops import pallas_fft
from photohive_dsp_tpu.ops.pallas_kernels import polar_bin_sums_local

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.config import ReportConfig as TCfg
from photohive_dsp_tpu_torch.ops import _cuda
from photohive_dsp_tpu_torch.ops import fft_kernels as tfk
from photohive_dsp_tpu_torch.ops import fft_plan
from photohive_dsp_tpu_torch.ops import polar_kernels as tpolar
from photohive_dsp_tpu_torch.ops.blur import PolarTables, blur_bins_lognorm

from .test_pallas_fft import _unscramble
from .test_torch_pipeline import assert_match, report_fields
from .util import snr_db


@pytest.mark.parametrize("h,w,eligible", [
    (1080, 1920, True), (2160, 3840, True), (4320, 7680, True),
    (1092, 1001, True), (360, 512, True), (91, 375, True),
    (362, 514, False),             # 514 = 2 * 257, 362 = 2 * 181
    (1080, 1922, False),           # 1922 = 2 * 31^2
    (1080, 15360, False),          # smooth, but past the shared memory
])
def test_plan_factorisation_and_gate(h, w, eligible):
    assert fft_plan.fft_kernel_eligible(h, w) == eligible
    # The gate's factor list is the JAX planner's.
    for n in (h, w):
        assert fft_plan.factor(n) == pallas_fft._factor_235(n)
    if not eligible:
        with pytest.raises(ValueError):
            fft_plan.FftPlan.for_shape(h, w)
        return
    plan = fft_plan.FftPlan.for_shape(h, w)
    for lp, n in ((plan.rows, w), (plan.cols, h)):
        assert int(np.prod(lp.radices)) == n
        assert set(lp.radices) <= {2, 3, 4, 5, 7, 11, 13}
        tw = lp.twiddles.numpy().astype(np.float64)
        want = np.exp(-2j * np.pi * np.arange(n) / n)
        assert np.abs(tw[:, 0] + 1j * tw[:, 1] - want).max() < 1e-7
    assert fft_plan.stage_radices(1920) == (4, 4, 4, 2, 3, 5)
    assert fft_plan.stage_radices(1080) == (4, 2, 3, 3, 3, 5)


@pytest.mark.parametrize("b,h,w", [
    (2, 240, 384), (2, 96, 256), (2, 56, 384), (2, 104, 256),
    (1, 91, 375),      # odd width and an odd number of rows: 7, 11, 13
])
def test_magnitude2_plain_matches_numpy(b, h, w):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, h, w)).astype(np.float32) * 50.0
    plan = fft_plan.FftPlan.for_shape(h, w)
    got = tfk.magnitude2(torch.from_numpy(x), plan).numpy()
    want = np.abs(np.fft.rfft2(x.astype(np.float64), axes=(1, 2))) ** 2
    assert got.shape == (b, h, w // 2 + 1)
    assert snr_db(want, got) > 90


def test_magnitude2_plain_matches_pallas_interpret():
    h, w = 240, 384
    x = np.random.default_rng(11).standard_normal((2, h, w)).astype(
        np.float32) * 50.0
    with pltpu.force_tpu_interpret_mode():
        jmag = np.asarray(pallas_fft.magnitude2_scrambled(
            jnp.asarray(x), pallas_fft.FftPlan.for_shape(h, w)))
    want = _unscramble(jmag, h, w)
    got = tfk.magnitude2(torch.from_numpy(x),
                         fft_plan.FftPlan.for_shape(h, w)).numpy()
    assert snr_db(want, got) > 90


def test_polar_plain_matches_pallas_interpret():
    """K7+K8's plain version against polar_bin_sums_local(log_gate=True)
    on the natural-order tables: the same gated sums, fixed point here and
    bf16 splits there."""
    h, w = 120, 160
    cfg = JCfg()
    nb = cfg.angle_partitions * cfg.radius_partitions
    rng = np.random.default_rng(2)
    mag2 = (rng.random((2, h * (w // 2 + 1))) ** 4 * 1e4).astype(np.float32)
    ids = jgeom.polar_geometry(h, w, cfg.angle_partitions,
                               cfg.radius_partitions).bin_ids
    dict_ids, local_ids = jgeom.polar_chunk_tables(ids, nb)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(polar_bin_sums_local(
            jnp.asarray(mag2), jnp.asarray(local_ids), jnp.asarray(dict_ids),
            nb, log_gate=True))
    got = tpolar.polar_bin_sums_lognorm(
        torch.from_numpy(mag2), torch.from_numpy(ids), nb).numpy()
    assert snr_db(want, got) > 120
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_blur_bins_lognorm_matches_pallas_interpret():
    """The JAX package's own fused-vs-unfused bars
    (tests/test_pallas_fft.py::test_fused_lognorm_bins_match_unfused)."""
    h, w = 240, 384
    cfg_j, cfg_t = JCfg(), TCfg()
    a, r = cfg_t.angle_partitions, cfg_t.radius_partitions
    x = np.random.default_rng(17).standard_normal((2, h, w)).astype(
        np.float32) * 20.0
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_fft.blur_bins_scrambled_lognorm(
            jnp.asarray(x), pallas_fft.FftPlan.for_shape(h, w),
            pallas_fft.scrambled_polar_tables(h, w, cfg_j), a, r))
    got = blur_bins_lognorm(torch.from_numpy(x),
                            fft_plan.FftPlan.for_shape(h, w),
                            PolarTables.for_shape(h, w, cfg_t), a, r).numpy()
    assert snr_db(want, got) >= 80
    assert np.abs(got - want).max() <= 1e-5


def test_blur_bins_lognorm_black_frame_zero_bins():
    h, w = 240, 384
    cfg = TCfg()
    got = blur_bins_lognorm(torch.zeros((2, h, w)),
                            fft_plan.FftPlan.for_shape(h, w),
                            PolarTables.for_shape(h, w, cfg),
                            cfg.angle_partitions, cfg.radius_partitions)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("h,w,a,r", [(1080, 1920, 72, 40),
                                     (1092, 1001, 72, 40),
                                     (360, 512, 24, 10)])
def test_kernel_layout_bin_table_is_jax_geometry(h, w, a, r):
    """The FFT kernels write the half spectrum in natural row-major order,
    so the polar kernel's table is the JAX package's bin_ids as they are."""
    cfg = TCfg(angle_partitions=a, radius_partitions=r)
    tables = pt.ReportTables.build(h, w, cfg)
    half = fft_plan.FftPlan.for_shape(h, w).half
    assert half == w // 2 + 1
    want = jgeom.polar_geometry(h, w, a, r).bin_ids
    ids = tables.polar.bin_ids
    assert ids.dtype == torch.int32 and ids.shape == (h * half,)
    assert np.array_equal(ids.numpy().reshape(h, half),
                          want.reshape(h, w // 2 + 1))


def test_plain_wrappers_launch_nothing_on_cpu():
    h, w = 96, 256
    cfg = TCfg()
    before = dict(_cuda.LAUNCHES)
    blur_bins_lognorm(torch.ones((1, h, w)), fft_plan.FftPlan.for_shape(h, w),
                      PolarTables.for_shape(h, w, cfg),
                      cfg.angle_partitions, cfg.radius_partitions)
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("h,w,kernels", [(120, 160, True),
                                         (122, 158, False)])  # 61, 79
def test_full_report_batched_routes_by_shape(h, w, kernels, monkeypatch):
    """The blur route follows the shape alone, also for tables carried
    over from the JAX package (ReportTables.from_numpy)."""
    from photohive_dsp_tpu.models import pipeline as jpipe
    from photohive_dsp_tpu_torch.models import pipeline as tpipe

    calls = []
    monkeypatch.setattr(tpipe, "blur_bins_lognorm",
                        lambda *a: calls.append(a) or blur_bins_lognorm(*a))
    tables = pt.ReportTables.from_numpy(jpipe.ReportTables.build(h, w,
                                                                 JCfg()))
    rgb = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (1, 3, h, w), dtype=np.uint8))
    boxes, valid = pt.set_bounding_boxes([])
    out = pt.full_report_batched(rgb, boxes[None], valid[None], tables,
                                 TCfg())
    assert len(calls) == int(kernels)
    assert bool(torch.isfinite(out.blur_bins).all())


def test_get_report_non_smooth_shape_matches_jax():
    """362x514 is outside the FFT kernels' gate: the torch rfft2 route."""
    h, w = 362, 514
    assert not fft_plan.fft_kernel_eligible(h, w)
    img = np.random.default_rng(8).integers(0, 256, (h, w, 3),
                                            dtype=np.uint8)
    want = ph.get_report(img)
    got = pt.get_report(img, device="cpu")
    assert_match(report_fields(got), report_fields(want))
