"""The PyTorch port's config and host tables against the JAX package's:
same knobs and checks, bit-equal geometry, and ReportTables.from_numpy."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch

from photohive_dsp_tpu import config as jcfg
from photohive_dsp_tpu.models import pipeline as jpipe
from photohive_dsp_tpu.ops import geometry as jgeom

from photohive_dsp_tpu_torch import config as tcfg
from photohive_dsp_tpu_torch.models import pipeline as tpipe
from photohive_dsp_tpu_torch.ops import geometry as tgeom

CONFIGS = [
    {},
    dict(h_partitions=12, s_partitions=3, v_partitions=2,
         radius_partitions=10, angle_partitions=24),
    dict(h_partitions=360),
    dict(black_thresh=0.2, gray_thresh=0.05, coverage_thresh=0.9),
]


@pytest.mark.parametrize("knobs", CONFIGS)
def test_config_fields_and_derived_match(knobs):
    a, b = jcfg.ReportConfig(**knobs), tcfg.ReportConfig(**knobs)
    assert [f.name for f in a.__dataclass_fields__.values()] == \
        [f.name for f in b.__dataclass_fields__.values()]
    for name in a.__dataclass_fields__:
        assert getattr(a, name) == getattr(b, name)
    for prop in ("num_grays", "num_cells", "gray_start", "black_id",
                 "cell_Lh", "cell_Ls", "cell_Lv"):
        assert getattr(a, prop) == getattr(b, prop)
    for const in ("MIN_SIDE", "MAX_NUM_PIXELS", "ASPECT_RATIO_MIN",
                  "ASPECT_RATIO_MAX", "NUM_BLUR_VECTORS", "MAX_CROP_BOXES",
                  "REFERENCE_PI", "MAX_SATURATION", "MAX_VALUE"):
        assert getattr(jcfg, const) == getattr(tcfg, const)


@pytest.mark.parametrize("knobs", [
    dict(h_partitions=0), dict(h_partitions=7), dict(h_partitions=-18),
    dict(s_partitions=0), dict(radius_partitions=0), dict(angle_partitions=2),
    dict(blur_cutoff_ratio_denom=0)])
def test_config_validate_rejects_like_jax(knobs):
    with pytest.raises(ValueError) as ja:
        jcfg.ReportConfig(**knobs).validate()
    with pytest.raises(ValueError) as tb:
        tcfg.ReportConfig(**knobs).validate()
    assert str(ja.value) == str(tb.value)


@pytest.mark.parametrize("hw", [(350, 350), (349, 1000), (1080, 1920),
                                (400, 2001), (400, 2000), (12000, 10001)])
def test_check_image_dims_matches(hw):
    assert jcfg.check_image_dims(*hw) == tcfg.check_image_dims(*hw)


@pytest.mark.parametrize("knobs", CONFIGS)
def test_octree_geometry_bit_equal(knobs):
    a = jgeom.octree_geometry(jcfg.ReportConfig(**knobs))
    b = tgeom.octree_geometry(tcfg.ReportConfig(**knobs))
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        else:
            assert x == y, field


@pytest.mark.parametrize("shape", [(360, 512), (361, 500), (240, 384)])
@pytest.mark.parametrize("bins", [(72, 40), (24, 10)])
def test_polar_geometry_bit_equal(shape, bins):
    a = jgeom.polar_geometry(*shape, *bins)
    b = tgeom.polar_geometry(*shape, *bins)
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        else:
            assert x == y, field
    num_bins = bins[0] * bins[1]
    for x, y in zip(jgeom.polar_chunk_tables(a.bin_ids, num_bins),
                    tgeom.polar_chunk_tables(b.bin_ids, num_bins)):
        assert np.array_equal(x, y)


def test_newton_int_sqrt_bit_equal():
    vals = np.arange(0, 5000, dtype=np.float64) * 1.37
    assert np.array_equal(jgeom.newton_int_sqrt(vals),
                          tgeom.newton_int_sqrt(vals))


@pytest.mark.parametrize("knobs", CONFIGS[:2])
def test_report_tables_from_numpy_bit_equal_to_build(knobs):
    """The port's own tables equal those carried over from the JAX
    package's ReportTables, leaf for leaf."""
    h, w = 360, 512
    own = tpipe.ReportTables.build(h, w, tcfg.ReportConfig(**knobs))
    carried = tpipe.ReportTables.from_numpy(
        jpipe.ReportTables.build(h, w, jcfg.ReportConfig(**knobs)))
    for part in ("polar", "octree"):
        a, b = getattr(own, part), getattr(carried, part)
        for field in a._fields:
            x, y = getattr(a, field), getattr(b, field)
            if x is None or y is None:      # the gather table, left behind
                assert x is None and y is None, (part, field)
                continue
            assert x.dtype == y.dtype and torch.equal(x, y), (part, field)


@pytest.mark.parametrize("n", [1920, 1080, 1001, 14520])
def test_stage_twiddle_table_entries(n):
    """The row kernel's per-stage twiddles: stage after stage, [q][k] for
    q = 1..r-1 and k < ns, each entry the full table's q k n / (ns r)-th
    value bit for bit, and within float32 rounding of exp(-2 pi i q k /
    (ns r)) in float64."""
    from photohive_dsp_tpu_torch.ops import fft_plan

    full = fft_plan.twiddle_table(n)
    table = fft_plan.stage_twiddle_table(n)
    assert table.dtype == np.float32 and table.shape == (n - 1, 2)
    row, ns = 0, 1
    for r in fft_plan.stage_radices(n):
        assert row == ns - 1
        for q in range(1, r):
            for k in range(ns):
                assert (q * k * n) % (ns * r) == 0
                assert np.array_equal(table[row], full[q * k * n // (ns * r)])
                w = np.exp(-2j * np.pi * q * k / (ns * r))
                assert abs(table[row, 0] - w.real) <= 6e-8
                assert abs(table[row, 1] - w.imag) <= 6e-8
                row += 1
        ns *= r
    assert row == n - 1
    plan = fft_plan.LengthPlan.for_length(n)
    assert np.array_equal(plan.stage_twiddles.numpy(), table)


def test_fixed_point_by_float32_scaling_matches_plain():
    """The palette kernels round x * 2^28 in float32 (csrc/palette.cu
    to_fixed); that product is exact, so it rounds to the integer the plain
    version's float64 product does, ties to even included; and the largest
    value, a hue of 360, is below 2^37, which the kernels' 27-bit split of
    a warp's group sums needs."""
    from photohive_dsp_tpu_torch.ops.fixed_point import FIXED_ONE, to_fixed

    rng = np.random.default_rng(12)
    x = np.concatenate([
        rng.random(200_000, dtype=np.float32) * np.float32(360.0),
        rng.random(200_000, dtype=np.float32),
        np.float32([0.0, 1e-38, 1e-45, 0.999999, 1.0, 180.0, 360.0]),
        # half-way cases of the 2^-28 grid
        (np.arange(1, 2001, dtype=np.float32) + np.float32(0.5))
        / np.float32(FIXED_ONE)])
    scaled = x * np.float32(FIXED_ONE)
    assert np.array_equal(scaled.astype(np.float64),
                          x.astype(np.float64) * FIXED_ONE)
    assert np.array_equal(np.rint(scaled).astype(np.int64),
                          to_fixed(torch.from_numpy(x)).numpy())
    assert int(to_fixed(torch.tensor([360.0]))) < 1 << 37
