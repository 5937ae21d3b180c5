"""The port's blur-profile stage against the JAX package on the CPU: the
FFT plan and gate, the FFT kernels' plain version (K6a/K6b) against float64
and against ``pallas_fft.magnitude2_scrambled`` in interpret mode, the
polar kernel's plain version (K7+K8) against ``polar_bin_sums_local``, and
``blur_bins_lognorm`` against ``blur_bins_scrambled_lognorm``."""

from . import torch_threads  # noqa: F401 (this worker's cores)

from pathlib import Path

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
from photohive_dsp_tpu_torch.ops.blur import PolarTables, bin_means, \
    blur_bins_lognorm, lognorm_bin_means

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
        torch.from_numpy(mag2), torch.from_numpy(ids), nb)[0].numpy()
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


def _spectrum(b=2, h=120, w=160, seed=7):
    """(B, H * (W // 2 + 1)) |X|^2 of noise, and the polar tables."""
    x = np.random.default_rng(seed).standard_normal((b, h, w)).astype(
        np.float32)
    plan = fft_plan.FftPlan.for_shape(h, w)
    mag2 = tfk.magnitude2_plain(torch.from_numpy(x), plan).reshape(b, -1)
    return mag2, PolarTables.for_shape(h, w, TCfg())


@pytest.mark.parametrize("case", ["one bin", "below the gate"])
def test_polar_plain_max_is_amax(case):
    """The plain version's maximum is amax over each image: on a spectrum
    whose pixels are all in one bin (one run a warp in the kernel), and on
    one below the gate everywhere (every sum 0)."""
    mag2, tables = _spectrum()
    nb = tables.bin_counts.shape[0]
    ids = tables.bin_ids
    if case == "one bin":
        ids = torch.full_like(ids, nb // 2)
    else:
        mag2 = mag2 / (mag2.amax() * 1.5)
    for fixed in (False, True):
        sums, mx = tpolar.polar_bin_sums_lognorm(mag2, ids, nb, fixed=fixed)
        assert torch.equal(mx, mag2.amax(dim=1))
        assert sums.shape == (2, nb)
        if case == "one bin":
            assert not bool(sums[:, nb // 2 + 1:].any())
            assert bool((sums[:, nb // 2] > 0).all())
        else:
            assert not bool(sums.any())


def test_lognorm_bin_means_is_the_old_composition():
    """blur.lognorm_bin_means on the means route equals, bit for bit, the
    composition it replaced: the sums times the gain of amax, then the
    means (and a zero spectrum gives zeros)."""
    mag2, tables = _spectrum()
    a, r = TCfg().angle_partitions, TCfg().radius_partitions
    for m in (mag2, torch.zeros_like(mag2)):
        sums, _ = tpolar.polar_bin_sums_lognorm_plain(m, tables.bin_ids,
                                                      a * r)
        want = bin_means(sums * tpolar.lognorm_gain(m.amax(dim=1))[:, None],
                         tables.bin_counts, a, r)
        got = lognorm_bin_means(m, tables, a, r)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)


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


def _dft(vr, vi, r, lp):
    """K6a's r-point DFT: ascending q, the multiply skipped where q t = 0
    mod r, and for r = 2 and 4 additions only (their twiddles are exactly
    1, -i, -1, i)."""
    if r == 1:
        return [(vr[0], vi[0])]
    if r == 2:
        return [(vr[0] + vr[1], vi[0] + vi[1]),
                (vr[0] - vr[1], vi[0] - vi[1])]
    if r == 4:
        return [(((vr[0] + vr[1]) + vr[2]) + vr[3],
                 ((vi[0] + vi[1]) + vi[2]) + vi[3]),
                (((vr[0] + vi[1]) - vr[2]) - vi[3],
                 ((vi[0] - vr[1]) - vi[2]) + vr[3]),
                (((vr[0] - vr[1]) + vr[2]) - vr[3],
                 ((vi[0] - vi[1]) + vi[2]) - vi[3]),
                (((vr[0] - vi[1]) - vr[2]) + vi[3],
                 ((vi[0] + vr[1]) - vi[2]) - vr[3])]
    m = lp.n // r
    twr, twi = lp.twiddles[:, 0], lp.twiddles[:, 1]
    outs = []
    for t in range(r):
        ar, ai = vr[0], vi[0]
        for q in range(1, r):
            u = (q * t) % r
            if u == 0:
                ar, ai = ar + vr[q], ai + vi[q]
            else:
                pr, pi = tfk._cmul(vr[q], vi[q], twr[u * m], twi[u * m])
                ar, ai = ar + pr, ai + pi
        outs.append((ar, ai))
    return outs


def _twiddled(vr, vi, stw, first, span, k):
    """v_q times the per-stage twiddle stw[first + (q - 1) span + k] for q
    >= 1, the multiply skipped where k = 0."""
    vr, vi = list(vr), list(vi)
    for q in range(1, len(vr)):
        w = stw[first + (q - 1) * span + k]
        pr, pi = tfk._cmul(vr[q], vi[q], w[:, 0], w[:, 1])
        vr[q] = torch.where(k > 0, pr, vr[q])
        vi[q] = torch.where(k > 0, pi, vi[q])
    return vr, vi


def _row_kernel_schedule(re, im, lp):
    """K6a's arithmetic as csrc/fft.cu row_pass orders it, in torch: passes
    of one stage or of two fused stages (fft_plan.row_passes), item g of a
    pass after span ns doing the R2 first-stage DFTs of its R1 R2 values,
    then R1 second-stage DFTs, each stage's twiddles from the per-stage
    table."""
    n, rows, ns = lp.n, re.shape[0], 1
    stw = lp.stage_twiddles
    for r1, r2 in fft_plan.row_passes(lp.radices):
        items, m1, ns1 = n // (r1 * r2), n // r1, ns * r1
        g = torch.arange(items)
        k, a = g % ns, g // ns
        u = []
        for p in range(r2):
            j = g + p * items
            vr, vi = _twiddled([re[:, j + q * m1] for q in range(r1)],
                               [im[:, j + q * m1] for q in range(r1)],
                               stw, ns - 1, ns, k)
            u.append(_dft(vr, vi, r1, lp))
        out_r, out_i = torch.empty_like(re), torch.empty_like(im)
        base = a * ns1 * r2 + k
        for t in range(r1):
            vr, vi = _twiddled([u[p][t][0] for p in range(r2)],
                               [u[p][t][1] for p in range(r2)],
                               stw, ns1 - 1, ns1, t * ns + k)
            for tt, (yr, yi) in enumerate(_dft(vr, vi, r2, lp)):
                out_r[:, base + tt * ns1 + t * ns] = yr
                out_i[:, base + tt * ns1 + t * ns] = yi
        re, im = out_r, out_i
        ns *= r1 * r2
    return re, im


@pytest.mark.parametrize("n", [1920, 1080, 1001, 64, 12, 2, 14520, 640, 15])
def test_row_kernel_schedule_matches_plain(n):
    """K6a's schedule gives stockham_plain's values bit for bit (torch.equal:
    only the sign of an exact zero may differ), zeros in the input
    included, so the kernel is still held to fft_rows_plain."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((6, n)).astype(np.float32)
    x[1] = 0.0
    x[2, ::3] = 0.0
    re, im = torch.from_numpy(x[0::2]), torch.from_numpy(x[1::2])
    lp = fft_plan.LengthPlan.for_length(n)
    got = _row_kernel_schedule(re, im, lp)
    want = tfk.stockham_plain(re, im, lp)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _col_at(i, l, lane_bits):
    """csrc/fft.cu col_at: row i of column l in a tile buffer, the row
    XOR-swizzled by its bits 3 and 4 within a 128-byte line."""
    return ((i ^ (((i >> 3) ^ (i >> 4)) & ((16 >> lane_bits) - 1)))
            << lane_bits) | l


def _col_kernel_schedule(spec, lp):
    """K6b's arithmetic as csrc/fft.cu fft_cols_kernel orders it, in torch:
    the half spectrum cut into tiles of fft_plan.col_tile's lanes (zeros
    past the last column), the passes of fft_plan.row_passes with
    row_pass's item order and per-stage twiddles, the first pass reading
    the columns, the last writing |y|^2, and the passes between going
    through tile buffers of ``seq`` slots laid out by col_at.  Each buffer
    starts as NaN, so a read of a slot no pass wrote shows."""
    b, n, half, _ = spec.shape
    tile = fft_plan.col_tile(n)
    lanes, lb = tile.lanes, tile.lane_bits
    tiles = -(-half // lanes)
    cols = torch.zeros((b, n, tiles * lanes, 2))
    cols[:, :, :half] = spec
    # (N, lanes, n): the columns of each tile.
    cols = cols.reshape(b, n, tiles, lanes, 2).permute(0, 2, 3, 1, 4)
    xr = cols[..., 0].reshape(-1, lanes, n)
    xi = cols[..., 1].reshape(-1, lanes, n)
    lane = torch.arange(lanes)[:, None]
    stw = lp.stage_twiddles
    passes = fft_plan.row_passes(lp.radices)
    if not passes:
        out = xr * xr + xi * xi
    ns = 1
    for pi, (r1, r2) in enumerate(passes):
        items, m1, ns1 = n // (r1 * r2), n // r1, ns * r1
        g = torch.arange(items)
        k, a = g % ns, g // ns

        def read(i):
            if pi == 0:
                return xr[:, :, i], xi[:, :, i]
            at = _col_at(i[None, :], lane, lb)
            return buf_r[:, at], buf_i[:, at]

        u = []
        for p in range(r2):
            j = g + p * items
            vals = [read(j + q * m1) for q in range(r1)]
            vr, vi = _twiddled([v[0] for v in vals], [v[1] for v in vals],
                               stw, ns - 1, ns, k)
            u.append(_dft(vr, vi, r1, lp))
        last = pi == len(passes) - 1
        if last:
            out = torch.full_like(xr, float("nan"))
        else:
            new_r = torch.full((xr.shape[0], tile.seq), float("nan"))
            new_i = torch.full_like(new_r, float("nan"))
        base = a * ns1 * r2 + k
        for t in range(r1):
            vr, vi = _twiddled([u[p][t][0] for p in range(r2)],
                               [u[p][t][1] for p in range(r2)],
                               stw, ns1 - 1, ns1, t * ns + k)
            for tt, (yr, yi) in enumerate(_dft(vr, vi, r2, lp)):
                i = base + tt * ns1 + t * ns
                if last:
                    out[:, :, i] = yr * yr + yi * yi
                else:
                    at = _col_at(i[None, :], lane, lb)
                    new_r[:, at], new_i[:, at] = yr, yi
        if not last:
            buf_r, buf_i = new_r, new_i
        ns *= r1 * r2
    out = out.reshape(b, tiles, lanes, n).permute(0, 3, 1, 2)
    return out.reshape(b, n, tiles * lanes)[:, :, :half]


@pytest.mark.parametrize("n", [1080, 2160, 1092, 720, 480, 143, 1001, 14520,
                               15, 2, 1])
def test_col_kernel_schedule_matches_plain(n):
    """K6b's schedule (passes, twiddle indexing, tile layout) gives
    fft_cols_plain's |X|^2 bit for bit, zero rows and a zero column in the
    input included, on a half width that is no multiple of the tile."""
    rng = np.random.default_rng(n)
    w = 9                                   # half = 5
    spec = rng.standard_normal((2, n, w // 2 + 1, 2)).astype(np.float32)
    spec[0, :, 0] = 0.0
    spec[1, ::3] = 0.0
    spec = torch.from_numpy(spec)
    plan = fft_plan.FftPlan.for_shape(n, w)
    got = _col_kernel_schedule(spec, plan.cols)
    assert torch.equal(got, tfk.fft_cols_plain(spec, plan))


def _admitted_lengths():
    return [n for n in range(1, fft_plan.MAX_LENGTH + 1)
            if fft_plan.factor(n) is not None]


def test_col_tile_fits_and_lays_out_every_admitted_height():
    """For every length the gate admits: the column tile fits an H100
    block's shared memory (csrc/fft.cu kMaxShared), a block's threads
    (kColThreads) split evenly over its columns, its buffer holds every
    (row, column) of the tile at a slot of its own (col_at is one to one
    into seq), the twiddle table's room holds the n - 1 stage twiddles,
    and the passes run every stage radix in order."""
    src = (Path(fft_plan.__file__).parent.parent / "csrc" / "fft.cu"
           ).read_text()
    assert f"kMaxShared = {fft_plan.MAX_SHARED};" in src
    assert f"kColThreads = {fft_plan.COL_THREADS};" in src
    lengths = _admitted_lengths()
    assert len(lengths) == 858 and lengths[-1] == 14520
    for n in lengths:
        tile = fft_plan.col_tile(n)
        assert tile.bytes <= fft_plan.MAX_SHARED
        assert tile.bytes == 8 * tile.tw_len * tile.stw_shared + 16 * tile.seq
        assert tile.tw_len % 2 == 0 and tile.tw_len >= n - 1
        assert tile.seq % 16 == 0 and fft_plan.COL_THREADS % tile.lanes == 0
        at = _col_at(np.arange(n)[:, None], np.arange(tile.lanes)[None, :],
                     tile.lane_bits)
        assert at.max() < tile.seq and np.unique(at).size == at.size
        passes = fft_plan.row_passes(fft_plan.stage_radices(n))
        assert all(p in fft_plan.FUSED_PAIRS or p[1] == 1 for p in passes)
        assert tuple(r for p in passes for r in p if r > 1) == \
            fft_plan.stage_radices(n)


@pytest.mark.parametrize("n,lanes,shared", [(1080, 8, True), (1092, 8, True),
                                            (1001, 8, True), (2160, 4, True),
                                            (4320, 2, True), (7000, 1, True),
                                            (9680, 1, True),
                                            (14520, 1, False)])
def test_col_tile_widest_that_fits(n, lanes, shared):
    """col_tile takes the widest tile of at most 8 columns whose buffers
    and twiddle table fit a block's shared memory; past one column, it
    moves the table to device memory."""
    tile = fft_plan.col_tile(n)
    assert (tile.lanes, tile.stw_shared) == (lanes, shared)
    assert tile.bytes <= fft_plan.MAX_SHARED
    if lanes < 8:
        wider = ((2 * lanes * n + 15) & ~15) * 16 + 8 * tile.tw_len
        assert wider > fft_plan.MAX_SHARED
