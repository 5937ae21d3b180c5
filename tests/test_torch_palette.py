"""The PyTorch port's palette stage against the JAX package: cell ids, the
plain versions of K1-K4 against the JAX Pallas kernels run in interpret
mode (as tests/test_pallas_interpret.py runs them), and the whole palette
against the JAX XLA path.  Tolerances are the JAX package's own: ids, counts
and percentages exactly equal, palette HSV < 5e-3, sums < 0.5 absolute
(test_pallas_interpret.py:43-46,70-72).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from photohive_dsp_tpu.config import ReportConfig as JCfg
from photohive_dsp_tpu.ops import pallas_kernels as jpk
from photohive_dsp_tpu.ops import pallas_kernels_bf16 as jpkv
from photohive_dsp_tpu.ops import quantize as jq
from photohive_dsp_tpu.ops.colorspace import rgb_to_hsv as j_rgb_to_hsv

from photohive_dsp_tpu_torch.config import ReportConfig as TCfg
from photohive_dsp_tpu_torch.ops import _cuda
from photohive_dsp_tpu_torch.ops import palette_kernels as tpk
from photohive_dsp_tpu_torch.ops import quantize as tq
from photohive_dsp_tpu_torch.ops.margin_sort import (
    margin_insertion_argsort, margin_sort)

from .test_torch_cuda import IMAGES, noise_rgb

JCFG, TCFG = JCfg(), TCfg()
C = TCFG.num_cells


@pytest.fixture(scope="module")
def tables():
    return jq.OctreeTables.for_config(JCFG), tq.OctreeTables.for_config(TCFG)


def jax_assign(counts, total, tabs):
    """The JAX package's parent assignment, its saliency jitted with the
    tables as arguments, as get_report runs it (XLA contracts the weight
    into an FMA; tables closed over would be folded unfused)."""
    jt = tabs[0]
    sal = jax.jit(jax.vmap(lambda x, sv: jq.saliency_f32(x, sv, JCFG),
                           in_axes=(0, None)))(counts, jt.s_v_f32)
    order = jax.vmap(jq.margin_insertion_argsort)(sal)
    return sal, jax.vmap(lambda cnt, o: jq.parent_assignment_from_order(
        cnt, o, total, JCFG, jt))(counts, order)


def torch_assign(counts, total, tabs):
    tt = tabs[1]
    sal = tq.saliency_f32(counts, tt.s_v_f32, TCFG)
    return sal, tq.parent_assignment_from_order(
        counts, margin_insertion_argsort(sal), total, TCFG, tt)


@pytest.mark.parametrize("knobs", [{}, dict(h_partitions=12, s_partitions=3,
                                               v_partitions=2)])
def test_assign_cells_bit_equal(knobs):
    """Against the JAX function run eagerly, which divides as IEEE does.
    (Under jit, XLA multiplies by the divisors' reciprocals instead; on u8
    pixels that changes no cell for the default grid, see ROADMAP.md.)"""
    jcfg, tcfg = JCfg(**knobs), TCfg(**knobs)
    rng = np.random.default_rng(10)
    h = rng.random(5000).astype(np.float32) * 360
    s = rng.random(5000).astype(np.float32) * 0.999
    v = rng.random(5000).astype(np.float32) * 0.999
    # cell-edge values where the divide/clip rounding matters
    s[:200] = np.float32(jcfg.gray_thresh)
    v[200:400] = np.float32(jcfg.black_thresh)
    h[400:600] = np.float32(jcfg.cell_Lh) * 3
    v[600:800] = np.float32(jcfg.black_thresh) + np.float32(jcfg.cell_Lv)
    s[800:1000] = np.float32(jcfg.gray_thresh) + np.float32(jcfg.cell_Ls)
    h[1000:1200] = np.float32(359.99997)
    want = np.asarray(jq.assign_cells(jnp.asarray(h), jnp.asarray(s),
                                      jnp.asarray(v), jcfg))
    got = tq.assign_cells(torch.from_numpy(h), torch.from_numpy(s),
                          torch.from_numpy(v), tcfg).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_k1_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(17)
    u8 = rng.integers(0, 256, (2, 3, 16, 256)).astype(np.uint8)
    rgb = u8 if dtype == "u8" else rng.random((2, 3, 16, 256)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        jc, js = jpkv.cell_counts_s_from_rgb(jnp.asarray(rgb), JCFG)
    tc, ts = tpk.cell_counts_s_from_rgb(torch.from_numpy(rgb), TCFG)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.abs(ts.numpy() / np.asarray(js) - 1).max() < 1e-6


@pytest.mark.parametrize("c", [C, 600])
def test_k2_plain_matches_jax(c):
    """At the default C against the Pallas kernel; above its 512-cell
    limit against the JAX package's fori_loop."""
    rng = np.random.default_rng(4)
    sal = (np.round(rng.random((4, c)) * 30)
           + rng.random((4, c)) * 0.6).astype(np.float32)
    if c <= 512:
        with pltpu.force_tpu_interpret_mode():
            want = jpk.margin_sort(jnp.asarray(sal))
    else:
        want = jax.vmap(jq.margin_insertion_argsort)(jnp.asarray(sal))
    got = margin_sort(torch.from_numpy(sal))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(IMAGES))
def test_assignment_and_candidates_bit_equal(name, tables):
    rgb, _ = IMAGES[name]
    total = rgb.shape[2] * rgb.shape[3]
    counts, _ = tpk.cell_counts_s_from_rgb(torch.from_numpy(rgb), TCFG)
    jsal, ja = jax_assign(jnp.asarray(counts.numpy()), total, tables)
    tsal, ta = torch_assign(counts, total, tables)
    assert np.array_equal(tsal.numpy(), np.asarray(jsal))
    for field in ja._fields:
        assert np.array_equal(getattr(ta, field).numpy(),
                              np.asarray(getattr(ja, field))), field
    for q in (1, 8, 40):
        want = jax.vmap(lambda a: jq.candidate_slots(a, C, q))(ja)
        assert np.array_equal(tq.candidate_slots(ta, C, q).numpy(),
                              np.asarray(want))


def _sums_close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert np.array_equal(got[..., 3], want[..., 3])        # counts exact
    assert np.abs(got - want).max() < 0.5


def test_k3_plain_matches_jax_kernel_on_q1_image(tables):
    rgb, _ = IMAGES["smooth"]
    total = rgb.shape[2] * rgb.shape[3]
    counts, _ = tpk.cell_counts_s_from_rgb(torch.from_numpy(rgb), TCFG)
    _, ja = jax_assign(jnp.asarray(counts.numpy()), total, tables)
    _, ta = torch_assign(counts, total, tables)
    assert tq.palette_tier(counts, ta, TCFG) == 1
    with pltpu.force_tpu_interpret_mode():
        want = jpkv.palette_sums_by_k_rgb_q1(jnp.asarray(rgb), ja, tables[0],
                                             C, JCFG)
    slot, off = tpk.palette_offset_table(ta, tables[1], C)
    _sums_close(tpk.palette_sums_by_k_rgb_q1(torch.from_numpy(rgb), slot,
                                             off, TCFG), want)


@pytest.mark.parametrize("name,q", [("noise", 8), ("wheel", 40)])
def test_k4_plain_matches_jax_kernel(name, q, tables):
    rgb, _ = IMAGES[name]
    total = rgb.shape[2] * rgb.shape[3]
    counts, _ = tpk.cell_counts_s_from_rgb(torch.from_numpy(rgb), TCFG)
    _, ja = jax_assign(jnp.asarray(counts.numpy()), total, tables)
    _, ta = torch_assign(counts, total, tables)
    with pltpu.force_tpu_interpret_mode():
        luts = jax.vmap(lambda a: jpk.palette_candidate_lut(
            a, tables[0], C, q))(ja)
        want = jpkv.palette_sums_by_k_rgb(jnp.asarray(rgb), luts, C, q, JCFG)
    cand, ctr = tpk.palette_candidate_table(ta, tables[1], C, q)
    _sums_close(tpk.palette_sums_by_k_rgb(torch.from_numpy(rgb), cand, ctr,
                                          TCFG), want)


@pytest.mark.parametrize("name", list(IMAGES))
@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_palette_matches_jax_xla_path(name, dtype, tables):
    """The whole palette stage, with its tier switch, against the JAX
    package's XLA palette on the same pixels, jitted as get_report runs
    it (XLA turns the percentages' division by the constant pixel count
    into a multiply by its reciprocal; the port does the same)."""
    rgb, tier = IMAGES[name]
    if dtype == "u8":
        rgb_in = np.round(rgb * 255).astype(np.uint8)
        rgb = rgb_in.astype(np.float32) / np.float32(255)
    else:
        rgb_in = rgb
    pal, s_sum = tq.color_palette_batched_from_rgb(torch.from_numpy(rgb_in),
                                                   TCFG, tables[1])
    h, s, v = jax.vmap(lambda x: j_rgb_to_hsv(x[0], x[1], x[2]))(
        jnp.asarray(rgb))
    want = jax.jit(lambda a, b, c: jq.color_palette_batched(
        a, b, c, JCFG, tables[0], False))(h, s, v)
    assert np.array_equal(pal.parent_ids.numpy(),
                          np.asarray(want.parent_ids))
    assert np.array_equal(pal.n_valid.numpy(), np.asarray(want.n_valid))
    assert np.array_equal(pal.percentages.numpy(),
                          np.asarray(want.percentages))
    assert np.abs(pal.hsv.numpy() - np.asarray(want.hsv)).max() < 5e-3
    # exact sum of the JAX package's saturation plane
    s_ref = np.asarray(s, np.float64).sum(axis=(1, 2))
    assert np.abs(s_sum.numpy() / s_ref - 1).max() < 1e-6


@pytest.mark.parametrize("name", list(IMAGES))
def test_images_take_their_tier(name, tables):
    rgb, tier = IMAGES[name]
    counts, _ = tpk.cell_counts_s_from_rgb(torch.from_numpy(rgb), TCFG)
    _, ta = torch_assign(counts, rgb.shape[2] * rgb.shape[3], tables)
    assert tq.palette_tier(counts, ta, TCFG) == tier


def test_wrappers_validate_inputs_and_count_no_cpu_launch(tables):
    rgb = torch.from_numpy(noise_rgb(1, 8, 16))
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(TypeError):
        tpk.cell_counts_s_from_rgb(rgb.double(), TCFG)
    with pytest.raises(ValueError):
        tpk.cell_counts_s_from_rgb(rgb[:, :2], TCFG)
    with pytest.raises(TypeError):
        margin_sort(torch.zeros((1, C), dtype=torch.float64))
    counts, _ = tpk.cell_counts_s_from_rgb(rgb, TCFG)
    _, ta = torch_assign(counts, 8 * 16, tables)
    cand, ctr = tpk.palette_candidate_table(ta, tables[1], C, 8)
    with pytest.raises(ValueError):
        tpk.palette_sums_by_k_rgb(rgb, cand[:, :-1], ctr, TCFG)
    with pytest.raises(TypeError):
        tpk.palette_sums_by_k_rgb(rgb, cand.long(), ctr, TCFG)
    tpk.palette_sums_by_k_rgb(rgb, cand, ctr, TCFG)
    assert _cuda.LAUNCHES == before
