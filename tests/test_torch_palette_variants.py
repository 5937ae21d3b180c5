"""The palette kernel variants of the PyTorch port against the JAX package:
the plain versions of K14 (C-wide) and K15 (cell-id histogram) against the
JAX Pallas kernels in interpret mode, with hue sentinels and, for K14, a
cell whose allowed row is empty; K14 against K10; the float32 RGB kernels
(K11-K13, the same plain versions as K1/K3/K4) against the JAX package's
"candidate" kernels; the ``PHOTOHIVE_PALETTE_KERNEL`` switch; and one
report under all three variants.  Tolerances are the JAX package's own
(tests/test_pallas_interpret.py): counts and ids exact, sums < 0.5
absolute, palette HSV < 5e-3; mean saturation within 1e-6 relative."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from photohive_dsp_tpu.config import ReportConfig as JCfg
from photohive_dsp_tpu.ops import pallas_kernels as jpk
from photohive_dsp_tpu.ops import pallas_kernels_cwide as jpkc
from photohive_dsp_tpu.ops import quantize as jq
from photohive_dsp_tpu.ops import stats as jstats

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.config import ReportConfig as TCfg
from photohive_dsp_tpu_torch.ops import _cuda
from photohive_dsp_tpu_torch.ops import palette_kernels as tpk
from photohive_dsp_tpu_torch.ops import quantize as tq
from photohive_dsp_tpu_torch.ops import stats as tstats
from photohive_dsp_tpu_torch.ops.margin_sort import margin_insertion_argsort

from .test_torch_cuda import IMAGES

JCFG, TCFG = JCfg(), TCfg()
C = TCFG.num_cells
VARIANTS = ("bf16", "candidate", "cwide")


@pytest.fixture(scope="module")
def tables():
    return jq.OctreeTables.for_config(JCFG), tq.OctreeTables.for_config(TCFG)


def flat_hsv(seed: int, b: int, p_real: int, p_masked: int):
    """(B, P) float32 h, s, v planes: random real pixels, then a tail of
    hue-sentinel pixels with random s and v."""
    rng = np.random.default_rng(seed)
    h = np.concatenate([rng.random((b, p_real)) * 360,
                        np.full((b, p_masked), -1.0)], axis=1)
    s = rng.random((b, p_real + p_masked)) * 0.999
    v = rng.random((b, p_real + p_masked)) * 0.999
    return [x.astype(np.float32) for x in (h, s, v)], p_real


def torch_assign(hsv, p_real, tabs):
    """The port's parent assignment of flat HSV planes (K9's counts)."""
    h, s, v = (torch.from_numpy(x) for x in hsv)
    counts, _ = tpk.counts_s_from_fixed(tpk.cell_counts_from_hsv(h, s, v,
                                                                 TCFG))
    sal = tq.saliency_f32(counts, tabs[1].s_v_f32, TCFG)
    return counts, tq.parent_assignment_from_order(
        counts, margin_insertion_argsort(sal), p_real, TCFG, tabs[1])


def jax_cwide(hsv, allowed: np.ndarray, centers_by_k: np.ndarray):
    """The JAX C-wide kernel in interpret mode on the given tables."""
    allowed_t = jnp.asarray(np.swapaxes(allowed, 1, 2), jnp.float32)
    cols = [jnp.broadcast_to(jnp.asarray(centers_by_k[..., i])[..., None],
                             centers_by_k.shape[:2] + (128,))
            for i in range(3)]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jpkc.palette_sums_by_k_cwide(
            *(jnp.asarray(x) for x in hsv), allowed_t, *cols, C, JCFG))


def k14_plain(hsv, allowed: np.ndarray, centers_by_k: np.ndarray):
    t = [torch.from_numpy(x) for x in hsv]
    bits = tpk.allowed_bitmask(torch.from_numpy(allowed))
    return tpk.palette_sums_by_k_cwide(*t, bits,
                                       torch.from_numpy(centers_by_k), TCFG)


@pytest.mark.parametrize("empty_row", [False, True],
                         ids=["allowed_rows", "empty_row"])
def test_k14_plain_matches_jax_cwide_kernel(empty_row, tables):
    """With a populated cell's allowed row emptied, both send that cell's
    pixels to slot 0 (the JAX kernel masks with a finite value)."""
    hsv, p_real = flat_hsv(6, 2, 64 * 128, 1024)
    counts, assign = torch_assign(hsv, p_real, tables)
    allowed = assign.allowed.numpy().copy()
    centers_by_k = tables[1].centers[assign.order].numpy()
    if empty_row:
        cell = int(counts[0].argmax())
        allowed[:, cell] = False
    got = tpk.palette_sums_from_fixed(k14_plain(hsv, allowed, centers_by_k))
    want = jax_cwide(hsv, allowed, centers_by_k)
    assert np.array_equal(got[..., 3].numpy(), want[..., 3])
    assert np.abs(got.numpy() - want).max() < 0.5
    assert got[..., 3].sum() == 2 * p_real
    if empty_row:
        # K10 has no candidate for that cell and drops its pixels.
        cand, ctr = tpk.palette_candidate_table(
            assign._replace(allowed=torch.from_numpy(allowed)), tables[1], C,
            40)
        k10 = tpk.palette_sums_by_k(*(torch.from_numpy(x) for x in hsv),
                                    cand, ctr, TCFG)
        assert int(got[0, 0, 3] - k10[0, 0, 3]) == int(counts[0, cell])


@pytest.mark.parametrize("name", ["noise", "wheel"])
def test_k14_plain_equals_k10_plain(name, tables):
    """Wherever K10's candidates hold every allowed parent, K14's
    accumulator equals K10's bit for bit (sentinel tail included)."""
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv

    rgb, tier = IMAGES[name]
    x = torch.from_numpy(rgb)
    b, p = x.shape[0], x.shape[2] * x.shape[3]
    real = rgb_to_hsv(*x.reshape(b, 3, p).unbind(1))
    tail = torch.from_numpy(np.random.default_rng(1).random(
        (3, b, 300)).astype(np.float32))
    tail[0] = -1.0
    hsv = [torch.cat([r, t], dim=1).contiguous() for r, t in zip(real, tail)]
    counts, _ = tpk.counts_s_from_fixed(tpk.cell_counts_from_hsv(*hsv, TCFG))
    sal = tq.saliency_f32(counts, tables[1].s_v_f32, TCFG)
    assign = tq.parent_assignment_from_order(
        counts, margin_insertion_argsort(sal), p, TCFG, tables[1])
    k10 = tpk.palette_sums_by_k(*hsv, *tpk.palette_candidate_table(
        assign, tables[1], C, max(tier, 8)), TCFG)
    assert torch.equal(tpk.palette_sums_by_k_cwide(
        *hsv, *tpk.cwide_tables(assign, tables[1]), TCFG), k10)


def test_allowed_bitmask_round_trip():
    rng = np.random.default_rng(2)
    for c in (C, 75, 32, 2164 // 10):
        allowed = torch.from_numpy(rng.random((2, c, c)) < 0.3)
        bits = tpk.allowed_bitmask(allowed)
        assert bits.dtype == torch.int32
        assert bits.shape == (2, c, -(-c // 32))
        assert torch.equal(tpk.unpack_allowed(bits, c), allowed)


def test_k15_plain_matches_jax_kernel():
    """Ids outside [0, C) (the JAX wrapper's padding value C, larger ones,
    negative ones) count for nothing in both."""
    rng = np.random.default_rng(3)
    cells = rng.integers(0, C, (2, 12345)).astype(np.int32)
    cells[:, :300] = C
    cells[0, 300:400] = C + 7
    cells[1, 400:450] = -1
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpk.cell_counts_batched(jnp.asarray(cells), C))
    got = tpk.cell_counts_batched(torch.from_numpy(cells), C)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert got[0].sum() == 12345 - 400 and got[1].sum() == 12345 - 350


def jax_assign(counts, total, tabs):
    """The JAX package's parent assignment, its saliency jitted with the
    tables as arguments, as get_report runs it (XLA contracts the weight
    into an FMA)."""
    sal = jax.jit(jax.vmap(lambda x, sv: jq.saliency_f32(x, sv, JCFG),
                           in_axes=(0, None)))(counts, tabs[0].s_v_f32)
    order = jax.vmap(jq.margin_insertion_argsort)(sal)
    return jax.vmap(lambda cnt, o: jq.parent_assignment_from_order(
        cnt, o, total, JCFG, tabs[0]))(counts, order)


@pytest.mark.parametrize("name", list(IMAGES))
def test_f32_plain_matches_jax_candidate_kernels(name, tables):
    """K11 (counts, saturation sum) and, at the image's own tier, K12
    (q=1) or K13 (q=8, q_full) on float32 planes against the JAX
    package's candidate kernels."""
    rgb, tier = IMAGES[name]
    total = rgb.shape[2] * rgb.shape[3]
    x = torch.from_numpy(rgb)
    with pltpu.force_tpu_interpret_mode():
        jc, js = jpk.cell_counts_s_from_rgb(jnp.asarray(rgb), JCFG)
    tc, ts = tpk.cell_counts_s_from_rgb(x, TCFG)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.abs(ts.numpy() / np.asarray(js) - 1).max() < 1e-6
    ja = jax_assign(jnp.asarray(tc.numpy()), total, tables)
    sal = tq.saliency_f32(tc, tables[1].s_v_f32, TCFG)
    ta = tq.parent_assignment_from_order(tc, margin_insertion_argsort(sal),
                                         total, TCFG, tables[1])
    with pltpu.force_tpu_interpret_mode():
        if tier == 1:
            want = jpk.palette_sums_by_k_rgb_q1(jnp.asarray(rgb), ja,
                                                tables[0], C, JCFG)
        else:
            luts = jax.vmap(lambda a: jpk.palette_candidate_lut(
                a, tables[0], C, tier))(ja)
            want = jpk.palette_sums_by_k_rgb(jnp.asarray(rgb), luts, C, tier,
                                             JCFG)
    if tier == 1:
        got = tpk.palette_sums_by_k_rgb_q1(
            x, *tpk.palette_offset_table(ta, tables[1], C), TCFG)
    else:
        got = tpk.palette_sums_by_k_rgb(
            x, *tpk.palette_candidate_table(ta, tables[1], C, tier), TCFG)
    want = np.asarray(want)
    assert np.array_equal(got[..., 3].numpy(), want[..., 3])
    assert np.abs(got.numpy() - want).max() < 0.5


def test_palette_kernel_variant(monkeypatch):
    monkeypatch.delenv("PHOTOHIVE_PALETTE_KERNEL", raising=False)
    assert tq.palette_kernel_variant() == "bf16"
    for v in VARIANTS:
        monkeypatch.setenv("PHOTOHIVE_PALETTE_KERNEL", v)
        assert tq.palette_kernel_variant() == v
    # The JAX package takes an unknown value as "candidate"; the port
    # refuses it.
    monkeypatch.setenv("PHOTOHIVE_PALETTE_KERNEL", "candidat")
    assert jq.palette_kernel_variant() == "candidat"
    with pytest.raises(ValueError, match="PHOTOHIVE_PALETTE_KERNEL"):
        tq.palette_kernel_variant()


def test_mean_saturation_matches_jax():
    s = np.random.default_rng(4).random((2, 96, 128)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jstats.mean_saturation))(
        jnp.asarray(s)))
    got = tstats.mean_saturation(torch.from_numpy(s)).numpy()
    assert np.abs(got / want - 1).max() < 1e-6


def test_flat_palette_matches_jax_cwide_route(tables, monkeypatch):
    """color_palette_batched under cwide (K9, K14) against the JAX
    package's flat Pallas route under cwide, in interpret mode."""
    monkeypatch.setenv("PHOTOHIVE_PALETTE_KERNEL", "cwide")  # the JAX side
    rng = np.random.default_rng(7)
    h, s, v = (rng.random((1, 64, 128)).astype(np.float32) * k
               for k in (360, 0.999, 0.999))
    with pltpu.force_tpu_interpret_mode():
        want = jq.color_palette_batched(jnp.asarray(h), jnp.asarray(s),
                                        jnp.asarray(v), JCFG, tables[0], True)
    got = tq.color_palette_batched(torch.from_numpy(h), torch.from_numpy(s),
                                   torch.from_numpy(v), TCFG, tables[1],
                                   "cwide")
    assert np.array_equal(got.parent_ids.numpy(), np.asarray(want.parent_ids))
    assert np.array_equal(got.percentages.numpy(),
                          np.asarray(want.percentages))
    assert np.abs(got.hsv.numpy() - np.asarray(want.hsv)).max() < 5e-3


def test_full_report_batched_same_under_every_variant(monkeypatch):
    """One uint8 batch (two hue-wheel images, the q_full tier, and two
    noise images) with a box, under each variant: every field equal at
    the acceptance bars."""
    wheel, _ = IMAGES["wheel"]
    noise = np.random.default_rng(8).random(wheel.shape, dtype=np.float32)
    u8 = np.round(np.concatenate([wheel, noise]) * 255).astype(np.uint8)
    tables = pt.ReportTables.build(u8.shape[2], u8.shape[3], TCFG)
    boxes = np.zeros((4, 10, 4), np.int32)
    boxes[:, 0] = (4, 28, 10, 200)
    valid = np.zeros((4, 10), bool)
    valid[:, 0] = True
    out = {}
    for v in VARIANTS:
        monkeypatch.setenv("PHOTOHIVE_PALETTE_KERNEL", v)
        out[v] = pt.full_report_batched(torch.from_numpy(u8), boxes, valid,
                                        tables, TCFG)
    ref = out["bf16"]
    for v in VARIANTS[1:]:
        got = out[v]
        for k in ("palette_ids", "palette_n", "palette_pct", "rgb_stats",
                  "sharpness", "blur_bins", "blur_vector_angles",
                  "blur_vector_mags"):
            assert torch.equal(getattr(got, k), getattr(ref, k)), (v, k)
        assert float((got.palette_hsv - ref.palette_hsv).abs().max()) < 5e-3
        sat = (got.average_saturation / ref.average_saturation - 1).abs()
        assert float(sat.max()) < 1e-6


def test_no_launch_counted_on_the_cpu(tables):
    before = dict(_cuda.LAUNCHES)
    hsv, p_real = flat_hsv(9, 1, 2048, 64)
    _, assign = torch_assign(hsv, p_real, tables)
    t = [torch.from_numpy(x) for x in hsv]
    tpk.palette_sums_by_k_cwide(*t, *tpk.cwide_tables(assign, tables[1]),
                                TCFG)
    tpk.cell_counts_batched(torch.zeros((1, 10), dtype=torch.int32), C)
    tpk.cell_counts_s_from_rgb(torch.from_numpy(IMAGES["noise"][0]), TCFG)
    with pytest.raises(ValueError):
        tpk.palette_sums_by_k_cwide(*t, assign.allowed.int(),
                                    tables[1].centers[assign.order], TCFG)
    with pytest.raises(TypeError):
        tpk.cell_counts_batched(torch.zeros((1, 10), dtype=torch.int64), C)
    assert _cuda.LAUNCHES == before
