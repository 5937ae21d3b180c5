"""The port's row-sharded report (``parallel/spatial.py``) and its flat-HSV
palette kernels against the JAX package on the CPU.

* K9 and K10's plain versions against the JAX package's Pallas kernels
  ``cell_counts_from_hsv`` and ``palette_sums_by_k`` in interpret mode,
  including hue-sentinel pixels (tests/test_pallas_interpret.py:122-214).
* ``sharded_polar_tables`` against the JAX package's.
* The spatial report at 4 gloo ranks against the JAX package's
  ``build_spatial_report`` on a 4-device slice of the CPU mesh, at
  tests/test_sharding.py's bars (at 2 ranks against the port's own
  single-device path: tests/test_torch_spatial_2ranks.py).  The ranks are
  spawned processes (tests/torch_spatial_ranks) with a time limit each.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.ops import pallas_kernels as jpk
from photohive_dsp_tpu.ops import quantize as jq
from photohive_dsp_tpu.parallel import mesh as jmesh
from photohive_dsp_tpu.parallel import spatial as jspatial

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.ops import palette_kernels as tpk
from photohive_dsp_tpu_torch.ops import quantize as tq
from photohive_dsp_tpu_torch.parallel import spatial as tspatial

from .test_sharding import _assert_reports_match
from .torch_spatial_ranks import run_ranks
from .util import structured_image

JCFG, TCFG = ph.ReportConfig(), pt.ReportConfig()
C = TCFG.num_cells


# ------------------------------------------------------------ K9 / K10 ---

def _flat_hsv(seed, b, p_real, p_masked, edges=False):
    """(B, P) h, s, v: random real pixels (optionally snapped onto cell
    edges) then a tail of hue-sentinel pixels with real-looking s and v."""
    rng = np.random.default_rng(seed)
    h = (rng.random((b, p_real)) * 360).astype(np.float32)
    s = (rng.random((b, p_real)) * 0.999).astype(np.float32)
    v = (rng.random((b, p_real)) * 0.999).astype(np.float32)
    if edges:
        s[:, :200] = np.float32(JCFG.gray_thresh)
        v[:, 200:400] = np.float32(JCFG.black_thresh)
        h[:, 400:600] = np.float32(JCFG.cell_Lh) * 3
    tail = rng.random((3, b, p_masked)).astype(np.float32)
    tail[0] = -1.0
    return [np.concatenate([x, t], axis=1) for x, t in zip((h, s, v), tail)]


def test_cell_counts_from_hsv_plain_matches_pallas_interpret():
    """Counts exact, hue-sentinel pixels count for nothing."""
    b, p_real = 2, 5000
    hsv = _flat_hsv(10, b, p_real, 432, edges=True)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpk.cell_counts_from_hsv(
            *(jnp.asarray(x) for x in hsv), JCFG))
    acc = tpk.cell_counts_from_hsv(*(torch.from_numpy(x) for x in hsv), TCFG)
    got, _ = tpk.counts_s_from_fixed(acc)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == b * p_real


def _assignment(h, s, v, total):
    """The JAX package's parent assignment of these pixels, and the port's
    tables built from the same counts and order."""
    cells = jax.vmap(lambda a, b2, c2: jq.assign_cells(a, b2, c2, JCFG))(
        jnp.asarray(h), jnp.asarray(s), jnp.asarray(v))
    counts = jax.vmap(lambda x: jq.cell_counts(x, C))(cells)
    tables = jq.OctreeTables.for_config(JCFG)
    assign = jax.vmap(lambda cnt: jq.parent_assignment(
        cnt, total, JCFG, tables))(counts)
    ttables = tq.OctreeTables.for_config(TCFG)
    tassign = tq.parent_assignment_from_order(
        torch.from_numpy(np.array(counts)),
        torch.from_numpy(np.array(assign.order)), total, TCFG, ttables)
    return tables, assign, ttables, tassign, np.array(counts)


@pytest.mark.parametrize("q", [8, 40])
def test_palette_sums_by_k_plain_matches_pallas_interpret(q):
    """Counts exact; sums within the JAX kernel's bf16-split accuracy
    (0.5 absolute on per-slot sums of a few thousand hues, the bar of
    test_pallas_interpret.py:72); the sentinel tail changes no bit."""
    p_real = 4096
    hsv = _flat_hsv(8, 1, p_real, 1024)
    real = [x[:, :p_real] for x in hsv]
    tables, assign, ttables, tassign, _ = _assignment(*real, p_real)
    with pltpu.force_tpu_interpret_mode():
        luts = jax.vmap(lambda a: jpk.palette_candidate_lut(
            a, tables, C, q))(assign)
        want = np.asarray(jpk.palette_sums_by_k(
            *(jnp.asarray(x) for x in hsv), luts, C, q, JCFG))
    cand, centers = tpk.palette_candidate_table(tassign, ttables, C, q)
    acc = tpk.palette_sums_by_k(*(torch.from_numpy(x) for x in hsv), cand,
                                centers, TCFG)
    alone = tpk.palette_sums_by_k(*(torch.from_numpy(x) for x in real),
                                  cand, centers, TCFG)
    assert torch.equal(acc, alone)
    got = tpk.palette_sums_from_fixed(acc)
    assert np.array_equal(got[..., 3].numpy(), want[..., 3])
    assert np.abs(got.numpy() - want).max() < 0.5
    assert int(got[..., 3].sum()) == p_real


def test_fixed_accumulators_convert_to_the_outputs():
    """K9's and K10's int64 accumulators convert to the counts, the
    saturation sum and the palette sums, and split pixel sets add up to
    the whole exactly (what the ranks' all_reduce relies on)."""
    p = 3000
    hsv = [torch.from_numpy(x) for x in _flat_hsv(4, 1, p, 100)]
    _, _, ttables, tassign, counts = _assignment(
        *(x[:, :p].numpy() for x in hsv), p)
    counts_t = torch.from_numpy(counts)
    halves = [slice(0, 1234), slice(1234, None)]
    whole = tq.palette_sums_by_k_auto(*hsv, tassign, counts_t, TCFG,
                                      ttables)
    parts = [tq.palette_sums_by_k_auto(*(x[:, sl] for x in hsv), tassign,
                                       counts_t, TCFG, ttables)
             for sl in halves]
    assert whole.dtype == torch.int64
    assert torch.equal(parts[0] + parts[1], whole)
    sums = tpk.palette_sums_from_fixed(whole)
    assert sums.dtype == torch.float32
    assert torch.equal(sums[..., 3].long(), whole[..., 3])
    assert int(whole[..., 3].sum()) == p
    acc = tpk.cell_counts_from_hsv(*hsv, TCFG)
    parts = [tpk.cell_counts_from_hsv(*(x[:, sl] for x in hsv), TCFG)
             for sl in halves]
    assert torch.equal(parts[0] + parts[1], acc)
    got_counts, s_sum = tpk.counts_s_from_fixed(acc)
    assert np.array_equal(got_counts.numpy(), counts)
    want_s = hsv[1][:, :p].double().sum(dim=1)
    assert torch.allclose(s_sum.double(), want_s, rtol=1e-7, atol=0)


@pytest.mark.parametrize("h,w,n", [(128, 160, 4), (127, 160, 2),
                                   (61, 80, 3)])
def test_sharded_polar_tables_match_jax(h, w, n):
    want = tspatial.ShardedPolarTables.from_numpy(
        jspatial.sharded_polar_tables(h, w, JCFG.angle_partitions,
                                      JCFG.radius_partitions, n))
    got = tspatial.sharded_polar_tables(h, w, TCFG.angle_partitions,
                                        TCFG.radius_partitions, n)
    assert got.wc == want.wc
    assert np.array_equal(got.flat_ids, want.flat_ids)
    assert np.array_equal(got.counts, want.counts)


# --------------------------------------------------- the spatial report ---

# name -> (height, width, downsample_rate, boxes); rank heights are 32
# (4 ranks) and 64 (2 ranks) at H=128.
SPATIAL_CASES = {
    # a box spanning every rank, one across the row-32 seam, edge boxes
    "span": (128, 160, 1, [(10, 100, 5, 150), (30, 34, 20, 140),
                           (0, 128, 0, 24), (96, 128, 140, 160)]),
    # thin boxes: on the row-64 seam, at the top edge, one pixel at a seam
    "thin": (128, 160, 1, [(10, 100, 5, 150), (63, 65, 0, 160),
                           (0, 1, 0, 160), (64, 65, 10, 11)]),
    # 127 rows: 4 and 2 ranks pad; a box on the true bottom edge
    "ragged": (127, 160, 1, [(40, 127, 10, 150), (0, 20, 100, 160)]),
    # decimated rows 61: the palette's rows pad on their own
    "down2": (122, 160, 2, [(20, 90, 30, 130)]),
}


def _case_inputs(name):
    h, w, rate, bxs = SPATIAL_CASES[name]
    img = structured_image(h, w, seed=5).astype(np.float32)
    boxes, valid = pt.set_bounding_boxes(
        [dict(top=t, bottom=b, left=l, right=r) for t, b, l, r in bxs])
    return img, boxes, valid, pt.ReportConfig(downsample_rate=rate)


@pytest.fixture(scope="module")
def jax_spatial_reports():
    """The JAX package's 4-device spatial report per case, built once."""
    devices = jax.devices()[:4]
    reports = {}
    for name in SPATIAL_CASES:
        img, boxes, valid, _ = _case_inputs(name)
        h, w, rate, _ = SPATIAL_CASES[name]
        m = jmesh.make_mesh(data=1, spatial=4, devices=devices)
        fn = jspatial.build_spatial_report(
            m, h, w, ph.ReportConfig(downsample_rate=rate))
        out = fn(jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid))
        reports[name] = jax.tree.map(np.asarray, out)
    return reports


def _assert_replicated(reports):
    for other in reports[1:]:
        for k, v in reports[0].items():
            assert np.array_equal(v, other[k], equal_nan=True), k


@pytest.mark.parametrize("name", list(SPATIAL_CASES))
def test_spatial_report_4_ranks_matches_jax(name, jax_spatial_reports,
                                            tmp_path):
    img, boxes, valid, cfg = _case_inputs(name)
    reports = run_ranks(4, tmp_path, cfg, img, boxes, valid)
    _assert_replicated(reports)
    _assert_reports_match(jax_spatial_reports[name],
                          SimpleNamespace(**reports[0]))
