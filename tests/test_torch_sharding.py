"""The port's data-parallel and dp x spatial layer (``parallel/mesh.py``,
``parallel/sharding.py``, ``parallel/spatial.build_dp_spatial_report``
and the ``mesh`` parameters of ``models/batch.py``, ``utils/io.py`` and
``serving.py``) on the CPU with gloo ranks.

* One spawn of 4 ranks (tests/torch_spatial_ranks.mesh_main_4): the dp x
  spatial report at data=2 x spatial=2 against the JAX package's
  ``build_dp_spatial_report`` on a 4-device slice of the CPU mesh, at
  tests/test_sharding.py's bars; the data-parallel report over the flat
  data axis, bit for bit against the port's own ``full_report_batched``
  and at the bars against the JAX package's ``data_parallel_report_u8``;
  the mesh artifact, bit for bit against the single-device artifact.  All
  ranks return the same batch.
* One spawn of 2 ranks (mesh_main_2): a height the spatial axis does not
  divide with ``downsample_rate=2``; one thin box in the batch sends every
  image to the masked route; ``process_corpus`` as two hosts at once and
  on a 2-rank mesh, against one mesh-less run.
* In one process, on a one-rank gloo group: the refusals, the routing
  threshold, ``warmup(mesh=...)``, and the dp x spatial step against
  ``build_spatial_report`` image by image, bit for bit.
"""

from . import torch_threads  # noqa: F401 (this worker's cores)

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.parallel import mesh as jmesh
from photohive_dsp_tpu.parallel import sharding as jsharding
from photohive_dsp_tpu.parallel import spatial as jspatial

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch import runtime as native_rt
from photohive_dsp_tpu_torch.models import batch as tbatch
from photohive_dsp_tpu_torch.parallel import mesh as tmesh
from photohive_dsp_tpu_torch.parallel import sharding as tsharding
from photohive_dsp_tpu_torch.parallel import spatial as tspatial
from photohive_dsp_tpu_torch.serving import export_report, load_report
from photohive_dsp_tpu_torch.utils import io as phio

from .test_sharding import _assert_reports_match
from .torch_spatial_ranks import mesh_main_2, mesh_main_4, spawn_ranks
from .util import structured_image

H, W = 128, 160
CFG = pt.ReportConfig()
# Boxes across the spatial seam at row 64 (2 ranks of 64 rows), across
# every rank, on the image's edge.
BOXES = [dict(top=10, bottom=100, left=5, right=150),
         dict(top=60, bottom=70, left=20, right=140),
         dict(top=0, bottom=H, left=0, right=24)]
THIN = dict(top=63, bottom=65, left=0, right=160)


def _boxes(b, boxes=BOXES):
    one = pt.set_bounding_boxes(boxes)
    return np.stack([one[0]] * b), np.stack([one[1]] * b)


def _rgb(b, h=H, w=W):
    return np.stack([structured_image(h, w, seed=s)
                     for s in range(b)]).astype(np.float32)


def _u8(b):
    return np.moveaxis(np.round(_rgb(b) * 255).astype(np.uint8), 1, -1)


def _report(arrays: dict, name: str, i: int) -> SimpleNamespace:
    """Image i of the ReportData a rank saved under ``name``."""
    pre = name + "."
    return SimpleNamespace(**{k[len(pre):]: v[i] for k, v in arrays.items()
                              if k.startswith(pre)})


def _same(ours: dict, want, name: str) -> None:
    """The saved fields of ``name`` equal ReportData ``want`` bit for
    bit."""
    for k, v in want._asdict().items():
        assert np.array_equal(ours[f"{name}.{k}"], v.numpy(),
                              equal_nan=True), (name, k)


def _assert_replicated(reports: list) -> None:
    for other in reports[1:]:
        for k, v in reports[0].items():
            assert np.array_equal(v, other[k], equal_nan=True), k


def _fake_mesh(data: int, spatial: int = 1) -> tmesh.Mesh:
    """A mesh's sizes without its groups: for checks that raise, or read
    only the sizes, before any collective."""
    return tmesh.Mesh(data, spatial, 0, 0, None, None)


# ------------------------------------------------------ 4 gloo ranks ---

@pytest.fixture(scope="module")
def blob4():
    """The data-parallel artifact for 4 ranks of a batch of 8 (per rank:
    the pinned artifact at batch 2), exported once."""
    return export_report(H, W, CFG, batch_size=8, device="cpu",
                         mesh=_fake_mesh(2, 2))


@pytest.fixture(scope="module")
def ranks4(blob4, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks4")
    blob_path = tmp / "report.pt2"
    blob_path.write_bytes(blob4)
    bx, vd = _boxes(4)
    ubx, uvd = _boxes(8)
    inputs = dict(rgb=_rgb(4), boxes=bx, valid=vd, u8=_u8(8), u8_boxes=ubx,
                  u8_valid=uvd)
    reports = spawn_ranks(4, tmp, mesh_main_4, CFG, *inputs.values(),
                          str(blob_path))
    return inputs, reports


def test_4_ranks_return_the_same_batch(ranks4):
    _, reports = ranks4
    _assert_replicated(reports)
    assert reports[0]["dps.palette_n"].shape == (4,)
    assert reports[0]["dp.palette_n"].shape == (8,)


def test_dp_spatial_2x2_matches_jax(ranks4):
    inputs, reports = ranks4
    m = jmesh.make_mesh(data=2, spatial=2, devices=jax.devices()[:4])
    fn = jspatial.build_dp_spatial_report(m, 4, H, W, ph.ReportConfig())
    want = jax.tree.map(np.asarray, fn(jnp.asarray(inputs["rgb"]),
                                       jnp.asarray(inputs["boxes"]),
                                       jnp.asarray(inputs["valid"])))
    for i in range(4):
        _assert_reports_match(jax.tree.map(lambda x, i=i: x[i], want),
                              _report(reports[0], "dps", i))


def test_data_parallel_equals_full_report_batched_and_meets_jax(ranks4):
    inputs, reports = ranks4
    u8 = inputs["u8"]
    x = torch.from_numpy(u8).permute(0, 3, 1, 2).contiguous()
    own = pt.full_report_batched(x, inputs["u8_boxes"], inputs["u8_valid"],
                                 pt.ReportTables.build(H, W, CFG), CFG)
    _same(reports[0], own, "dp")
    m = jmesh.make_mesh(data=4, spatial=1, devices=jax.devices()[:4])
    fn, tables = jsharding.data_parallel_report_u8(H, W, ph.ReportConfig(),
                                                   m)
    want = jax.tree.map(np.asarray, fn(
        jnp.asarray(u8), jnp.asarray(inputs["u8_boxes"]),
        jnp.asarray(inputs["u8_valid"]), tables))
    for i in (0, 3, 7):
        _assert_reports_match(jax.tree.map(lambda x, i=i: x[i], want),
                              _report(reports[0], "dp", i))


def test_mesh_artifact_equals_single_device_artifact(ranks4, blob4):
    """tests/test_serving.py:103's contract: the mesh artifact's batch
    equals the single-device artifact's (the same program, loaded without
    a mesh, on each rank's slice) bit for bit."""
    inputs, reports = ranks4
    fn = load_report(blob4)
    args = [torch.from_numpy(inputs[k]) for k in ("u8", "u8_boxes",
                                                   "u8_valid")]
    parts = [fn(*(a[r * 2:(r + 1) * 2] for a in args)) for r in range(4)]
    _same(reports[0], pt.ReportData(*(torch.cat(x) for x in zip(*parts))),
          "art")
    _same(reports[0], pt.ReportData(*(torch.from_numpy(
        reports[0][f"dp.{k}"]) for k in pt.ReportData._fields)), "art")


# ------------------------------------------------------ 2 gloo ranks ---

@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    """mesh_main_2 on 127-row frames at downsample_rate 2 (neither 127 nor
    its 63 decimated rows divide 2), and a 6-frame .txt corpus of two
    shapes with its mesh-less process_corpus run."""
    tmp = tmp_path_factory.mktemp("ranks2")
    cfg = pt.ReportConfig(downsample_rate=2)
    rgb = _rgb(2, 127, W)
    bx, vd = _boxes(2, BOXES[:2] + [dict(BOXES[2], bottom=127)])
    tbx, tvd = bx.copy(), vd.copy()
    tbx[0, 3] = [THIN[k] for k in ("top", "bottom", "left", "right")]
    tvd[0, 3] = True
    paths = []
    for i in range(6):
        h, w = (360, 480) if i % 3 else (352, 400)
        img = np.round(structured_image(h, w, seed=i) * 255)
        p = str(tmp / f"img_{i}.txt")
        assert native_rt.write_txt_u8(p, np.moveaxis(img, 0, -1).astype(
            np.uint8))
        paths.append(p)
    ref_dir = tmp / "ref"
    assert phio.process_corpus(paths, str(ref_dir), pt.ReportConfig(),
                               batch_size=2, device="cpu") == 6
    hosts_dir, mesh_dir = tmp / "hosts", tmp / "mesh"
    reports = spawn_ranks(2, tmp, mesh_main_2, cfg, rgb, bx, vd, tbx, tvd,
                          CORPUS_ITEMS, ROUTE_MP, paths, str(hosts_dir),
                          str(mesh_dir))
    return dict(cfg=cfg, rgb=rgb, boxes=(bx, vd), thin=(tbx, tvd),
                ref=ref_dir, hosts=hosts_dir, mesh=mesh_dir), reports


# run_corpus on the data=1 x spatial=2 mesh: 127x160 frames (20 kpx, u8
# and float) at or above ROUTE_MP row-sharded one at a time, 96x128 frames
# (12 kpx) data-parallel in batches of 2.
ROUTE_MP = 0.015
CORPUS_ITEMS = [("u8-0", _u8(1)[0][:127]), ("u8-1", _u8(2)[1][:127]),
                ("f32", _rgb(1, 127, W)[0]),
                ("small-0", _u8(1)[0][:96, :128]),
                ("small-1", _u8(2)[1][16:112, 16:144])]


def _single_device(rgb, boxes, valid, cfg):
    h, w = rgb.shape[2:]
    return pt.full_report_batched(torch.from_numpy(rgb), boxes, valid,
                                  pt.ReportTables.build(h, w, cfg), cfg)


def test_dp_spatial_2_ranks_non_dividing_height_downsampled(ranks2):
    case, reports = ranks2
    _assert_replicated(reports)
    ref = _single_device(case["rgb"], *case["boxes"], case["cfg"])
    for i in range(2):
        _assert_reports_match(SimpleNamespace(**{
            k: v[i].numpy() for k, v in ref._asdict().items()}),
            _report(reports[0], "dps", i))


def test_one_thin_box_sends_the_local_batch_to_the_masked_route(ranks2):
    """A thin box in image 0 only: each rank takes the masked route for
    both images (two masked passes, as variance_sharpness_batched takes
    one route a batch), and both meet the single-device batch's bars."""
    case, reports = ranks2
    assert [int(r["masked"]) for r in reports] == [2, 2]
    ref = _single_device(case["rgb"], *case["thin"], case["cfg"])
    for i in range(2):
        _assert_reports_match(SimpleNamespace(**{
            k: v[i].numpy() for k, v in ref._asdict().items()}),
            _report(reports[0], "thin", i))
    assert np.all(reports[0]["thin.sharpness"][0, :4] != 0)


def test_run_corpus_on_a_spatial_mesh(ranks2):
    """run_corpus(mesh=...) with a spatial axis: large frames (uint8 and
    float) row-sharded at the spatial bars against the mesh-less run,
    small ones data-parallel and bit for bit."""
    _, reports = ranks2
    want = dict(tbatch.run_corpus(iter(CORPUS_ITEMS), CFG, batch_size=2,
                                  device="cpu"))
    for key, data in want.items():
        ref = SimpleNamespace(**{k: v.numpy()
                                 for k, v in data._asdict().items()})
        got = _report({k: v[None] for k, v in reports[1].items()},
                      f"corpus-{key}", 0)
        if key.startswith("small"):
            for k, v in vars(ref).items():
                assert np.array_equal(getattr(got, k), v), (key, k)
        else:
            _assert_reports_match(ref, got)


def _lines(path) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {json.loads(line)["key"]: line for line in f}


def test_process_corpus_two_hosts_at_once_and_on_a_mesh(ranks2):
    """Two hosts at once: disjoint, covering shards whose lines equal the
    mesh-less run's.  On a 2-rank mesh: rank 0 alone writes, one shard,
    equal to the mesh-less run line for line; both ranks count every
    image."""
    case, reports = ranks2
    ref = _lines(case["ref"] / "reports.0.jsonl")
    hosts = [_lines(case["hosts"] / f"reports.{i}.jsonl") for i in (0, 1)]
    assert len(ref) == 6 and hosts[0] and hosts[1]
    assert not set(hosts[0]) & set(hosts[1])
    assert {**hosts[0], **hosts[1]} == ref
    assert [int(r["n_host"]) for r in reports] == [len(h) for h in hosts]
    assert sorted(os.listdir(case["mesh"])) == [
        "reports.0.jsonl", "skipped.0.jsonl", "watermark.0"]
    assert _lines(case["mesh"] / "reports.0.jsonl") == ref
    assert [int(r["n_mesh"]) for r in reports] == [6, 6]


# --------------------------------------------- one rank, in process ---

@pytest.fixture
def one_rank():
    tmesh.initialize_distributed(device="cpu", timeout_s=60)
    try:
        yield tmesh.make_mesh(timeout_s=60)
    finally:
        dist.destroy_process_group()


def test_make_mesh_refuses_sizes_that_do_not_match_the_world(one_rank):
    assert (one_rank.data, one_rank.spatial, one_rank.size) == (1, 1, 1)
    assert tsharding.flat_data_mesh(one_rank) is one_rank
    with pytest.raises(ValueError, match="!= 1 ranks"):
        tmesh.make_mesh(data=2)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.make_mesh(spatial=2)


def test_refusals():
    """Each raises before any collective: a batch the data axis does not
    divide, a dynamic or indivisible batch with a mesh, a mesh artifact
    loaded on another rank count."""
    two = _fake_mesh(2)
    with pytest.raises(ValueError, match="must divide by data=2"):
        tspatial.build_dp_spatial_report(two, 3, H, W, CFG, "cpu")
    fn, tables = tsharding.data_parallel_report_u8(H, W, CFG, two, "cpu")
    bx, vd = _boxes(3)
    with pytest.raises(ValueError, match="must divide by data=2"):
        fn(_u8(3), bx, vd, tables)
    with pytest.raises(ValueError, match="dynamic batch"):
        export_report(H, W, CFG, batch_size="dynamic", device="cpu",
                      mesh=two)
    with pytest.raises(ValueError, match="must divide the mesh's 2"):
        export_report(H, W, CFG, batch_size=3, device="cpu", mesh=two)


def test_mesh_artifact_refuses_another_rank_count(blob4, one_rank):
    with pytest.raises(ValueError, match="exported for 4 ranks"):
        load_report(blob4, mesh=one_rank)


def test_routes_spatially_and_the_threshold():
    runner = tbatch.BatchRunner(CFG, mesh=_fake_mesh(2, 2),
                                spatial_route_mp=0.05, device="cpu")
    assert runner.routes_spatially(250, 200)        # 0.05 MP
    assert not runner.routes_spatially(H, W)        # 0.02 MP
    assert (runner.quantum(250, 200), runner.quantum(H, W)) == (2, 2)
    flat = tbatch.BatchRunner(CFG, mesh=_fake_mesh(4), device="cpu")
    assert not flat.routes_spatially(4320, 7680)    # no spatial axis
    assert not tbatch.BatchRunner(CFG, device="cpu").routes_spatially(
        4320, 7680)
    assert tbatch.SPATIAL_ROUTE_MP == 8.0
    got = subprocess.run(
        [sys.executable, "-c", "from photohive_dsp_tpu_torch.models import "
         "batch; print(batch.SPATIAL_ROUTE_MP)"],
        env=dict(os.environ, PHOTOHIVE_SPATIAL_MP="2.5"), check=True,
        capture_output=True, text=True, timeout=120)
    assert got.stdout.split() == ["2.5"]


def test_warmup_with_a_mesh_skips_spatially_routed_shapes(one_rank):
    cfg = pt.ReportConfig(angle_partitions=24)
    assert tbatch.warmup([(H, W), (250, 200)], cfg, mesh=one_rank,
                         device="cpu") == 2
    two = tmesh.Mesh(1, 2, 0, 0, None, None, flat=one_rank)
    misses = tbatch.cached_tables.cache_info().misses
    assert tbatch.warmup([(H, W), (4320, 7680)], cfg, mesh=two,
                         device="cpu") == 1
    # (H, W) was prepared above; the 33 MP shape was not prepared now.
    assert tbatch.cached_tables.cache_info().misses == misses


def test_dp_spatial_equals_build_spatial_report_per_image(one_rank):
    """At one rank the dp x spatial step is build_spatial_report image by
    image, bit for bit (the batched palette pass included); with a thin
    box in image 0 the other image takes the masked route too and stays
    within the sharpness bar of its K5 value."""
    rgb = _rgb(2)
    bx, vd = _boxes(2)
    fn = tspatial.build_dp_spatial_report(one_rank, 2, H, W, CFG, "cpu")
    single = tspatial.build_spatial_report(one_rank.spatial_group, H, W, CFG,
                                           "cpu")
    got = fn(rgb, bx, vd)
    for i in range(2):
        for k, v in single(rgb[i], bx[i], vd[i])._asdict().items():
            assert torch.equal(getattr(got, k)[i], v), (i, k)
    tbx, tvd = bx.copy(), vd.copy()
    tbx[0, 3] = [THIN[k] for k in ("top", "bottom", "left", "right")]
    tvd[0, 3] = True
    thin = fn(rgb, tbx, tvd)
    assert torch.equal(thin.sharpness[0],
                       single(rgb[0], tbx[0], tvd[0]).sharpness)
    np.testing.assert_allclose(thin.sharpness[1].numpy(),
                               got.sharpness[1].numpy(), rtol=1e-4, atol=0)
    runner = tbatch.BatchRunner(CFG, mesh=one_rank, device="cpu")
    alone = tbatch.BatchRunner(CFG, device="cpu")
    u8 = _u8(3)
    ubx, uvd = _boxes(3)
    for a, b in zip(runner.run_u8(u8, ubx, uvd), alone.run_u8(u8, ubx, uvd)):
        assert torch.equal(a, b)
