"""Serving artifacts of the port (photohive_dsp_tpu_torch/serving.py) on
the CPU, at 360x480: a loaded artifact against the live
``full_report_batched`` (bit for bit), against the JAX package's artifact
at tests/test_serving.py's bars, a dynamic batch, determinism, every
palette tier and sharpness route inside one artifact, and the cwide
variant.  The contracts of tests/test_serving.py:22,73,80; its mesh
artifact (:103) waits for the port's data-parallel layer."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.serving import export_report as jax_export_report
from photohive_dsp_tpu.serving import load_report as jax_load_report

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.serving import export_report, load_report

from .util import structured_image

H, W = 360, 480
CFG = pt.ReportConfig()
TABLES = pt.ReportTables.build(H, W, CFG, "cpu")


def u8_frames(seeds=(1, 4)) -> np.ndarray:
    """(B, H, W, 3) uint8 frames of tests/test_serving.py."""
    imgs = np.stack([structured_image(H, W, seed=s) for s in seeds])
    return np.moveaxis((imgs * 255).astype(np.uint8), 1, -1)


def hue_wheel(rng) -> np.ndarray:
    """All 18 hues at one (s, v) and a gray band: the q_full tier."""
    hue = np.broadcast_to(np.arange(W)[None, :] / W * 360.0, (H, W))
    c = 0.64
    xx = c * (1 - np.abs((hue / 60) % 2 - 1))
    sec = (hue // 60).astype(int) % 6
    rgb = np.stack([np.choose(sec, [c, xx, 0, 0, xx, c]),
                    np.choose(sec, [xx, c, c, xx, 0, 0]),
                    np.choose(sec, [0, 0, xx, c, c, xx])], axis=-1) + 0.16
    rgb[: H // 40] = 0.5
    rgb = rgb + rng.normal(0, 0.002, rgb.shape)
    return np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def smooth(rng) -> np.ndarray:
    """A two-gradient frame with mild noise: no populated cell tied, the
    q=1 tier."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    rgb = np.stack([0.25 + 0.5 * x / W, 0.25 + 0.5 * y / H,
                    0.4 + 0 * x], axis=-1) + rng.normal(0, 0.005, (H, W, 3))
    return np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def box_set(kind: str, b: int):
    boxes = np.zeros((b, 10, 4), np.int32)
    valid = np.zeros((b, 10), bool)
    if kind != "none":
        boxes[:, 0] = (20, 200, 30, 300)
        boxes[:, 1] = (0, 90, 360, 480)              # on the top right edge
        valid[:, :2] = True
    if kind == "thin":
        boxes[:, 2] = (180, 182, 24, 360)            # 2 px: the masked route
        valid[:, 2] = True
    return torch.from_numpy(boxes), torch.from_numpy(valid)


def live(u8: np.ndarray, boxes, valid):
    """The live path on (B, H, W, 3) frames made planar as
    BatchRunner.run_u8 (and the artifact) makes them."""
    x = torch.from_numpy(u8).permute(0, 3, 1, 2).contiguous()
    return pt.full_report_batched(x, boxes, valid, TABLES, CFG)


def assert_same(got, want, rows=slice(None)):
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a[rows], b[rows]), name


class Kernels(TorchDispatchMode):
    """Records each kernel operator a block calls, with the palette sums'
    candidate width, inside the branch a ``cond`` takes too."""

    supports_higher_order_operators = True

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.higher_order.cond:
            pred, true_fn, false_fn, operands = args
            with self:
                return (true_fn if pred else false_fn)(*operands)
        name = str(func.overloadpacket)
        if name.startswith("photohive."):
            op = name.split(".", 1)[1]
            self.seen.append(f"{op} q={args[1].shape[-1]}"
                             if op == "palette_sums" else op)
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def dynamic():
    return load_report(export_report(H, W, CFG, batch_size="dynamic",
                                     device="cpu"))


@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    """The B=2 artifact, through a file (the deployable form), and its
    report of test_serving.py's frames and box."""
    path = tmp_path_factory.mktemp("serving") / "report_360x480.pt2"
    path.write_bytes(export_report(H, W, CFG, batch_size=2, device="cpu"))
    fn = load_report(path.read_bytes())
    boxes, valid = box_set("one", 2)
    return fn, fn(torch.from_numpy(u8_frames()), boxes, valid)


def test_export_roundtrip_equals_live(pinned):
    _, out = pinned
    assert isinstance(out, pt.ReportData)
    assert_same(out, live(u8_frames(), *box_set("one", 2)))


def test_cpu_artifact_meets_jax_artifact_bars(pinned):
    """The port's cpu artifact against the JAX package's
    use_pallas=False artifact on the same frames, at the bars of
    tests/test_serving.py:47-67."""
    _, out = pinned
    u8 = u8_frames()
    boxes, valid = box_set("one", 2)
    ref = jax_load_report(jax_export_report(H, W, ph.ReportConfig(),
                                            batch_size=2, use_pallas=False))(
        jnp.asarray(u8), jnp.asarray(boxes.numpy()),
        jnp.asarray(valid.numpy()))
    ref = jax.tree.map(np.asarray, ref)
    out = pt.ReportData(*(x.numpy() for x in out))
    np.testing.assert_array_equal(out.palette_n, ref.palette_n)
    np.testing.assert_array_equal(out.blur_vector_angles,
                                  ref.blur_vector_angles)
    for i in range(2):
        n = int(ref.palette_n[i])
        a_ids, r_ids = out.palette_ids[i][:n], ref.palette_ids[i][:n]
        assert set(a_ids) == set(r_ids)
        a_pct = dict(zip(a_ids, out.palette_pct[i][:n]))
        r_pct = dict(zip(r_ids, ref.palette_pct[i][:n]))
        for cid in r_pct:
            assert abs(a_pct[cid] - r_pct[cid]) < 5e-4, cid
    for name in ("rgb_stats", "average_saturation", "sharpness",
                 "blur_bins", "blur_vector_mags"):
        np.testing.assert_allclose(getattr(out, name), getattr(ref, name),
                                   rtol=3e-6, atol=1e-6, err_msg=name)


def test_export_rejects_invalid_config():
    with pytest.raises(ValueError):
        export_report(H, W, pt.ReportConfig(h_partitions=7), device="cpu")


def test_export_dynamic_batch(dynamic, pinned):
    """One symbolic-batch artifact serves B=1, 2 and 3, and the batches
    agree on the images they share, with each other and with the pinned
    artifact."""
    u8 = u8_frames()
    u8_3 = np.concatenate([u8, u8[:1]])
    outs = {b: dynamic(torch.from_numpy(u8_3[:b]), *box_set("one", b))
            for b in (1, 2, 3)}
    for b, out in outs.items():
        assert out.palette_n.shape == (b,)
        assert bool(torch.isfinite(out.rgb_stats).all())
        assert_same(out, outs[3], slice(0, b))
    assert_same(outs[2], pinned[1])
    for name, a in zip(outs[3]._fields, outs[3]):
        assert torch.equal(a[2], a[0]), name


def test_artifact_is_deterministic(pinned):
    fn, out = pinned
    again = fn(torch.from_numpy(u8_frames()), *box_set("one", 2))
    assert_same(again, out)


@pytest.mark.parametrize("frame, boxes, routes", [
    ("smooth", "none", {"palette_sums_q1"}),
    ("noise", "boxes", {"palette_sums q=8", "sharpness_sums"}),
    ("wheel", "thin", {"palette_sums q=40"}),
    ("mixed", "boxes", {"palette_sums q=40", "sharpness_sums"}),
])
def test_dynamic_artifact_takes_every_route(dynamic, frame, boxes, routes):
    """Inside one artifact the palette takes each tier (q=1, q=8, q_full)
    and the sharpness each route (no box: nothing; boxes: K5; a thin box:
    the masked route, no K5), as the live path does, bit for bit."""
    rng = np.random.default_rng(3)
    made = {"smooth": smooth(rng),
            "noise": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            "wheel": hue_wheel(rng)}
    u8 = (np.stack([made["smooth"], made["noise"], made["wheel"]])
          if frame == "mixed" else made[frame][None])
    bx = box_set(boxes, len(u8))
    with Kernels() as seen:
        out = dynamic(torch.from_numpy(u8), *bx)
    kinds = {"palette_sums_q1", "palette_sums q=8", "palette_sums q=40",
             "sharpness_sums"}
    assert set(seen.seen) & kinds == routes
    assert {"cell_counts_s", "margin_sort", "fft_rows", "fft_cols",
            "polar_lognorm"} <= set(seen.seen)
    assert_same(out, live(u8, *bx))
    if boxes == "thin":
        assert bool((out.sharpness[:, :3] != 0).all())


def test_cwide_export(monkeypatch):
    """The palette variant read at export time: a cwide artifact runs the
    flat-HSV kernels' operators (K9, K14) and equals the live cwide path."""
    monkeypatch.setenv("PHOTOHIVE_PALETTE_KERNEL", "cwide")
    fn = load_report(export_report(H, W, CFG, batch_size=1, device="cpu"))
    monkeypatch.delenv("PHOTOHIVE_PALETTE_KERNEL")
    u8 = u8_frames((2,))
    with Kernels() as seen:
        out = fn(torch.from_numpy(u8), *box_set("one", 1))
    assert {"cell_counts_hsv", "palette_sums_cwide"} <= set(seen.seen)
    assert "cell_counts_s" not in seen.seen
    monkeypatch.setenv("PHOTOHIVE_PALETTE_KERNEL", "cwide")
    assert_same(out, live(u8, *box_set("one", 1)))
