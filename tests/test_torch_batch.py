"""The port's batch layer (models/batch.py) on the CPU: BatchRunner against
the JAX package's BatchRunner at 360x480 with a crop box, at the port's
acceptance bars (tests/test_torch_pipeline.assert_match); run_corpus over
two shapes with padded tails against the port's own get_report, and over
three against BatchRunner on the same frames stacked; flipped frames
against their copies; the prefetching stream against the sequential one;
warmup; the layout checks."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import threading
import time

import numpy as np
import pytest
import torch

from photohive_dsp_tpu import ReportConfig as JCfg
from photohive_dsp_tpu.models import batch as jbatch

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.models import batch as tbatch
from photohive_dsp_tpu_torch.models.pipeline import cached_tables

from .test_torch_pipeline import assert_match, data_fields, report_fields
from .util import structured_image

H, W = 360, 480
BOX = [dict(top=20, bottom=300, left=30, right=400)]


def _u8_images():
    rng = np.random.default_rng(11)
    structured = np.round(np.moveaxis(structured_image(H, W, seed=5), 0, -1)
                          * 255).astype(np.uint8)
    return np.stack([rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                     structured])


@pytest.mark.parametrize("entry", ["run_u8", "run"])
def test_batch_runner_matches_jax(entry):
    u8 = _u8_images()
    boxes, valid = pt.set_bounding_boxes(BOX)
    bx, vd = np.stack([boxes] * 2), np.stack([valid] * 2)
    images = u8 if entry == "run_u8" else \
        np.moveaxis(u8, -1, 1).astype(np.float32) / np.float32(255)
    want = getattr(jbatch.BatchRunner(JCfg()), entry)(images, bx, vd)
    got = getattr(tbatch.BatchRunner(pt.ReportConfig(), device="cpu"),
                  entry)(images, bx, vd)
    for i in range(2):
        assert_match(data_fields(got, i), data_fields(want, i))


def _corpus():
    """Five 360x480 and three 352x400 uint8 images, interleaved, and one
    float (3, 360, 480) image, which must get a bucket of its own."""
    rng = np.random.default_rng(12)
    items = []
    for i in range(8):
        h, w = (H, W) if i % 3 != 2 else (352, 400)
        items.append((f"u8-{i}", rng.integers(0, 256, (h, w, 3),
                                              dtype=np.uint8)))
    items.append(("f32", rng.random((3, H, W), dtype=np.float32)))
    return items


def test_run_corpus_pads_tails_and_matches_get_report():
    items = _corpus()
    cfg = pt.ReportConfig()
    out = list(tbatch.run_corpus(iter(items), cfg, batch_size=2,
                                 device="cpu"))
    assert sorted(k for k, _ in out) == sorted(k for k, _ in items)
    images = dict(items)
    for key, data in out:
        img = images[key]
        if img.dtype != np.uint8:
            img = np.moveaxis(img, 0, -1)
        h, w = img.shape[:2]
        assert data.palette_hsv.device.type == "cpu"
        got = pt.Report(data, h, w, config=cfg)
        assert_match(report_fields(got),
                     report_fields(pt.get_report(img, device="cpu")))


STAGE_SHAPES = [(H, W), (352, 400), (240, 320)]


@pytest.mark.parametrize("layout", ["uint8", "float32"])
def test_run_corpus_staging_matches_stacked_batches(layout):
    """run_corpus, which copies each frame into its slot of a staging
    buffer, against BatchRunner on np.stack of the same frames with the
    tail padded by the last frame: bit for bit, over three shapes
    interleaved and a short tail bucket.  The whole stream is collected
    before any report is compared, and each report must still equal the
    copy taken as it was yielded: none aliases the staging buffer."""
    rng = np.random.default_rng(14)
    items = []
    for i in range(5):           # the last shape: a tail of one
        h, w = STAGE_SHAPES[i % 3]
        items.append((i, rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                      if layout == "uint8" else
                      rng.random((3, h, w), dtype=np.float32)))
    cfg = pt.ReportConfig()
    out = [(key, data, [t.clone() for t in data]) for key, data in
           tbatch.run_corpus(iter(items), cfg, batch_size=2, device="cpu")]
    assert sorted(k for k, _, _ in out) == list(range(5))

    def same(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)

    runner = tbatch.BatchRunner(cfg, device="cpu")
    entry = runner.run_u8 if layout == "uint8" else runner.run
    got = {key: (data, copy) for key, data, copy in out}
    for shape in STAGE_SHAPES:
        keys = [k for k, img in items if tbatch.image_hw(img) == shape]
        for first in range(0, len(keys), 2):
            batch = keys[first:first + 2]
            frames = [img for k, img in items if k in batch]
            want = entry(np.stack(frames + frames[-1:] * (2 - len(frames))))
            for j, key in enumerate(batch):
                data, copy = got[key]
                for a, c, w in zip(data, copy, want):
                    same(a, c)
                    same(a, w[j])


FLIPS = {"channels": lambda x: x[..., ::-1],
         "rows": lambda x: np.flip(x, axis=-3)}


@pytest.mark.parametrize("flip", list(FLIPS))
@pytest.mark.parametrize("entry", ["run_corpus", "run_u8"])
def test_flipped_frames_equal_their_copies(entry, flip):
    """Frames with negative strides (a BGR to RGB flip, np.flipud), which
    torch cannot view, through run_corpus (three frames: a batch and a
    padded tail) and BatchRunner.run_u8, as the JAX package takes them:
    every report equals the same call's on .copy()s of them, bit for
    bit."""
    frames = FLIPS[flip](np.random.default_rng(15).integers(
        0, 256, (3, 240, 320, 3), dtype=np.uint8))
    assert min(frames.strides) < 0
    cfg = pt.ReportConfig()

    def reports(imgs):
        if entry == "run_u8":
            return [tbatch.BatchRunner(cfg, device="cpu").run_u8(imgs)]
        return [data for _, data in tbatch.run_corpus(
            enumerate(imgs), cfg, batch_size=2, device="cpu")]

    want = reports(frames.copy() if entry == "run_u8"
                   else [f.copy() for f in frames])
    got = reports(frames if entry == "run_u8" else list(frames))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_run_stream_u8_prefetch_matches_sequential():
    rng = np.random.default_rng(13)
    boxes, valid = pt.set_bounding_boxes(BOX)
    batches = [(rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8),
                np.stack([boxes] * 2), np.stack([valid] * 2))
               for _ in range(3)]
    runner = tbatch.BatchRunner(pt.ReportConfig(), device="cpu")
    seq = list(runner.run_stream_u8(iter(batches)))
    pre = list(runner.run_stream_u8(iter(batches), prefetch=2))
    assert len(seq) == len(pre) == 3
    for a, b in zip(seq, pre):
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    # A consumer that stops after one batch releases the staging thread.
    before = threading.active_count()
    stream = runner.run_stream_u8(iter(batches * 4), prefetch=1)
    next(stream)
    stream.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_warmup_prepares_each_shape():
    cfg = pt.ReportConfig(angle_partitions=36)
    shapes = [(H, W), (362, 514)]
    assert tbatch.warmup(shapes, cfg, device="cpu") == 2
    hits = cached_tables.cache_info().hits
    for h, w in shapes:
        cached_tables(h, w, cfg, torch.device("cpu"))
    assert cached_tables.cache_info().hits == hits + 2


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch.BatchRunner(pt.ReportConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch.warmup([(H, W)], pt.ReportConfig())


def test_image_hw_layouts_and_buckets():
    u8 = np.zeros((H, W, 3), np.uint8)
    f32 = np.zeros((3, H, W), np.float32)
    assert tbatch.image_hw(u8) == tbatch.image_hw(f32) == (H, W)
    for bad in (np.zeros((H, W, 3), np.float32), np.zeros((3, H, W),
                                                          np.uint8),
                np.zeros((H, W), np.uint8)):
        with pytest.raises(ValueError):
            tbatch.image_hw(bad)
    assert tbatch._bucket_key(u8) != tbatch._bucket_key(f32)
    groups = tbatch.bucket_by_shape([("a", u8), ("b", f32),
                                     ("c", np.zeros((400, 500, 3), np.uint8))])
    assert {k: [n for n, _ in v] for k, v in groups.items()} == \
        {(H, W): ["a", "b"], (400, 500): ["c"]}
    with pytest.raises(ValueError, match="boxes_valid"):
        tbatch.BatchRunner(pt.ReportConfig(), device="cpu").run_u8(
            u8[None], np.zeros((1, 10, 4), np.int32), None)
