"""The port's corpus runner (utils/io.py) on the CPU: the behaviours
tests/test_corpus.py pins for the JAX package (kill-and-resume
exactly-once, torn trailing line, host sharding, corrupt input skipped,
prefetch_iter, decode-ahead and decode workers, parallel_map_iter), on
reference .txt fixtures written by the port's native writer, and one
image's JSONL report against the JAX package's process_corpus report."""

from __future__ import annotations

from . import torch_threads  # noqa: F401 (this worker's cores)

import itertools
import json
import os

import numpy as np
import pytest

from photohive_dsp_tpu.utils import io as jio

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch import runtime as native_rt
from photohive_dsp_tpu_torch.utils import io as phio

from .util import structured_image

CFG = pt.ReportConfig()
N_IMAGES = 6
H, W = 360, 480


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six small .txt fixtures of one shape."""
    d = tmp_path_factory.mktemp("corpus")
    paths = []
    for i in range(N_IMAGES):
        img = np.round(structured_image(H, W, seed=i) * 255)
        p = str(d / f"img_{i}.txt")
        assert native_rt.write_txt_u8(p, np.moveaxis(img, 0, -1).astype(
            np.uint8))
        paths.append(p)
    return paths


def run(paths, out_dir, **kw):
    kw.setdefault("batch_size", 2)
    return phio.process_corpus(paths, out_dir, CFG, device="cpu", **kw)


def _shard_lines(out_dir, host_id=0):
    path = os.path.join(out_dir, f"reports.{host_id}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_kill_and_resume_exactly_once(corpus, tmp_path, monkeypatch):
    out_dir = str(tmp_path / "out")
    real_run_corpus = phio.run_corpus

    def crashing(images, cfg, mesh=None, batch_size=32, device="cuda"):
        it = real_run_corpus(images, cfg, mesh, batch_size=batch_size,
                             device=device)
        for n, item in enumerate(it):
            yield item
            if n == 2:
                raise RuntimeError("simulated preemption")

    monkeypatch.setattr(phio, "run_corpus", crashing)
    with pytest.raises(RuntimeError):
        run(corpus, out_dir, flush_every=2)

    # 3 reports written, only the first flush (2 keys) watermarked: the
    # third line sits in the at-least-once window.
    assert len(_shard_lines(out_dir)) == 3
    with open(os.path.join(out_dir, "watermark.0")) as f:
        assert len({ln.strip() for ln in f if ln.strip()}) == 2

    monkeypatch.setattr(phio, "run_corpus", real_run_corpus)
    assert run(corpus, out_dir, flush_every=2) == N_IMAGES - 3
    keys = [ln["key"] for ln in _shard_lines(out_dir)]
    assert len(keys) == len(set(keys)) == N_IMAGES
    assert set(keys) == set(corpus)
    for ln in _shard_lines(out_dir):
        assert len(ln["report"]) == 439
    assert run(corpus, out_dir) == 0          # a third run does nothing


def test_torn_trailing_line_recovery(tmp_path):
    shard = str(tmp_path / "reports.0.jsonl")
    with open(shard, "w") as f:
        f.write(json.dumps({"key": "a", "report": {}}) + "\n")
        f.write(json.dumps({"key": "b", "report": {}}) + "\n")
        f.write('{"key": "c", "repo')  # crash mid-write
    assert phio._recover_shard(shard) == {"a", "b"}
    with open(shard, "rb") as f:
        data = f.read()
    assert data.endswith(b"\n") and b'"c"' not in data


def test_host_sharding_disjoint_and_covering(corpus, tmp_path):
    out_dir = str(tmp_path / "out")
    n0 = run(corpus, out_dir, num_hosts=2, host_id=0)
    n1 = run(corpus, out_dir, num_hosts=2, host_id=1)
    assert n0 + n1 == N_IMAGES
    keys0 = {ln["key"] for ln in _shard_lines(out_dir, 0)}
    keys1 = {ln["key"] for ln in _shard_lines(out_dir, 1)}
    assert keys0.isdisjoint(keys1)
    assert keys0 | keys1 == set(corpus)


def test_corrupt_input_skipped(corpus, tmp_path):
    bad = str(tmp_path / "broken.txt")
    with open(bad, "w") as f:
        f.write("not an image")
    out_dir = str(tmp_path / "out")
    assert run([corpus[0], bad, corpus[1]], out_dir) == 2
    assert {ln["key"] for ln in _shard_lines(out_dir)} == {corpus[0],
                                                            corpus[1]}
    with open(os.path.join(out_dir, "skipped.0.jsonl")) as f:
        skipped = [json.loads(line) for line in f]
    assert [s["key"] for s in skipped] == [bad] and skipped[0]["error"]
    # A resumed run neither re-decodes nor re-logs the corrupt file.
    assert run([corpus[0], bad, corpus[1]], out_dir) == 0
    with open(os.path.join(out_dir, "skipped.0.jsonl")) as f:
        assert len(f.readlines()) == 1


def test_prefetch_iter_order_and_exceptions():
    assert list(phio.prefetch_iter(iter(range(100)), 8)) == list(range(100))
    assert list(phio.prefetch_iter(iter([]), 4)) == []
    # 2-tuples (the corpus item shape) are not mistaken for the sentinel
    items = [(f"k{i}", i) for i in range(10)]
    assert list(phio.prefetch_iter(iter(items), 3)) == items

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    it = phio.prefetch_iter(boom(), 2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        list(it)


@pytest.mark.parametrize("knob,a,b", [("prefetch", 0, 8),
                                      ("decode_workers", 1, 4)])
def test_background_decode_changes_nothing(corpus, tmp_path, knob, a, b):
    """Decode-ahead prefetching and the decode pool change timing only."""
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    assert run(corpus, out_a, batch_size=4, **{knob: a}) == N_IMAGES
    assert run(corpus, out_b, batch_size=4, **{knob: b}) == N_IMAGES
    la = {ln["key"]: ln["report"] for ln in _shard_lines(out_a)}
    lb = {ln["key"]: ln["report"] for ln in _shard_lines(out_b)}
    assert la == lb


def test_parallel_map_iter_order_exceptions_laziness():
    def f(x):
        if x == 7:
            raise ValueError("item 7")
        return x * 2

    assert list(phio.parallel_map_iter(f, range(6), 4, 8)) == \
        [0, 2, 4, 6, 8, 10]
    out = []
    with pytest.raises(ValueError, match="item 7"):
        for y in phio.parallel_map_iter(f, range(10), 3, 4):
            out.append(y)
    assert out == [0, 2, 4, 6, 8, 10, 12]  # order held up to the failure
    assert list(phio.parallel_map_iter(lambda x: x + 1, range(5), 1, 4)) \
        == [1, 2, 3, 4, 5]
    seen = []

    def g(x):
        seen.append(x)
        return x

    it = phio.parallel_map_iter(g, itertools.count(), 2, 3)
    assert [next(it) for _ in range(5)] == [0, 1, 2, 3, 4]
    assert max(seen) <= 5 + 3  # an infinite source runs ~depth ahead


def test_report_line_matches_jax_process_corpus(corpus, tmp_path):
    """The same image's JSONL report from both packages: the same keys in
    the same order; integers equal (a colour channel may move by one:
    it truncates an HSV average the port sums exactly); percentages and
    blur vectors equal; saturation within 1e-6 and RGB statistics within
    1e-5 relative."""
    paths = corpus[:2]
    run(paths, str(tmp_path / "port"))
    jio.process_corpus(paths, str(tmp_path / "jax"), batch_size=2)
    got = {ln["key"]: ln["report"] for ln in _shard_lines(tmp_path / "port")}
    want = {ln["key"]: ln["report"] for ln in _shard_lines(tmp_path / "jax")}
    assert got.keys() == want.keys() == set(paths)
    for key in paths:
        g, w = got[key], want[key]
        assert list(g) == list(w)
        for k, x in w.items():
            if k.startswith("Color") and not k.endswith("Percentage"):
                assert abs(g[k] - x) <= 1, k
            elif k == "Average Saturation":
                assert abs(g[k] / x - 1) < 1e-6
            elif "Brightness" in k or "Contrast" in k:
                assert abs(g[k] / x - 1) < 1e-5, k
            else:
                assert g[k] == x, k
