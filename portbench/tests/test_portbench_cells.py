"""Whole runs on the CPU at a small size (the harness's look for a card
skipped): every cell comes out correct; a cell added by files alone runs;
the control and each fault the cells can have come out not correct."""

import json

import pytest
import torch

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.models import batch
from portbench import calibrate, run
from portbench.spec import ROOT, load_cell

from .helpers import small_root

ONE_CHIP = ("photo_1080p.upload", "corpus_mixed.host", "corpus_mixed.device")


def run_small(root, name, trace=False, **kw):
    return run.run_cell(load_cell(name, root), 2**31 + 77, 0.5, trace,
                        device="cpu", **kw)


@pytest.mark.parametrize("name", ONE_CHIP)
def test_cell_runs_correct(tmp_path, name):
    out = run_small(small_root(tmp_path), name)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert list(out)[-1] == "check"
    # run_corpus takes no boxes; the other two cells send the config's
    assert ("sharpness_rel" in out["check"]) == (name != "corpus_mixed.host")
    assert out["check"]["sampled"]["value"] > 1


def test_traced_run_reports_the_window(tmp_path):
    out = run_small(small_root(tmp_path), "corpus_mixed.device", trace=True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_added_by_files_alone(tmp_path):
    root = small_root(tmp_path)
    cfg = json.loads((root / "portbench/configs/photo_1080p.json")
                     .read_text())
    cfg.update(name="photo_small", shapes=[[352, 448]], frames=2,
               boxes=[[[0, 1, 0], [1, 2, 0], [0, 1, 0], [1, 2, 0]]])
    (root / "portbench/configs/photo_small.json").write_text(
        json.dumps(cfg))
    (root / "portbench/traffic/upload_twice.json").write_text(json.dumps(
        {"loop": "closed_loop", "warmup": 1, "sample_per_slot": 2}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="photo_small", source=cfg["source"],
                                 file="portbench/configs/photo_small.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="photo_small.upload_twice",
                                   config="photo_small",
                                   traffic="upload_twice", chips=1,
                                   why="a test"))
    for m in bench["end_to_end"]:
        if m["name"].startswith("latency"):
            m["workloads"].append("photo_small.upload_twice")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_small(root, "photo_small.upload_twice")
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"latency_p50_ms", "latency_p95_ms",
                                   "setup_s"}


def test_control_is_refused(tmp_path):
    cell = load_cell("photo_1080p.upload", small_root(tmp_path))
    for seed in (1, 2, 3):
        got = calibrate.control_numbers(cell, seed, "cpu")
        assert not got["passes"]
        assert got["numbers"]["palette_ids_differ"] > 0
        assert got["numbers"]["stats_rel"] > 10 * \
            json.loads((ROOT / "portbench/limits.json").read_text())[
                "stats_rel"]


def altered(fn):
    """The report as produced, with one answer changed."""
    def broken(*args, **kw):
        data = fn(*args, **kw)
        return data._replace(rgb_stats=data.rgb_stats * 1.001)
    return broken


def last_slot_altered(fn):
    """The report of the batch's last image alone changed."""
    def broken(*args, **kw):
        data = fn(*args, **kw)
        stats = data.rgb_stats.clone()
        stats[-1] = stats[-1] * 1.001
        return data._replace(rgb_stats=stats)
    return broken


def half_left_out(fn):
    """Only the first half of the batch is run; its reports stand in for
    the other half."""
    def broken(rgb, boxes, valid, tables, cfg):
        h = max(rgb.shape[0] // 2, 1)
        data = fn(rgb[:h], boxes[:h], valid[:h], tables, cfg)
        return data.__class__(*(torch.cat([x, x])[:rgb.shape[0]]
                                for x in data))
    return broken


@pytest.mark.parametrize("name,fault", [
    ("photo_1080p.upload", "altered"), ("corpus_mixed.host", "altered"),
    ("corpus_mixed.host", "half"), ("corpus_mixed.device", "half"),
    ("corpus_mixed.host", "last_slot"), ("corpus_mixed.device", "last_slot")])
def test_a_fault_in_the_timed_path_is_caught(tmp_path, monkeypatch, name,
                                             fault):
    if name.startswith("photo"):
        monkeypatch.setattr(pt, "full_report", altered(pt.full_report))
    else:
        wrap = {"altered": altered, "half": half_left_out,
                "last_slot": last_slot_altered}[fault]
        monkeypatch.setattr(batch, "full_report_batched",
                            wrap(batch.full_report_batched))
    out = run_small(small_root(tmp_path), name)
    assert not out["correct"]


DROP_EXCHANGE = (
    "import json, sys, torch.distributed as d\n"
    "for n in ('all_reduce', 'all_gather', 'all_to_all_single'):\n"
    "    setattr(d, n, lambda *a, **k: None)\n"
    "from portbench.run import rank_main\n"
    "rank_main(*json.loads(sys.argv[1]))\n")


def spawn_without_exchange(args, world, url, root, device):
    import subprocess
    import sys
    return [subprocess.Popen(
        [sys.executable, "-c", DROP_EXCHANGE,
         json.dumps(args + [rank, world, url, device])], cwd=str(root),
        stdout=subprocess.DEVNULL) for rank in range(1, world)]


@pytest.mark.parametrize("exchange", [True, False])
def test_mesh_cell_and_its_exchange_left_out(tmp_path, monkeypatch,
                                             exchange):
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    root = small_root(tmp_path)
    if exchange:
        out = run_small(root, "race_mesh4.corpus")
        assert out["correct"], out["check"]
        assert out["device"]["count"] == 4
        return
    import torch.distributed as dist
    for n in ("all_reduce", "all_gather", "all_to_all_single"):
        monkeypatch.setattr(dist, n, lambda *a, **k: None)
    out = run_small(root, "race_mesh4.corpus", spawn=spawn_without_exchange)
    assert not out["correct"]
