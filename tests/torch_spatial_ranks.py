"""Rank processes for the tests of the port's process-group layer
(``parallel/``): each rank is a spawned process that joins a gloo group
through a fresh rendezvous file, runs one of the ``*_main`` functions below
on the CPU and saves what it computed.  This module imports no JAX, so the
ranks start fast."""

from __future__ import annotations

import json
import multiprocessing
import time
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from photohive_dsp_tpu_torch.config import ReportConfig
from photohive_dsp_tpu_torch.parallel import mesh, sharding, spatial
from photohive_dsp_tpu_torch.utils import profiling

# Each rank's collectives give up after this long; the parent kills ranks
# still alive after RANKS_TIMEOUT_S, so a hung collective fails one test.
COLLECTIVE_TIMEOUT_S = 60
RANKS_TIMEOUT_S = 120


def _arrays(**reports) -> dict:
    """{name.field: numpy array} of each ReportData."""
    return {f"{name}.{k}": v.cpu().numpy()
            for name, data in reports.items()
            for k, v in data._asdict().items()}


def _join(rank: int, world: int, rendezvous: str) -> None:
    torch.set_num_threads(1)
    mesh.initialize_distributed(rendezvous, world, rank, device="cpu",
                                timeout_s=COLLECTIVE_TIMEOUT_S)


def spatial_main(rank: int, world: int, rendezvous: str, out: str,
                 cfg: ReportConfig, img: np.ndarray, boxes: np.ndarray,
                 valid: np.ndarray) -> None:
    """build_spatial_report of one image over all ranks."""
    group = mesh.init_spatial_group(rank, world, rendezvous, device="cpu",
                                    timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        _, height, width = img.shape
        data = spatial.build_spatial_report(group, height, width, cfg,
                                            device="cpu")(img, boxes, valid)
        np.savez(out, **{k: v.numpy() for k, v in data._asdict().items()})
    finally:
        dist.destroy_process_group()


def mesh_main_4(rank: int, world: int, rendezvous: str, out: str,
                cfg: ReportConfig, rgb, boxes, valid, u8, u8_boxes,
                u8_valid, blob_path: str) -> None:
    """On a data=2 x spatial=2 mesh: build_dp_spatial_report of (rgb,
    boxes, valid) ("dps"); data_parallel_report_u8 over the flat data axis
    ("dp") and the mesh artifact at blob_path ("art") on (u8, u8_boxes,
    u8_valid)."""
    _join(rank, world, rendezvous)
    try:
        m = mesh.make_mesh(data=2, spatial=2,
                           timeout_s=COLLECTIVE_TIMEOUT_S)
        b, _, h, w = rgb.shape
        dps = spatial.build_dp_spatial_report(m, b, h, w, cfg, "cpu")(
            rgb, boxes, valid)
        fn, tables = sharding.data_parallel_report_u8(
            h, w, cfg, sharding.flat_data_mesh(m), "cpu")
        dp = fn(u8, u8_boxes, u8_valid, tables)
        from photohive_dsp_tpu_torch.serving import load_report
        with open(blob_path, "rb") as f:
            art = load_report(f.read(), mesh=m)(
                torch.from_numpy(u8), torch.from_numpy(u8_boxes),
                torch.from_numpy(u8_valid))
        np.savez(out, **_arrays(dps=dps, dp=dp, art=art))
    finally:
        dist.destroy_process_group()


def mesh_main_2(rank: int, world: int, rendezvous: str, out: str,
                cfg: ReportConfig, rgb, boxes, valid, thin_boxes,
                thin_valid, items, route_mp: float, paths, hosts_dir: str,
                mesh_dir: str) -> None:
    """Two ranks: build_dp_spatial_report on a data=1 x spatial=2 mesh of
    (rgb, boxes, valid) ("dps") and with thin_boxes ("thin", with the
    number of masked-route crops it took), at ``cfg``; run_corpus of the
    (key, image) ``items`` on that mesh, images of ``route_mp`` MP or more
    row-sharded ("corpus-KEY"); then process_corpus over ``paths`` at the
    default config as host ``rank`` of 2 (both ranks at once, into
    hosts_dir) and over a data=2 mesh (into mesh_dir), with the counts
    each rank returned."""
    _join(rank, world, rendezvous)
    try:
        m = mesh.make_mesh(data=1, spatial=2,
                           timeout_s=COLLECTIVE_TIMEOUT_S)
        b, _, h, w = rgb.shape
        fn = spatial.build_dp_spatial_report(m, b, h, w, cfg, "cpu")
        dps = fn(rgb, boxes, valid)
        masked = []
        real_crops = spatial.box_crops

        def counting_crops(*args):
            masked.append(1)
            return real_crops(*args)

        spatial.box_crops = counting_crops
        try:
            thin = fn(rgb, thin_boxes, thin_valid)
        finally:
            spatial.box_crops = real_crops
        from photohive_dsp_tpu_torch.models.batch import run_corpus
        corpus = {f"corpus-{key}": data for key, data in run_corpus(
            iter(items), ReportConfig(), mesh=m, batch_size=2,
            spatial_route_mp=route_mp, device="cpu")}
        from photohive_dsp_tpu_torch.utils.io import process_corpus
        n_host = process_corpus(paths, hosts_dir, batch_size=2,
                                num_hosts=2, host_id=rank, device="cpu")
        m_data = mesh.make_mesh(data=2, timeout_s=COLLECTIVE_TIMEOUT_S)
        n_mesh = process_corpus(paths, mesh_dir, mesh=m_data, batch_size=2,
                                device="cpu")
        np.savez(out, masked=len(masked), n_host=n_host, n_mesh=n_mesh,
                 **_arrays(dps=dps, thin=thin, **corpus))
    finally:
        dist.destroy_process_group()


def traced_mesh_main(rank: int, world: int, rendezvous: str, out: str,
                     cfg: ReportConfig, rgb, boxes, valid,
                     trace_dir: str) -> None:
    """build_dp_spatial_report of (rgb, boxes, valid) on a data=1 x
    spatial=2 mesh under ``profiling.trace``; saves the program's spans of
    the main thread: their names ("names") and [start, end] in us
    ("times")."""
    _join(rank, world, rendezvous)
    try:
        m = mesh.make_mesh(data=1, spatial=2,
                           timeout_s=COLLECTIVE_TIMEOUT_S)
        b, _, h, w = rgb.shape
        fn = spatial.build_dp_spatial_report(m, b, h, w, cfg, "cpu")
        log_dir = f"{trace_dir}/rank{rank}"
        with profiling.trace(log_dir):
            fn(rgb, boxes, valid)
        with open(f"{log_dir}/trace.json") as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e["name"].startswith("photohive.")]
        np.savez(out, names=np.array([e["name"] for e in spans]),
                 times=np.array([[e["ts"], e["ts"] + e["dur"]]
                                 for e in spans], np.float64))
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, tmp_dir: Path, main, *args) -> list:
    """Run ``main(rank, world, rendezvous, out, *args)`` in ``world``
    spawned processes at once, with a fresh rendezvous file; returns each
    rank's saved arrays as a dict.  Raises if a rank fails or outlives
    RANKS_TIMEOUT_S."""
    ctx = multiprocessing.get_context("spawn")
    tag = uuid.uuid4().hex
    rendezvous = f"file://{tmp_dir}/rendezvous-{tag}"
    outs = [str(tmp_dir / f"rank{r}-{tag}.npz") for r in range(world)]
    procs = [ctx.Process(target=main,
                         args=(r, world, rendezvous, outs[r]) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise AssertionError(f"ranks {hung} of {world} still running after "
                             f"{RANKS_TIMEOUT_S} s")
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if failed:
        raise AssertionError(f"ranks failed (rank, exit code): {failed}")
    return [dict(np.load(o)) for o in outs]


def run_ranks(world: int, tmp_dir: Path, cfg: ReportConfig, img, boxes,
              valid) -> list:
    """The spatial report of every rank of a ``world``-rank gloo group, as
    dicts of numpy arrays (spatial_main)."""
    return spawn_ranks(world, tmp_dir, spatial_main, cfg, img, boxes, valid)
