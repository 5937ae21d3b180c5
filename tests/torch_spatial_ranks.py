"""Rank processes for the tests of the port's row-sharded report: each rank
is a spawned process that joins a gloo group through a fresh rendezvous
file, computes ``parallel.spatial.build_spatial_report`` on the CPU and
saves its report.  This module imports no JAX, so the ranks start fast."""

from __future__ import annotations

import multiprocessing
import time
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from photohive_dsp_tpu_torch.config import ReportConfig
from photohive_dsp_tpu_torch.parallel import mesh, spatial

# Each rank's collectives give up after this long; the parent kills ranks
# still alive after RANKS_TIMEOUT_S, so a hung collective fails one test.
COLLECTIVE_TIMEOUT_S = 60
RANKS_TIMEOUT_S = 120


def _rank_main(rank: int, world: int, rendezvous: str, cfg: ReportConfig,
               img: np.ndarray, boxes: np.ndarray, valid: np.ndarray,
               out: str) -> None:
    torch.set_num_threads(1)
    group = mesh.init_spatial_group(rank, world, rendezvous, device="cpu",
                                    timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        _, height, width = img.shape
        data = spatial.build_spatial_report(group, height, width, cfg,
                                            device="cpu")(img, boxes, valid)
        np.savez(out, **{k: v.numpy() for k, v in data._asdict().items()})
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, tmp_dir: Path, cfg: ReportConfig, img, boxes,
              valid) -> list:
    """The report of every rank of a ``world``-rank gloo group, as dicts of
    numpy arrays; raises if a rank fails or outlives RANKS_TIMEOUT_S."""
    ctx = multiprocessing.get_context("spawn")
    tag = uuid.uuid4().hex
    rendezvous = f"file://{tmp_dir}/rendezvous-{tag}"
    outs = [str(tmp_dir / f"rank{r}-{tag}.npz") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, rendezvous, cfg, img, boxes, valid,
                               outs[r]))
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
