"""Run one cell of BENCHMARK.json and print its result as the last line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Each run is its own process: it loads the program, makes its frames from
the seed, warms up the cell's shapes (all of that is ``setup_s``),
measures for ``--seconds`` (``--trace 1``: at most ``trace.TRACE_SECONDS``
under the profiler, reporting the per-layer metrics), then holds a sample
of what it delivered to the plain reference.  It needs as many CUDA
devices as the cell names and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional

T0 = time.perf_counter()

from . import guard  # noqa: E402
from .spec import PACKAGE, Cell, load_cell  # noqa: E402

# Caches the program or PyTorch might write, inside the checkout.
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(PACKAGE / "_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(PACKAGE / "_cache" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T0


class Context:
    """What a loop needs: the cell, the run's arguments, its frames."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device):
        import torch
        import photohive_dsp_tpu_torch as pt
        from . import frames

        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.setup_s: Optional[float] = None
        self.collective_timeout_s = 120.0
        os.environ["PHOTOHIVE_PALETTE_KERNEL"] = self.config["palette_kernel"]
        self.report_config = pt.ReportConfig(**self.config["report_config"])
        self.frames = frames.for_config(seed, self.config,
                                        self.config["frames"], self.device)
        self.boxes = [box_dicts(self.config.get("boxes", []), *f.shape[:2])
                      for f in self.frames]
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark_setup(self) -> None:
        self.setup_s = process_age_s()

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def box_dicts(spec, height: int, width: int) -> List[dict]:
    """Crop boxes from the configuration: each side (size * num) // den +
    offset, for the sides [top, bottom, left, right]."""
    out = []
    for box in spec:
        sides = [(height if k < 2 else width) * n // d + o
                 for k, (n, d, o) in enumerate(box)]
        out.append(dict(zip(("top", "bottom", "left", "right"), sides)))
    return out


def sampled_gaps(cell: Cell, ctx: Context, sample,
                 boxes_sent: bool = True) -> list:
    """The check's numbers for each sampled report against the reference
    run on the same frame and the boxes the program was given
    (``ctx.device``, after the program's state is freed)."""
    from . import check
    from .reference.report import Reference

    ref = Reference(cell.config["report_config"], ctx.device)
    out = []
    for item in sample:
        idx = item[0]
        frame = ctx.frames[idx]
        boxes = [(b["top"], b["bottom"], b["left"], b["right"])
                 for b in ctx.boxes[idx]] if boxes_sent else []
        want = ref.report(frame, boxes)
        try:
            if len(item) == 3:
                got = check.from_report(item[1], item[2], len(boxes))
            else:
                got = check.from_report_data(item[1], len(boxes))
            out.append(check.gaps(got, want, frame.shape[0] * frame.shape[1],
                                  cell.config["report_config"]))
        except (ValueError, IndexError, KeyError, TypeError):
            # A report too malformed to compare fails every number.
            out.append(check.unreadable())
    return out


class RunRecord:
    """What a metric reader reads (``read(run)``): the window, its trace
    (None untraced), ``setup_s`` and the configuration.  A reader that
    ties kernels to operators records how in ``attribution``."""

    def __init__(self, window, setup_s, config):
        self.window, self.setup_s, self.config = window, setup_s, config
        self.trace = window.trace
        self.attribution = {}


def result(cell: Cell, ctx: Context, win, trace: bool, device_kind: str,
           platform: str, gaps: list) -> dict:
    from . import check

    run = RunRecord(win, ctx.setup_s, cell.config)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    numbers = check.combine(gaps)
    names = check.required(win.boxes_sent and bool(cell.config.get("boxes")))
    out = {"correct": check.verdict(numbers, win.attempted, win.failed,
                                    len(gaps), names),
           "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics,
           "device": {"platform": platform, "kind": device_kind,
                      "count": cell.chips,
                      "memory_peak_bytes": win.memory_peak_bytes}}
    if trace and win.trace is not None:
        out["device"]["busy_s"] = win.busy_s if win.busy_s is not None \
            else win.trace.busy_s
        out["device"]["window_s"] = win.window_s \
            if win.window_s is not None else win.trace.window_s
        out["breakdown"] = win.trace.breakdown()
    if run.attribution:
        out["attribution"] = run.attribution
    out["check"] = check.check_entry(numbers, len(gaps), names)
    return out


def _free_program_state() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def spawn_ranks(args: list, world: int, url: str, root,
                device: Optional[str]) -> list:
    """Start ranks 1.. of a mesh cell, each ``rank_main`` in a process of
    its own, on card ``rank`` (or on ``device``)."""
    procs = []
    for rank in range(1, world):
        code = ("import json, sys; from portbench.run import rank_main; "
                "rank_main(*json.loads(sys.argv[1]))")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, json.dumps(
                args + [rank, world, url, device or f"cuda:{rank}"])],
            cwd=str(root), stdout=subprocess.DEVNULL))
    return procs


def rank_main(workload: str, seed: int, seconds: float, trace: bool,
              root: Optional[str], rank: int, world: int, url: str,
              device: str) -> None:
    """One rank of a mesh cell other than rank 0: it prints nothing."""
    import torch.distributed as dist
    from photohive_dsp_tpu_torch.parallel import mesh as pmesh
    from . import loops

    cell = load_cell(workload, root)
    pmesh.initialize_distributed(url, world, rank, device=device,
                                 timeout_s=120.0)
    try:
        ctx = Context(cell, seed, seconds, trace, device)
        loops.mesh_corpus(ctx)
    finally:
        dist.destroy_process_group()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", spawn: Callable = spawn_ranks) -> dict:
    """Measure one cell on ``device`` and return its result line.  Mesh
    cells run rank 0 here and the other ranks through ``spawn``."""
    import torch
    from . import loops

    loop = loops.LOOPS[cell.traffic["loop"]]
    procs = []
    dev = torch.device(device)
    if cell.traffic["loop"] == "mesh_corpus":
        import torch.distributed as dist
        from photohive_dsp_tpu_torch.parallel import mesh as pmesh

        rdv = tempfile.mkdtemp(prefix="portbench-rdv-")
        url = f"file://{os.path.join(rdv, 'store')}"
        root = str(cell.root)
        procs = spawn([cell.name, seed, seconds, trace, root], cell.chips,
                      url, cell.root, None if dev.type == "cuda" else str(dev))
        if dev.type == "cuda":
            dev = torch.device("cuda", 0)
        try:
            pmesh.initialize_distributed(url, cell.chips, 0, device=dev,
                                         timeout_s=120.0)
            try:
                ctx = Context(cell, seed, seconds, trace, dev)
                win = loop(ctx)
            finally:
                dist.destroy_process_group()
        finally:
            for p in procs:
                try:
                    rc = p.wait(timeout=180)
                except subprocess.TimeoutExpired:
                    p.kill()
                    rc = p.wait()
                if rc != 0:
                    print(f"portbench: rank process exited {rc}",
                          file=sys.stderr)
                    win.failed += 1
            for name in os.listdir(rdv):
                os.remove(os.path.join(rdv, name))
            os.rmdir(rdv)
    else:
        ctx = Context(cell, seed, seconds, trace, dev)
        win = loop(ctx)
        win.memory_peak_bytes = ctx.memory_peak()
    tiers = ", ".join(f"{k} {v}" for k, v in win.tiers.items())
    print(f"portbench: {cell.name} seed {seed}: {win.reports} reports in "
          f"{win.seconds:.3f} s; palette tiers of its batches: {tiers}",
          file=sys.stderr)
    sample = win.sample
    win.sample = []
    _free_program_state()
    gaps = sampled_gaps(cell, ctx, sample, win.boxes_sent)
    if dev.type == "cuda":
        kind, platform = torch.cuda.get_device_name(dev), "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return result(cell, ctx, win, trace, kind, platform, gaps)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bad = guard.reference_violations(PACKAGE / "reference")
    if bad:
        print(f"portbench: the reference imports {bad}", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = guard.loaded_forbidden()
    if found:
        print(f"portbench: modules that may not load were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, how in out.get("attribution", {}).items():
        print(f"portbench: {name}: kernels tied to operators by {how}",
              file=sys.stderr)
    for line in out_lines(out):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def out_lines(out: dict) -> List[str]:
    """The compared numbers beside their limits, for standard error."""
    return [f"check {k} {v['value']!r} limit {v['limit']!r}"
            for k, v in out["check"].items()]


if __name__ == "__main__":
    sys.exit(main())
