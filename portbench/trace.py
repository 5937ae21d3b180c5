"""The traced window: ``torch.profiler`` with CPU and CUDA activities
around the measured loop, read back from its Chrome trace.

Device kernels are tied to the operator that launched them by the CUDA
runtime call they share a correlation id with, and that call's enclosing
CPU ranges on its thread.  Device busy time is the union of kernel,
memcpy and memset intervals inside the window's own range
(``portbench.window``).
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"
# A traced run measures at most this long: the trace of a longer window
# takes longer to read than the run may last.
TRACE_SECONDS = 2.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Kernel(collections.namedtuple("Kernel", "name cat ts dur bytes owner")):
    """A device activity; ``owner`` is the outermost ``photohive::``
    operator whose CPU range holds its launch, or None."""


class TraceView:
    """What the metric readers read from one traced window (times in us)."""

    def __init__(self, events: List[dict]):
        window = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == WINDOW]
        if not window:
            raise RuntimeError(f"trace holds no {WINDOW} range")
        w = window[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main_tid = (w.get("pid"), w.get("tid"))
        host = [e for e in events if e.get("cat") in HOST_CATS
                and e.get("ph") == "X" and e.get("name") != WINDOW]
        runtime = {e["args"]["correlation"]: e for e in host
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
        self.runtime_calls = collections.Counter(
            e["name"] for e in runtime.values()
            if self.t0 <= float(e["ts"]) <= self.t1)
        device = [e for e in events if e.get("cat") in DEVICE_CATS
                  and e.get("ph") == "X"]
        launches = [runtime.get(e.get("args", {}).get("correlation"))
                    for e in device]
        stacks = _stacks_at(host, [(float(r["ts"]), (r.get("pid"),
                                                     r.get("tid")))
                                   if r else None for r in launches])
        self.attributed = sum(r is not None for r in launches)
        self.kernels: List[Kernel] = []
        for e, stack in zip(device, stacks):
            owner = next((n for n in stack if n.startswith("photohive::")),
                         None)
            self.kernels.append(Kernel(
                e["name"], e["cat"], float(e["ts"]), float(e["dur"]),
                float(e.get("args", {}).get("bytes", 0)), owner))
        self.busy = _union([(k.ts, k.ts + k.dur) for k in self.kernels],
                           self.t0, self.t1)
        self._host = host

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def inside(self) -> List[Kernel]:
        """Device activities that start inside the window."""
        return [k for k in self.kernels if self.t0 <= k.ts <= self.t1]

    def gaps(self) -> List[Tuple[float, float]]:
        out, at = [], self.t0
        for a, b in self.busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if at < self.t1:
            out.append((at, self.t1))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the main thread's innermost host range was at each gap's
        start."""
        ops = collections.Counter()
        for k in self.inside():
            ops[short_name(k.name)] += k.dur * 1e-6
        gaps = self.gaps()
        stacks = _stacks_at(self._host, [(a, self.main_tid)
                                         for a, _ in gaps])
        idle = collections.Counter()
        for (a, b), stack in zip(gaps, stacks):
            idle[stack[-1] if stack else "python (no profiled range)"] += \
                (b - a) * 1e-6
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 96 characters
    (a copy's or a set's name whole)."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:96]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:96]


def _union(intervals, lo: float, hi: float):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _stacks_at(host: List[dict], queries) -> List[List[str]]:
    """For each query (time, thread) or None, the names of the host ranges
    on that thread that hold the time, outermost first."""
    by_tid: Dict[object, list] = collections.defaultdict(list)
    for e in host:
        by_tid[(e.get("pid"), e.get("tid"))].append(
            (float(e["ts"]), 0, -float(e["dur"]), e["name"]))
    for i, q in enumerate(queries):
        if q is not None:
            by_tid[q[1]].append((q[0], 1, 0.0, i))
    out: List[List[str]] = [[] for _ in queries]
    for items in by_tid.values():
        items.sort()
        stack: List[Tuple[float, str]] = []
        for t, kind, neg_dur, payload in items:
            while stack and stack[-1][0] < t:
                stack.pop()
            if kind == 0:
                stack.append((t - neg_dur, payload))
            else:
                out[payload] = [n for _, n in stack]
    return out


class Tracer:
    """Context manager: profile the block when ``enabled`` and leave its
    ``view`` (a TraceView) behind."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.view: Optional[TraceView] = None
        self._prof = self._range = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._range = record_function(WINDOW)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        self.view = TraceView(events)
        return False


def launch_count(view: TraceView) -> int:
    """CUDA kernel launches and memcpy calls the host made in the window."""
    return sum(n for name, n in view.runtime_calls.items()
               if "LaunchKernel" in name
               or name.startswith(("cudaMemcpy", "cuMemcpy")))


def memcpy(view: TraceView, direction: str) -> Tuple[float, float]:
    """(seconds, bytes) of the window's copies in ``direction`` (``HtoD``,
    ``DtoH``) on the device."""
    rows = [k for k in view.inside()
            if k.cat == "gpu_memcpy" and direction in k.name]
    return sum(k.dur for k in rows) * 1e-6, sum(k.bytes for k in rows)


def owned_seconds(view: TraceView, ops, names) -> Tuple[float, str]:
    """Device seconds of the kernels launched inside the operators ``ops``
    (``photohive::...``), read from the launching operator's CPU range; if
    the trace ties no kernel to a host call, of the kernels whose names
    hold one of ``names``.  Returns (seconds, method)."""
    kernels = [k for k in view.inside() if k.cat == "kernel"]
    if view.attributed:
        return sum(k.dur for k in kernels if k.owner in ops) * 1e-6, \
            "operator range"
    return sum(k.dur for k in kernels
               if any(n in k.name for n in names)) * 1e-6, "kernel name"


def idle_pct(run) -> Optional[float]:
    """Percent of the traced window in which the device ran nothing: the
    run's own busy and window seconds where it has them (a mesh averages
    its cards), else its trace's."""
    if run.trace is None:
        return None
    w = run.window
    busy = w.busy_s if w.busy_s is not None else run.trace.busy_s
    window = w.window_s if w.window_s is not None else run.trace.window_s
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
