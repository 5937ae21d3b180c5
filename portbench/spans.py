"""The program's own spans in a traced window (``photohive.*`` ranges,
``photohive_dsp_tpu_torch.utils.profiling.span``), set against the
window's device-idle intervals (``TraceView.gaps``).

Only the main thread's spans count (the thread that opened the window):
a span on another thread, such as the prefetch thread's copies, does not
hold the caller.  A layer's time is the union of its spans' intervals, so
nested spans count once.  Times are in us.

    pipeline   photohive.pipeline
    entry      photohive.get_report and photohive.to_json, less the pipeline
    corpus     photohive.corpus.*, photohive.h2d and photohive.d2h, less the
               pipeline

Where every program span outside the pipeline lies in an entry or corpus
span, as on one card, the idle inside entry or corpus, inside the
pipeline and outside every program span adds up to all the window's idle.
"""

from __future__ import annotations

import bisect
import collections
from typing import Callable, Dict, List, Optional, Tuple

from .trace import TraceView, _stacks_at, _union

PREFIX = "photohive."
OUTSIDE = "outside any program span"
LAYERS: Dict[str, Callable[[str], bool]] = {
    "pipeline": lambda n: n == "photohive.pipeline",
    "entry": lambda n: n in ("photohive.get_report", "photohive.to_json"),
    "corpus": lambda n: n in ("photohive.h2d", "photohive.d2h")
    or n.startswith("photohive.corpus."),
}

Intervals = List[Tuple[float, float]]
INF = float("inf")


def intersect(x: Intervals, y: Intervals) -> Intervals:
    """The parts of sorted disjoint ``x`` inside sorted disjoint ``y``."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(x: Intervals, y: Intervals) -> Intervals:
    """The parts of sorted disjoint ``x`` outside sorted disjoint ``y``."""
    bounds = [-INF] + [t for ab in y for t in ab] + [INF]
    return intersect(x, [(a, b) for a, b in zip(bounds[::2], bounds[1::2])
                         if a < b])


def length(x: Intervals) -> float:
    return sum(b - a for a, b in x)


def main_spans(view: TraceView) -> List[dict]:
    """The program's span events on the window's main thread."""
    # TraceView keeps the host events it read, with no public accessor;
    # the spans are among them.
    return [e for e in view._host
            if e.get("cat") == "user_annotation"
            and e["name"].startswith(PREFIX)
            and (e.get("pid"), e.get("tid")) == view.main_tid]


def covered(spans: List[dict], keep: Callable[[str], bool]) -> Intervals:
    """Union of the intervals of the spans whose name ``keep`` accepts."""
    return _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in spans if keep(e["name"])], -INF, INF)


def layers(view: TraceView) -> Dict[str, Intervals]:
    """The main thread's time in each of ``LAYERS`` (entry and corpus less
    the pipeline), and in ``program``, any program span."""
    spans = main_spans(view)
    pipeline = covered(spans, LAYERS["pipeline"])
    out = {name: subtract(covered(spans, keep), pipeline)
           for name, keep in LAYERS.items() if name != "pipeline"}
    out["pipeline"] = pipeline
    out["program"] = covered(spans, lambda n: True)
    return out


def idle_ms_per_report(run, layer: str) -> Optional[float]:
    """Device-idle ms per report while the main thread was in ``layer``
    (a key of ``LAYERS``); None when the trace holds none of its spans."""
    if run.trace is None or not run.window.reports:
        return None
    if not any(LAYERS[layer](e["name"]) for e in main_spans(run.trace)):
        return None
    idle = length(intersect(run.trace.gaps(), layers(run.trace)[layer]))
    return idle * 1e-3 / run.window.reports


def sync_wait_ms_per_report(run) -> Optional[float]:
    """Host ms per report inside ``photohive.d2h`` spans nested in
    ``photohive.pipeline``, within the window; None when there are none."""
    if run.trace is None or not run.window.reports:
        return None
    spans = main_spans(run.trace)
    waits = intersect(covered(spans, lambda n: n == "photohive.d2h"),
                      covered(spans, LAYERS["pipeline"]))
    waits = intersect(waits, [(run.trace.t0, run.trace.t1)])
    return length(waits) * 1e-3 / run.window.reports if waits else None


def idle_by_span(view: TraceView) -> Dict[str, float]:
    """Device-idle seconds of the window by the innermost program span the
    main thread was in (``OUTSIDE`` for none), most first: each gap is cut
    at the spans' edges, and a piece goes to the innermost span holding
    its middle."""
    spans = main_spans(view)
    edges = sorted({float(e["ts"]) + d for e in spans
                    for d in (0.0, float(e["dur"]))})
    pieces = []
    for a, b in view.gaps():
        cuts = [a] + edges[bisect.bisect_right(edges, a):
                           bisect.bisect_left(edges, b)] + [b]
        pieces += [(x, y) for x, y in zip(cuts, cuts[1:]) if y > x]
    stacks = _stacks_at(spans, [((x + y) / 2, view.main_tid)
                                for x, y in pieces])
    out: Dict[str, float] = collections.Counter()
    for (x, y), stack in zip(pieces, stacks):
        out[stack[-1] if stack else OUTSIDE] += (y - x) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def split(view: TraceView) -> dict:
    """The window's idle seconds: all of it, inside entry or corpus spans,
    inside the pipeline, outside any program span; the share inside
    program spans; and the idle by innermost span."""
    by_layer = layers(view)
    gaps = view.gaps()
    idle = length(gaps)
    parts = {"entry_or_corpus": length(intersect(
                 gaps, _union(by_layer["entry"] + by_layer["corpus"],
                              -INF, INF))),
             "pipeline": length(intersect(gaps, by_layer["pipeline"])),
             "outside": length(subtract(gaps, by_layer["program"]))}
    return {"idle_s": idle * 1e-6,
            "layers_s": {k: v * 1e-6 for k, v in parts.items()},
            "inside_program_pct": 100.0 * (1 - parts["outside"] / idle)
            if idle else None,
            "idle_by_span_s": idle_by_span(view)}


def main(argv=None) -> int:
    """Run one cell traced, print its result line, then the traced
    window's idle by layer and by span (rank 0's on a mesh)."""
    import argparse
    import json

    from . import loops, run
    from .spec import load_cell

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    windows = []

    # run_cell hands back its result line, not its window: wrap the loops'
    # registry for this run to keep the window and its trace.
    def keeping(loop):
        def run_loop(ctx):
            windows.append(loop(ctx))
            return windows[-1]
        return run_loop

    saved = dict(loops.LOOPS)
    loops.LOOPS.update((name, keeping(loop)) for name, loop in saved.items())
    try:
        out = run.run_cell(load_cell(args.workload), args.seed,
                           args.seconds, True)
    finally:
        loops.LOOPS.update(saved)
    print(json.dumps(out))
    view = windows[-1].trace if windows and windows[-1] else None
    print(json.dumps(split(view) if view else None), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
