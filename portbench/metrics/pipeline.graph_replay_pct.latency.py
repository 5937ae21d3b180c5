"""Percent of the window's photohive.pipeline ranges on the main thread
that hold a photohive.pipeline.replay range: the share of single-image
reports whose pipeline ran from CUDA graphs; None where the window holds
no replay range."""

import bisect

from portbench.spans import main_spans

PIPELINE = "photohive.pipeline"
REPLAY = "photohive.pipeline.replay"


def read(run):
    if run.trace is None:
        return None
    t0, t1 = run.trace.t0, run.trace.t1

    def ranges(name):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in main_spans(run.trace)
                      if e["name"] == name and t0 <= float(e["ts"]) <= t1)

    pipes, starts = ranges(PIPELINE), [a for a, _ in ranges(REPLAY)]
    if not pipes or not starts:
        return None
    # A replay range opens only inside a pipeline range, so a pipeline
    # range holds one where a replay starts between its two ends.
    held = sum(bisect.bisect_right(starts, b) > bisect.bisect_left(starts, a)
               for a, b in pipes)
    return 100.0 * held / len(pipes)
