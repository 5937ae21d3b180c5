"""Device-idle ms per report while the main thread was inside
photohive.stage.sharpness.masked: the masked sharpness route's host work
of launching its operations; None where the trace holds no such span."""

from portbench.spans import covered, intersect, length, main_spans

SPAN = "photohive.stage.sharpness.masked"


def read(run):
    if run.trace is None or not run.window.reports:
        return None
    inside = covered(main_spans(run.trace), lambda n: n == SPAN)
    if not inside:
        return None
    idle = length(intersect(run.trace.gaps(), inside))
    return idle * 1e-3 / run.window.reports
