"""CUDA kernel launches plus memcpy calls per report, counted from the
profiler's CUDA runtime events in the window."""

from portbench.trace import launch_count


def read(run):
    if run.trace is None or not run.window.reports:
        return None
    n = launch_count(run.trace)
    return n / run.window.reports if n else None
