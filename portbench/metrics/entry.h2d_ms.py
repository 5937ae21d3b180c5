"""Device time of host-to-device copies per report (the pageable frame
copy of get_report)."""

from portbench.trace import memcpy


def read(run):
    if run.trace is None or not run.window.reports:
        return None
    seconds, _ = memcpy(run.trace, "HtoD")
    return seconds * 1e3 / run.window.reports if seconds else None
