"""Device ms per report of the kernels launched inside
photohive::masked_sharpness, the masked sharpness route (tied to it by
the launching operator's range); None where the trace holds no such
operator."""

from portbench.trace import owned_seconds

OPS = ("photohive::masked_sharpness",)


def read(run):
    if run.trace is None or not run.window.reports:
        return None
    seconds, how = owned_seconds(run.trace, OPS, ())
    run.attribution["sharpness.masked_ms_per_image"] = how
    return seconds * 1e3 / run.window.reports if seconds > 0 else None
