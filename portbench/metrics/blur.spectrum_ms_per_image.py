"""Device ms per report of the kernels launched inside
photohive::spectrum_bins, the blur route of shapes outside the FFT
kernels' gate (tied to it by the launching operator's range); None where
the trace holds no such operator."""

from portbench.trace import owned_seconds

OPS = ("photohive::spectrum_bins",)


def read(run):
    if run.trace is None or not run.window.reports:
        return None
    seconds, how = owned_seconds(run.trace, OPS, ())
    run.attribution["blur.spectrum_ms_per_image"] = how
    return seconds * 1e3 / run.window.reports if seconds > 0 else None
