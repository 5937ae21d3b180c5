"""The blur profile's least time for the window's images (portbench.
roofline.blur_s, from their shapes) over the device time of the kernels
launched inside photohive::spectrum_bins, the off-gate blur route; None
where the trace holds no such operator.  The bound counts what the blur
profile needs, so it reads the same whatever implements the operator."""

from portbench import roofline
from portbench.trace import owned_seconds

OPS = ("photohive::spectrum_bins",)


def read(run):
    if run.trace is None or not run.window.reports:
        return None
    seconds, how = owned_seconds(run.trace, OPS, ())
    run.attribution["kernels.spectrum_bins_roofline_pct"] = how
    cfg = run.config["report_config"]
    least = sum(n * roofline.blur_s(h, w, cfg["angle_partitions"],
                                    cfg["radius_partitions"])
                for (h, w), n in run.window.shapes.items())
    return 100.0 * least / seconds if seconds > 0 else None
