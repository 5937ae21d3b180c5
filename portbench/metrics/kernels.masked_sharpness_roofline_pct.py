"""The masked sharpness route's least time for the window's images
(portbench.roofline_sharpness, from the configuration's boxes at their
shapes) over the device time of the kernels launched inside
photohive::masked_sharpness; None where the trace holds no such
operator."""

from portbench import roofline_sharpness
from portbench.trace import owned_seconds

OPS = ("photohive::masked_sharpness",)


def read(run):
    if run.trace is None or not run.window.reports:
        return None
    seconds, how = owned_seconds(run.trace, OPS, ())
    run.attribution["kernels.masked_sharpness_roofline_pct"] = how
    boxes = run.config.get("boxes", [])
    least = sum(n * roofline_sharpness.masked_sharpness_s(boxes, h, w)
                for (h, w), n in run.window.shapes.items())
    return 100.0 * least / seconds if seconds > 0 else None
