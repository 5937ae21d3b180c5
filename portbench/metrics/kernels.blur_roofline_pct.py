"""The blur profile's least time for the window's images (portbench.
roofline, from their shapes) over the device time of the kernels launched
inside the FFT and polar operators."""

from portbench import roofline
from portbench.trace import owned_seconds

OPS = ("photohive::fft_rows", "photohive::fft_cols",
       "photohive::polar_lognorm")
NAMES = ("fft_rows_kernel", "fft_cols_kernel", "polar_lognorm_kernel",
         "polar_finish")


def read(run):
    if run.trace is None or not run.window.reports:
        return None
    seconds, how = owned_seconds(run.trace, OPS, NAMES)
    run.attribution["kernels.blur_roofline_pct"] = how
    cfg = run.config["report_config"]
    least = sum(n * roofline.blur_s(h, w, cfg["angle_partitions"],
                                    cfg["radius_partitions"])
                for (h, w), n in run.window.shapes.items())
    return 100.0 * least / seconds if seconds > 0 else None
