"""The palette's least time for the window's images (portbench.roofline,
from their shapes) over the device time of the kernels launched inside the
palette operators."""

from portbench import roofline
from portbench.trace import owned_seconds

OPS = ("photohive::cell_counts_s", "photohive::margin_sort",
       "photohive::palette_sums_q1", "photohive::palette_sums",
       "photohive::cell_counts_hsv", "photohive::palette_sums_hsv",
       "photohive::palette_sums_cwide")
NAMES = ("cell_counts_s_kernel", "cell_counts_s_finish",
         "palette_sums_kernel", "palette_sums_finish", "margin_sort_kernel")


def read(run):
    if run.trace is None or not run.window.reports:
        return None
    seconds, how = owned_seconds(run.trace, OPS, NAMES)
    run.attribution["kernels.palette_roofline_pct"] = how
    cfg = run.config["report_config"]
    cells = cfg["h_partitions"] * cfg["s_partitions"] * cfg["v_partitions"] \
        + cfg["v_partitions"] + 1
    least = sum(n * roofline.palette_s(h, w, cells)
                for (h, w), n in run.window.shapes.items())
    return 100.0 * least / seconds if seconds > 0 else None
