"""Host ms per report inside photohive.d2h spans nested in
photohive.pipeline: the palette tier's read, the stages' one blocking
device read."""

from portbench.spans import sync_wait_ms_per_report


def read(run):
    return sync_wait_ms_per_report(run)
