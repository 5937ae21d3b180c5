"""Device-idle ms per report while the main thread was inside
photohive.pipeline: the pipeline's own dispatch and its mid-pipeline
device read."""

from portbench.spans import idle_ms_per_report


def read(run):
    return idle_ms_per_report(run, "pipeline")
