"""Device-idle ms per report while the main thread was inside
photohive.corpus.* or a photohive.h2d / photohive.d2h span outside
photohive.pipeline: the corpus layer's staging (rank 0's trace on a
mesh)."""

from portbench.spans import idle_ms_per_report


def read(run):
    return idle_ms_per_report(run, "corpus")
