"""Percent of the window's host-to-device bytes copied from page-locked
host memory ("Pinned -> Device"; a bare "Pinned" would match the copies
back too): 0.0 when every copy is pageable, None without a trace or
without a host-to-device copy (rank 0's trace on a mesh)."""

from portbench.trace import memcpy


def read(run):
    if run.trace is None:
        return None
    _, pinned = memcpy(run.trace, "Pinned -> Device")
    _, total = memcpy(run.trace, "HtoD")
    return 100.0 * pinned / total if total > 0 else None
