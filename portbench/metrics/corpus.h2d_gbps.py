"""Bytes of host-to-device copies over their device time (pageable
against pinned staging)."""

from portbench.trace import memcpy


def read(run):
    if run.trace is None:
        return None
    seconds, nbytes = memcpy(run.trace, "HtoD")
    return nbytes / seconds / 1e9 if seconds > 0 and nbytes > 0 else None
