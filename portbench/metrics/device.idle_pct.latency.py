"""1 - (union of kernel, memcpy and memset intervals) / traced window, in
percent; averaged over the cards of a mesh."""

from portbench.trace import idle_pct


def read(run):
    return idle_pct(run)
