"""corpus.pinned_h2d_pct on synthetic traces: the share of host-to-device
bytes copied from page-locked memory."""

import pytest

from portbench.loops import Window
from portbench.tests.test_portbench_metrics import (Run, _event, read,
                                                    synthetic_trace)
from portbench.trace import TraceView


def test_pinned_share_of_the_host_to_device_bytes():
    """A 3 MB copy from pinned memory beside a 6.2 MB pageable one; the
    report read back into pinned memory is not counted."""
    pageable = Run(Window(reports=1), trace=synthetic_trace())
    assert read("corpus.pinned_h2d_pct", pageable) == 0.0
    ev = [_event("user_annotation", "portbench.window", 0, 1000),
          _event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 100, 100,
                 bytes=3_000_000),
          _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 300, 150,
                 bytes=6_220_800),
          _event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 600, 50,
                 bytes=9_000_000)]
    mixed = Run(Window(reports=1), trace=TraceView(ev))
    assert read("corpus.pinned_h2d_pct", mixed) == pytest.approx(
        100 * 3_000_000 / 9_220_800)
    assert read("corpus.pinned_h2d_pct", Run(Window(reports=1))) is None
