"""Gives this test process its share of the cores for torch's intra-op
threads: the cores it may run on, divided by the number of pytest-xdist
workers (1 in a serial run).  Every ``tests/test_torch_*.py`` imports it,
so a single file run gets the same count as the whole suite.

Without it each worker's OpenMP pool spins on every core: six workers on
eight cores keep 48 threads on 8, and a test that takes 3.7 s alone takes
minutes in the suite.  The environment is left as it is (no
``OMP_NUM_THREADS``), so child processes see what they would see without
it; the rank processes of ``torch_spatial_ranks`` set one thread each."""

import os

import torch

torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
