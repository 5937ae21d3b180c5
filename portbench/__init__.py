"""portbench: the benchmark of ``photohive_dsp_tpu_torch`` on NVIDIA GPUs.

Run one cell of ``BENCHMARK.json`` from the root of a checkout:

    python3 -m portbench.run --workload photo_1080p.upload --seed 7 \
        --seconds 10 --trace 0

The package is driven by data: a configuration is a file under
``configs/``, a traffic mix one under ``traffic/``, each metric a reader
under ``metrics/``; the harness finds each by the name ``BENCHMARK.json``
gives it.  ``reference/`` is the plain report the outputs are held to.
Nothing here imports JAX or the JAX package.
"""
