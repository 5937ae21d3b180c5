"""The plain reference report: NumPy and plain PyTorch, independent of the
program under test (it imports nothing of ``photohive_dsp_tpu_torch``)."""
