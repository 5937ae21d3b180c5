"""Device time of NCCL kernels on rank 0 per report."""


def read(run):
    if run.trace is None or not run.window.reports:
        return None
    seconds = sum(k.dur for k in run.trace.inside()
                  if k.cat == "kernel" and "nccl" in k.name.lower()) * 1e-6
    return seconds * 1e3 / run.window.reports if seconds > 0 else None
