"""Megapixels of reports delivered on the host over the window's wall
time."""


def read(run):
    w = run.window
    return w.megapixels / w.seconds if w.reports and w.seconds > 0 else None
