"""Device-idle ms per request while the main thread was inside
photohive.get_report or photohive.to_json and outside photohive.pipeline:
what the frame copy, the report read, Report and to_json cost the card."""

from portbench.spans import idle_ms_per_report


def read(run):
    return idle_ms_per_report(run, "entry")
