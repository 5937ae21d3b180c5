"""Host utilities: image IO and the resumable corpus runner (io),
profiling, NaN hunting (debug) and the visualisations (viz)."""
