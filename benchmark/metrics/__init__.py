"""Per-metric readers: `<metric name>.py` holds `read(run)`, which returns
the metric from a driver's record of a run, or None where the run holds
nothing to read (the harness then leaves the metric out)."""
