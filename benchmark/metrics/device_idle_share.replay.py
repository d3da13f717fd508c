"""1 - (the rows' device spans) / (last row's end - first row's start):
the share of the window's device timeline in which no row ran."""


def read(run):
    ms = run.get("row_spans_ms")
    if not ms or not run.get("device_window_ms"):
        return None
    return 1.0 - sum(ms) / run["device_window_ms"]
