"""All rows the window completed over all of the window's time, between
the two synchronizes (host clock)."""

from benchmark import stats


def read(run):
    if "rows" not in run:
        return None
    return stats.rate(run["rows"], run["host_window_s"])
