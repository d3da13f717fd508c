"""The nearest-rank median over every sweep due in the window, from its
due time to its pose on the host (host clock)."""

from benchmark import stats


def read(run):
    lat = run.get("latencies_s")
    return None if not lat else stats.percentile(lat, 50) * 1e3
