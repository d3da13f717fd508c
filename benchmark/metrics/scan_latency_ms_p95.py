"""The nearest-rank 95th percentile over every sweep due in the window,
from its due time to its pose on the host; a sweep never posed is +inf
(host clock)."""

from benchmark import stats


def read(run):
    lat = run.get("latencies_s")
    return None if not lat else stats.percentile(lat, 95) * 1e3
