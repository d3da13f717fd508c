"""The end-to-end arithmetic over every sample of a window, and the
kernels' bounds against PERF.md's worked values."""

import math

import numpy as np
import pytest

from benchmark import harness, roofline, stats


def test_p95_takes_every_sample_so_a_stall_moves_it():
    steady = [0.010] * 300
    assert stats.percentile(steady, 95) == 0.010
    stalled = steady[:]
    for i in range(100, 120):  # a 2 s stall: 20 sweeps wait
        stalled[i] = 0.010 + (120 - i) * 0.1
    assert stats.percentile(stalled, 95) > 0.5
    assert stats.percentile(steady[:-1] + [math.inf], 95) == 0.010
    assert stats.percentile(steady[:280] + [math.inf] * 20, 95) == math.inf
    # nearest rank: 15 of 300 samples lie beyond the 95th percentile
    ranked = list(range(300))
    assert stats.percentile(ranked, 95) == 284


def test_the_rate_is_all_rows_over_all_the_window():
    run = {"rows": 6600, "host_window_s": 30.2}
    assert harness.reader("replay_scans_per_s")(run) == pytest.approx(6600 / 30.2)
    assert stats.rate(6600, 30.2) == pytest.approx(218.54, abs=0.01)


def test_the_kernels_bounds_are_perf_md_s():
    b = roofline.bound_ms(*roofline.segscan_cost(131072, 10))
    assert b == pytest.approx(0.00329, abs=5e-6)
    a = roofline.bound_ms(*roofline.gn_normal_eq_cost(32768, 32768))
    assert a == pytest.approx(0.000714, abs=5e-7)
    assert roofline.share_percent(a, 0.00510) == pytest.approx(14.0, abs=0.1)
    assert roofline.share_percent(a, 0.0) is None


def test_ate_is_zero_for_a_rigidly_moved_copy():
    rng = np.random.default_rng(1)
    gt = rng.normal(size=(50, 3))
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    assert stats.ate_rmse(gt @ R.T + [1, 2, 3], gt) < 1e-12
    assert stats.ate_rmse(gt + rng.normal(size=gt.shape) * 0.01, gt) > 0.005
