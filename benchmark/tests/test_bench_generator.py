"""The generator's stream: continuous at the period's wrap, and continued
past it by whole periods."""

import json
import math

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.traffic import generator
from benchmark.tests import small


@pytest.mark.parametrize("mix", ["replay", "live10hz"])
def test_the_wrap_jumps_less_than_the_point_noise(mix):
    """Pose, yaw and velocity at the ramp's end and one period later differ
    by less than the 8 mm ranging noise (velocity over one sweep)."""
    m = json.loads((harness.HERE / "mixes" / f"{mix}.json").read_text())
    noise = json.loads((harness.HERE / "configs" / "mid360.json").read_text())["sensor"]
    t = torch.tensor([m["ramp_s"], m["ramp_s"] + m["trajectory"]["period_s"]], dtype=torch.float64)
    pos, yaw, vel, acc, _ = generator.trajectory(t, m["trajectory"])
    r = m["trajectory"]["radius_m"]
    assert float(torch.linalg.norm(pos[1] - pos[0])) < noise["point_noise_m"]
    assert abs(float(yaw[1] - yaw[0]) - 2 * math.pi) * r < noise["point_noise_m"]
    assert float(torch.linalg.norm(vel[1] - vel[0])) * 0.1 < noise["point_noise_m"]
    assert float(torch.linalg.norm(acc[1] - acc[0])) * 0.1**2 < noise["point_noise_m"]


def test_the_stream_continues_the_period():
    c = small.cell()
    conf = c.config["config"]
    lidar = dict(lidar_quat_xyzw=conf["lidar_quat_xyzw"], lidar_translation=conf["lidar_translation"])
    s = generator.generate(c.config["sensor"], c.mix, 2**31 + 5, "cpu", **lidar)
    n_gen = s.ramp_sweeps + s.period_sweeps
    assert s.sweep_points.shape == (n_gen, c.config["sensor"]["points_per_sweep"], 3)
    ends = np.array([s.sweep_end_of(k) for k in range(3 * n_gen)])
    assert np.allclose(np.diff(ends), 0.1, atol=1e-9)
    # IMU: evenly spaced across every wrap, never at a sweep's end
    t, g, a = s.imu_block(0, 3 * len(s.imu_t))
    rate = c.config["sensor"]["imu_rate_hz"]
    assert np.allclose(np.diff(t), 1 / rate, atol=1e-9)
    period = len(s.imu_t) - s.ramp_imu
    assert np.array_equal(g[s.ramp_imu: s.ramp_imu + period], g[s.ramp_imu + period: s.ramp_imu + 2 * period])
    frac = ((t - ends[0]) * 10) % 1  # in sweeps after the nearest earlier end
    assert np.min(np.minimum(frac, 1 - frac)) > 0.5 / rate * 10 - 1e-6
    for k in (5, s.ramp_sweeps + 3, n_gen + 7, 2 * n_gen + 1):
        i = s.imu_after(ends[k])
        assert t[i] > ends[k] >= t[i - 1]
    # the same seed gives the same stream
    again = generator.generate(c.config["sensor"], c.mix, 2**31 + 5, "cpu", **lidar)
    assert np.array_equal(again.sweep_points, s.sweep_points) and np.array_equal(again.imu_accel, s.imu_accel)


def test_the_points_are_measured_in_the_lidar_frame():
    """A LiDAR mounted at t in the IMU frame sees every point moved by -t:
    the same stream with the extrinsics left out differs by t alone."""
    c = small.cell()
    t = (-0.011, -0.02329, 0.04412)
    at = generator.generate(c.config["sensor"], c.mix, 2**31 + 9, "cpu",
                            lidar_quat_xyzw=(0.0, 0.0, 0.0, 1.0), lidar_translation=t)
    none = generator.generate(c.config["sensor"], c.mix, 2**31 + 9, "cpu",
                              lidar_quat_xyzw=(0.0, 0.0, 0.0, 1.0), lidar_translation=(0.0, 0.0, 0.0))
    np.testing.assert_allclose(none.sweep_points - at.sweep_points, np.broadcast_to(t, at.sweep_points.shape),
                               atol=2e-6)
    assert np.array_equal(none.imu_accel, at.imu_accel)
