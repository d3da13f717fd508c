"""The one traffic generator: a LiDAR-inertial stream made from a seed.

A copy of `eskf_lio_torch/io/dataset.py::make_synthetic_sequence` (a box
room with pillars, a circular trajectory with bobbing that starts at rest,
per-point timestamped sweeps, biased and noisy IMU), rewritten in torch so
that the sweeps are made on the device in a few large calls.  Two changes
make a window of any length cheap:

* the trajectory is exactly periodic after its ramp: the loop and the bob
  take whole periods of `period_s` (the mix sets both periods), so a
  benchmark generates the ramp from rest and ONE period, then continues
  the stream by replaying the period's records shifted by whole periods;
* IMU samples sit half a sample off the sweep ends, so no sample ever
  coincides with a sweep's end and which samples a sweep's chunk takes
  does not depend on when they arrive.

The body frame is the IMU's; the points are measured in the LiDAR's frame,
placed in the IMU frame by the configuration's extrinsics, and kept between
the sensor's `min_range_m` and `max_range_m` of the body.

The scene (pillars) comes from the mix's `scene.seed` and the sensor's
realisation (the points' times and surface samples, their ranging noise,
the IMU noise) from its `stream_seed`: one site and one recording, the
same for every run.  A run's `--seed` draws the order: the phase of the
period at which its window starts, among the mix's `phases` (and the rows
its check samples), so that every seed's window holds the same sweeps in
another order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

START_TIME = 1000.0  # absolute sensor time of the stream's start (s)
GRAVITY_W = (0.0, 0.0, -9.81)


@dataclasses.dataclass
class Stream:
    """Generated records, in absolute f64 sensor time, on the host.

    Sweep i (0-based) ends at `sweep_end[i]`; sweep 0 is the init scan.
    Sweeps `ramp_sweeps` .. `ramp_sweeps + period_sweeps - 1` are one
    period, and so are the IMU samples after `ramp_imu`.  Stream sweep k and
    stream IMU sample i continue past the generated records by replaying
    the period shifted by whole periods (`sweep_index`, `imu_block`)."""

    imu_t: np.ndarray  # [M] f64
    imu_gyro: np.ndarray  # [M, 3] f64
    imu_accel: np.ndarray  # [M, 3] f64
    sweep_end: np.ndarray  # [S] f64
    sweep_points: np.ndarray  # [S, n, 3] f32, sensor frame
    sweep_t: np.ndarray  # [S, n] f64 absolute point times
    gt_positions: np.ndarray  # [S, 3] f64 at sweep ends
    ramp_sweeps: int
    period_sweeps: int
    ramp_imu: int
    period_s: float

    def sweep_index(self, k: int) -> tuple[int, float]:
        """(generated sweep, time shift in s) of stream sweep k."""
        if k < self.ramp_sweeps:
            return k, 0.0
        j = k - self.ramp_sweeps
        return self.ramp_sweeps + j % self.period_sweeps, (j // self.period_sweeps) * self.period_s

    def sweep_end_of(self, k: int) -> float:
        i, shift = self.sweep_index(k)
        return float(self.sweep_end[i] + shift)

    def imu_block(self, i0: int, i1: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stream IMU samples i0 .. i1 - 1 as (t, gyro, accel) arrays."""
        i = np.arange(i0, i1)
        n_period = len(self.imu_t) - self.ramp_imu
        j = np.maximum(i - self.ramp_imu, 0)
        src = np.where(i < self.ramp_imu, i, self.ramp_imu + j % n_period)
        shift = np.where(i < self.ramp_imu, 0.0, (j // n_period) * self.period_s)
        return self.imu_t[src] + shift, self.imu_gyro[src], self.imu_accel[src]

    def imu_after(self, t: float) -> int:
        """The first stream IMU sample later than sensor time t."""
        n_period = len(self.imu_t) - self.ramp_imu
        ramp_end = self.imu_t[self.ramp_imu - 1]
        if t < ramp_end:
            return int(np.searchsorted(self.imu_t[: self.ramp_imu], t, side="right"))
        c = int((t - ramp_end) // self.period_s)
        for cc in (c - 1, c, c + 1):
            if cc < 0:
                continue
            block = self.imu_t[self.ramp_imu:] + cc * self.period_s
            j = int(np.searchsorted(block, t, side="right"))
            if j < n_period:
                return self.ramp_imu + cc * n_period + j
        raise ValueError(f"no IMU sample after {t}")


def trajectory(t: torch.Tensor, traj: dict):
    """(position [..., 3], yaw [...], velocity [..., 3], acceleration, yaw
    rate) of the analytic trajectory at times `t` (s since the start)."""
    tau = traj["ramp_tau_s"]
    e = torch.exp(-t / tau)

    def phase(omega):
        return omega * (t - tau + tau * e), omega * (1.0 - e), omega / tau * e

    th, dth, ddth = phase(2 * math.pi / traj["period_s"])
    ps, dps, ddps = phase(2 * math.pi / traj["bob_period_s"])
    r, bob = traj["radius_m"], traj["bob_m"]
    pos = torch.stack([r * torch.cos(th), r * torch.sin(th),
                       traj["z0_m"] + bob * torch.sin(ps)], -1)
    vel = torch.stack([-r * dth * torch.sin(th), r * dth * torch.cos(th),
                       bob * dps * torch.cos(ps)], -1)
    acc = torch.stack([
        -r * (ddth * torch.sin(th) + dth**2 * torch.cos(th)),
        r * (ddth * torch.cos(th) - dth**2 * torch.sin(th)),
        bob * (ddps * torch.cos(ps) - dps**2 * torch.sin(ps)),
    ], -1)
    return pos, th + math.pi / 2, vel, acc, dth


def _rot_z(yaw: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _surface_pool(scene: dict, n: int, n_sweeps: int, gen: torch.Generator, dev):
    """[n_sweeps, P, 3] surface samples of the room, sized as
    `SyntheticWorld.sample_visible` sizes them for n points."""
    h, z_top = scene["half_m"], scene["height_m"]
    pillars = np.random.default_rng(scene["seed"])
    margin = h - 3.0
    centers = pillars.uniform(-margin, margin, size=(scene["pillars"], 2))
    radii = pillars.uniform(0.4, 1.2, size=scene["pillars"])
    f64 = torch.float64

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(n_sweeps, *shape, generator=gen, device=dev, dtype=f64)

    m = n // 4
    parts = [torch.stack([u(-h, h, m), u(-h, h, m), torch.zeros(n_sweeps, m, dtype=f64, device=dev)], -1)]
    mm = m // 2
    for k in range(4):
        a, z = u(-h, h, mm), u(0.0, z_top, mm)
        side = torch.full_like(a, -h if k in (0, 2) else h)
        parts.append(torch.stack([a, side, z] if k < 2 else [side, a, z], -1))
    mm = max(1, m // len(radii))
    for (cx, cy), r in zip(centers, radii):
        ang, z = u(0.0, 2 * math.pi, mm), u(0.0, z_top * 0.8, mm)
        parts.append(torch.stack([cx + r * torch.cos(ang), cy + r * torch.sin(ang), z], -1))
    return torch.cat(parts, 1)


def _quat_to_mat(xyzw, dev) -> torch.Tensor:
    x, y, z, w = (float(c) for c in xyzw)
    n = math.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return torch.tensor([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                         [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                         [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]],
                        dtype=torch.float64, device=dev)


def generate(sensor: dict, mix: dict, seed: int, device, *, lidar_quat_xyzw, lidar_translation,
             chunk_sweeps: int = 20) -> Stream:
    """The stream made from `seed`: `mix["ramp_s"]` seconds from rest, then
    one period, with the sensor of `sensor` (points a sweep, rates, noises,
    ranges) mounted at the LiDAR-to-IMU extrinsics given."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    traj, scene = mix["trajectory"], mix["scene"]
    rate, imu_rate = sensor["scan_rate_hz"], sensor["imu_rate_hz"]
    n = sensor["points_per_sweep"]
    ramp_sweeps = round(mix["ramp_s"] * rate)
    period_sweeps = round(traj["period_s"] * rate)
    n_sweeps = ramp_sweeps + period_sweeps
    duration = n_sweeps / rate
    period_imu = round(traj["period_s"] * imu_rate)
    f64 = torch.float64
    R_il = _quat_to_mat(lidar_quat_xyzw, dev)
    t_il = torch.tensor(lidar_translation, dtype=f64, device=dev)

    # IMU over the ramp and the period, half a sample off the sweep ends
    n_imu = round(duration * imu_rate)
    t_imu = (torch.arange(n_imu, dtype=f64, device=dev) + 0.5) / imu_rate
    _, yaw, _, acc_w, dyaw = trajectory(t_imu, traj)
    R = _rot_z(yaw)
    g_w = torch.tensor(GRAVITY_W, dtype=f64, device=dev)
    accel = torch.einsum("nji,nj->ni", R, acc_w - g_w)
    gyro = torch.stack([torch.zeros_like(dyaw), torch.zeros_like(dyaw), dyaw], -1)
    gyro = gyro + torch.tensor(sensor["gyro_bias"], dtype=f64, device=dev) + sensor[
        "imu_noise_gyro"] * torch.randn(n_imu, 3, generator=gen, device=dev, dtype=f64)
    accel = accel + torch.tensor(sensor["accel_bias"], dtype=f64, device=dev) + sensor[
        "imu_noise_accel"] * torch.randn(n_imu, 3, generator=gen, device=dev, dtype=f64)

    sweep = 1.0 / rate
    ends = torch.arange(1, n_sweeps + 1, dtype=f64, device=dev) * sweep
    pts_out = np.empty((n_sweeps, n, 3), np.float32)
    t_out = np.empty((n_sweeps, n), np.float64)
    for s0 in range(0, n_sweeps, chunk_sweeps):
        s1 = min(s0 + chunk_sweeps, n_sweeps)
        k = s1 - s0
        t_rel = torch.sort(-sweep * 0.99 * torch.rand(k, n, generator=gen, device=dev, dtype=f64), 1)[0]
        t_pts = ends[s0:s1, None] + t_rel
        pos_end = trajectory(ends[s0:s1], traj)[0]
        pool = _surface_pool(scene, n, k, gen, dev)
        dist = torch.linalg.norm(pool - pos_end[:, None], dim=-1)
        keep = (dist > sensor["min_range_m"]) & (dist < sensor["max_range_m"])
        # the kept samples first (stable), then n draws among them
        order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
        n_kept = keep.sum(1, keepdim=True)
        pick = (torch.rand(k, n, generator=gen, device=dev, dtype=f64) * n_kept).long()
        pts_w = torch.gather(pool, 1, torch.gather(order, 1, pick)[..., None].expand(k, n, 3))
        pos_t, yaw_t = trajectory(t_pts, traj)[:2]
        body = torch.einsum("snji,snj->sni", _rot_z(yaw_t), pts_w - pos_t)
        body = (body - t_il) @ R_il  # the LiDAR's frame: R_il^T (p - t_il)
        body = body + sensor["point_noise_m"] * torch.randn(k, n, 3, generator=gen, device=dev, dtype=f64)
        pts_out[s0:s1] = body.to(torch.float32).cpu().numpy()
        t_out[s0:s1] = (t_pts + START_TIME).cpu().numpy()
    return Stream(
        imu_t=t_imu.cpu().numpy() + START_TIME,
        imu_gyro=gyro.cpu().numpy(), imu_accel=accel.cpu().numpy(),
        sweep_end=ends.cpu().numpy() + START_TIME,
        sweep_points=pts_out, sweep_t=t_out,
        gt_positions=trajectory(ends, traj)[0].cpu().numpy(),
        ramp_sweeps=ramp_sweeps, period_sweeps=period_sweeps,
        ramp_imu=n_imu - period_imu, period_s=float(traj["period_s"]),
    )
