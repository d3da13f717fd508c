"""Measurement streams: synthetic simulator + npz sequence format.

A copy of `eskf_lio_tpu/io/dataset.py` (numpy only), kept in the PyTorch
port so that the port imports nothing of the JAX package.  The same seed
gives the same sequence in both packages.

The reference ingests a ROS2 bag (`Subscriber.hpp:38-103`; Hilti-2022
`exp21_outside_building`, `launch/eskf_lio.launch.py:11-13`).  This framework
is transport-agnostic: any source producing `(ImuRecord, LidarRecord)`
streams works.  Two sources ship:

* `SyntheticSequence` — an analytic trajectory through a closed box world
  with pillars, emitting exact (optionally biased/noisy) IMU and per-point-
  timestamped LiDAR sweeps.  Used for tests and benches (the Hilti bag is
  not redistributable inside this environment; the npz loader below accepts
  a converted bag when present).
* `load_npz` / `save_npz` — a flat array format for converted rosbags:
  imu_t [Mi] f64, imu_gyro [Mi,3], imu_accel [Mi,3],
  scan_offsets [S+1] int64, scan_t [P] f64 (absolute per-point times,
  Hesai convention — ref `Subscriber.hpp:92`), scan_xyz [P,3] f32.

All absolute times are float64 and stay on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ImuRecord:
    t: float  # absolute seconds (f64)
    gyro: np.ndarray  # [3] rad/s
    accel: np.ndarray  # [3] m/s^2


@dataclasses.dataclass
class LidarRecord:
    points: np.ndarray  # [N, 3] f32, sensor frame
    t: np.ndarray  # [N] f64 absolute per-point times
    start_time: float
    end_time: float


@dataclasses.dataclass
class Sequence:
    imu: list[ImuRecord]
    scans: list[LidarRecord]
    gt_times: np.ndarray | None = None  # [S] scan-end times
    gt_positions: np.ndarray | None = None  # [S, 3]
    gt_quats_wxyz: np.ndarray | None = None  # [S, 4]


# ---------------------------------------------------------------------------
# synthetic world
# ---------------------------------------------------------------------------


def _rot_z(theta: np.ndarray) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    zero, one = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [
            np.stack([c, -s, zero], -1),
            np.stack([s, c, zero], -1),
            np.stack([zero, zero, one], -1),
        ],
        axis=-2,
    )


class SyntheticWorld:
    """A box room (floor + 4 walls) with pillars; supplies surface samples
    with outward normals for scan simulation."""

    def __init__(self, rng: np.random.Generator, half: float = 10.0,
                 height: float = 5.0, n_pillars: int = 10):
        self.half = half
        self.height = height
        # pillars: vertical boxes at random xy
        margin = half - 3.0
        self.pillars = rng.uniform(-margin, margin, size=(n_pillars, 2))
        self.pillar_r = rng.uniform(0.4, 1.2, size=n_pillars)

    def sample_visible(
        self, rng: np.random.Generator, center: np.ndarray, n: int,
        max_range: float = 25.0,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Sample ~n surface points within range of `center`.
        Returns (points [n,3], normals [n,3]); crude visibility (no occlusion
        — adequate for odometry exercise)."""
        h, z_top = self.half, self.height
        parts, norms = [], []

        def keep(p, nv):
            d = np.linalg.norm(p - center, axis=-1)
            sel = d < max_range
            parts.append(p[sel])
            norms.append(np.tile(nv, (sel.sum(), 1)))

        m = n // 4
        # floor
        keep(
            np.column_stack(
                [rng.uniform(-h, h, m), rng.uniform(-h, h, m), np.zeros(m)]
            ),
            np.array([0.0, 0, 1]),
        )
        # walls
        for k in range(4):
            mm = m // 2
            u = rng.uniform(-h, h, mm)
            z = rng.uniform(0, z_top, mm)
            if k == 0:
                p, nv = np.column_stack([u, np.full(mm, -h), z]), [0.0, 1, 0]
            elif k == 1:
                p, nv = np.column_stack([u, np.full(mm, h), z]), [0.0, -1, 0]
            elif k == 2:
                p, nv = np.column_stack([np.full(mm, -h), u, z]), [1.0, 0, 0]
            else:
                p, nv = np.column_stack([np.full(mm, h), u, z]), [-1.0, 0, 0]
            keep(p, np.array(nv))
        # pillars (cylinders)
        mm = max(1, m // len(self.pillar_r))
        for (cx, cy), r in zip(self.pillars, self.pillar_r):
            ang = rng.uniform(0, 2 * np.pi, mm)
            z = rng.uniform(0, z_top * 0.8, mm)
            p = np.column_stack(
                [cx + r * np.cos(ang), cy + r * np.sin(ang), z]
            )
            nv_each = np.column_stack(
                [np.cos(ang), np.sin(ang), np.zeros(mm)]
            )
            d = np.linalg.norm(p - center, axis=-1)
            sel = d < max_range
            parts.append(p[sel])
            norms.append(nv_each[sel])

        pts = np.concatenate(parts).astype(np.float64)
        nvs = np.concatenate(norms).astype(np.float64)
        return pts, nvs


@dataclasses.dataclass
class TrajectoryParams:
    radius: float = 5.0
    omega: float = 0.35  # rad/s around the loop (steady state)
    bob: float = 0.25  # vertical bobbing amplitude
    bob_omega: float = 1.1
    z0: float = 1.37  # deliberately NOT a voxel-size multiple: an exactly
    # voxel-aligned planar floor is a degenerate case no real dataset has
    ramp_tau: float = 1.5  # velocity ramp time constant (starts at rest)


class AnalyticTrajectory:
    """Closed-form circular trajectory with yaw tracking the tangent, gentle
    vertical bobbing, and an exponential velocity ramp from rest — exact
    first/second derivatives for IMU synthesis.

    Phase: φ(t) = ω·(t − τ + τ·e^(−t/τ))  ⇒  φ'(0)=0 (starts at rest, like
    a handheld dataset — important because the first scan is inserted into
    the map without deskew, matching the reference's first-frame path
    (`Odometry.cpp:55-63`))."""

    def __init__(self, p: TrajectoryParams):
        self.p = p

    def _phase(self, t, omega):
        tau = self.p.ramp_tau
        e = np.exp(-t / tau)
        phi = omega * (t - tau + tau * e)
        dphi = omega * (1.0 - e)
        ddphi = omega / tau * e
        return phi, dphi, ddphi

    def pose(self, t):
        p = self.p
        th, _, _ = self._phase(t, p.omega)
        ps, _, _ = self._phase(t, p.bob_omega)
        pos = np.stack(
            [
                p.radius * np.cos(th),
                p.radius * np.sin(th),
                p.z0 + p.bob * np.sin(ps),
            ],
            axis=-1,
        )
        yaw = th + np.pi / 2
        return pos, _rot_z(yaw)

    def velocity(self, t):
        p = self.p
        th, dth, _ = self._phase(t, p.omega)
        ps, dps, _ = self._phase(t, p.bob_omega)
        return np.stack(
            [
                -p.radius * dth * np.sin(th),
                p.radius * dth * np.cos(th),
                p.bob * dps * np.cos(ps),
            ],
            axis=-1,
        )

    def imu(self, t, gravity_w=np.array([0.0, 0.0, -9.81])):
        """Exact body rates + specific force at time t."""
        p = self.p
        th, dth, ddth = self._phase(t, p.omega)
        ps, dps, ddps = self._phase(t, p.bob_omega)
        acc_w = np.stack(
            [
                -p.radius * (ddth * np.sin(th) + dth**2 * np.cos(th)),
                p.radius * (ddth * np.cos(th) - dth**2 * np.sin(th)),
                p.bob * (ddps * np.cos(ps) - dps**2 * np.sin(ps)),
            ],
            axis=-1,
        )
        _, R = self.pose(t)
        gyro_b = np.stack(
            [np.zeros_like(dth), np.zeros_like(dth), dth], axis=-1
        )
        accel_b = np.einsum("...ji,...j->...i", R, acc_w - gravity_w)
        return gyro_b, accel_b


def make_synthetic_sequence(
    duration: float = 20.0,
    imu_rate: float = 400.0,
    scan_rate: float = 10.0,
    points_per_scan: int = 20000,
    seed: int = 0,
    gyro_bias: np.ndarray | None = None,
    accel_bias: np.ndarray | None = None,
    imu_noise_gyro: float = 0.0,
    imu_noise_accel: float = 0.0,
    point_noise: float = 0.008,  # LiDAR ranging noise (m), ~Hesai class
    start_time: float = 1000.0,
    traj: TrajectoryParams | None = None,
) -> Sequence:
    """Generate a full synthetic LIO sequence with ground truth."""
    rng = np.random.default_rng(seed)
    world = SyntheticWorld(rng)
    trajectory = AnalyticTrajectory(traj or TrajectoryParams())
    g_w = np.array([0.0, 0.0, -9.81])
    gyro_bias = np.zeros(3) if gyro_bias is None else np.asarray(gyro_bias)
    accel_bias = np.zeros(3) if accel_bias is None else np.asarray(accel_bias)

    # IMU stream
    n_imu = int(duration * imu_rate)
    t_imu = start_time + np.arange(1, n_imu + 1) / imu_rate
    gyro, accel = trajectory.imu(t_imu - start_time, g_w)
    gyro = gyro + gyro_bias + imu_noise_gyro * rng.standard_normal((n_imu, 3))
    accel = (
        accel + accel_bias + imu_noise_accel * rng.standard_normal((n_imu, 3))
    )
    imu = [
        ImuRecord(t=float(t_imu[i]), gyro=gyro[i], accel=accel[i])
        for i in range(n_imu)
    ]

    # LiDAR stream: sweeps ending at k/scan_rate
    n_scans = int(duration * scan_rate) - 1
    scans = []
    gt_t, gt_p, gt_q = [], [], []
    sweep = 1.0 / scan_rate
    for k in range(1, n_scans + 1):
        t_end = start_time + k * sweep
        t_pts_rel = rng.uniform(-sweep * 0.99, 0.0, points_per_scan)
        t_pts_rel.sort()
        t_pts = t_end + t_pts_rel
        pos_end, R_end = trajectory.pose(t_end - start_time)

        pts_w, _ = world.sample_visible(rng, pos_end, points_per_scan)
        # subsample/pad to exactly points_per_scan
        idx = rng.integers(0, len(pts_w), points_per_scan)
        pts_w = pts_w[idx]

        # each point measured from the sensor pose at its own time
        pos_t, R_t = trajectory.pose(t_pts - start_time)
        body = np.einsum("nji,nj->ni", R_t, pts_w - pos_t)
        if point_noise > 0:
            body = body + point_noise * rng.standard_normal(body.shape)
        scans.append(
            LidarRecord(
                points=body.astype(np.float32),
                t=t_pts,
                start_time=float(t_pts[0]),
                end_time=float(t_end),
            )
        )
        gt_t.append(t_end)
        gt_p.append(pos_end)
        th, _, _ = trajectory._phase(t_end - start_time, trajectory.p.omega)
        yaw = th + np.pi / 2
        gt_q.append(np.array([np.cos(0.5 * yaw), 0.0, 0.0, np.sin(0.5 * yaw)]))

    return Sequence(
        imu=imu,
        scans=scans,
        gt_times=np.asarray(gt_t),
        gt_positions=np.asarray(gt_p),
        gt_quats_wxyz=np.asarray(gt_q),
    )


# ---------------------------------------------------------------------------
# npz sequence format (for converted rosbags)
# ---------------------------------------------------------------------------


def save_npz(path: str, seq: Sequence) -> None:
    offsets = np.cumsum([0] + [len(s.points) for s in seq.scans]).astype(np.int64)
    np.savez_compressed(
        path,
        imu_t=np.asarray([r.t for r in seq.imu]),
        imu_gyro=np.stack([r.gyro for r in seq.imu]),
        imu_accel=np.stack([r.accel for r in seq.imu]),
        scan_offsets=offsets,
        scan_xyz=np.concatenate([s.points for s in seq.scans]).astype(np.float32),
        scan_t=np.concatenate([s.t for s in seq.scans]),
        gt_times=seq.gt_times if seq.gt_times is not None else np.zeros(0),
        gt_positions=(
            seq.gt_positions if seq.gt_positions is not None else np.zeros((0, 3))
        ),
        gt_quats_wxyz=(
            seq.gt_quats_wxyz if seq.gt_quats_wxyz is not None else np.zeros((0, 4))
        ),
    )


def save_seq_bin(path: str, seq: Sequence) -> None:
    """Flat little-endian binary for the native reference-algorithm filter
    (`native/ref_filter.cpp`): the exact sequence the bench runs,
    so the reference trajectory and the measured baseline denominator come
    from the SAME workload.  Layout:

        magic   8 bytes  "ESKFSEQ1"
        i64     n_imu, n_scans, total_pts
        f64     imu_t [n_imu]
        f64     imu_gyro [n_imu, 3]
        f64     imu_accel [n_imu, 3]
        i64     scan_offsets [n_scans + 1]
        f64     scan_end_t [n_scans]
        f64     scan_t [total_pts]
        f32     scan_xyz [total_pts, 3]
    """
    offsets = np.cumsum([0] + [len(s.points) for s in seq.scans]).astype(
        np.int64
    )
    with open(path, "wb") as f:
        f.write(b"ESKFSEQ1")
        np.asarray(
            [len(seq.imu), len(seq.scans), int(offsets[-1])], np.int64
        ).tofile(f)
        np.asarray([r.t for r in seq.imu], np.float64).tofile(f)
        np.stack([r.gyro for r in seq.imu]).astype(np.float64).tofile(f)
        np.stack([r.accel for r in seq.imu]).astype(np.float64).tofile(f)
        offsets.tofile(f)
        np.asarray([s.end_time for s in seq.scans], np.float64).tofile(f)
        np.concatenate([s.t for s in seq.scans]).astype(np.float64).tofile(f)
        np.concatenate([s.points for s in seq.scans]).astype(
            np.float32
        ).tofile(f)


def load_npz(path: str) -> Sequence:
    z = np.load(path)
    imu = [
        ImuRecord(t=float(t), gyro=g, accel=a)
        for t, g, a in zip(z["imu_t"], z["imu_gyro"], z["imu_accel"])
    ]
    scans = []
    off = z["scan_offsets"]
    for i in range(len(off) - 1):
        pts = z["scan_xyz"][off[i]:off[i + 1]]
        ts = z["scan_t"][off[i]:off[i + 1]]
        scans.append(
            LidarRecord(
                points=pts, t=ts,
                start_time=float(ts[0]), end_time=float(ts[-1]),
            )
        )
    gt_t = z["gt_times"] if len(z["gt_times"]) else None
    return Sequence(
        imu=imu,
        scans=scans,
        gt_times=gt_t,
        gt_positions=z["gt_positions"] if gt_t is not None else None,
        gt_quats_wxyz=z["gt_quats_wxyz"] if gt_t is not None else None,
    )
