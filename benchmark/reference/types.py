"""Frozen copy of `eskf_lio_torch/types.py` for the benchmark's plain reference.

Kernel calls and device control flow are replaced by the plain versions
in `benchmark/reference/plain.py`; the arithmetic is the port's at the
commit that added the benchmark.  The original docstring follows.

Core state types of the port (counterpart of `eskf_lio_tpu/types.py`).

Every piece of odometry state is a NamedTuple of fixed-shape tensors on one
device, with the JAX package's field names, shapes and layouts, so the two
packages can be compared array for array.  Times on the device are f32
seconds relative to the current scan's end; absolute f64 timestamps stay on
the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FilterState(NamedTuple):
    """18-DoF error-state KF nominal state + covariance.  Error-state
    ordering: [δp 0:3, δv 3:6, δθ 6:9, δb_a 9:12, δb_g 12:15, δg 15:18]."""

    p: torch.Tensor  # [3] position (world)
    v: torch.Tensor  # [3] velocity (world)
    q: torch.Tensor  # [4] attitude quaternion, wxyz, body->world
    ba: torch.Tensor  # [3] accelerometer bias
    bg: torch.Tensor  # [3] gyroscope bias
    g: torch.Tensor  # [3] gravity (world)
    P: torch.Tensor  # [18, 18] error covariance


class ImuChunk(NamedTuple):
    """A fixed-capacity batch of IMU samples driving one scan interval,
    padded to `max_imu_per_scan`; `valid` masks real samples."""

    dt: torch.Tensor  # [M] seconds since previous sample (>= 0)
    t_rel: torch.Tensor  # [M] sample time relative to scan end (s)
    gyro: torch.Tensor  # [M, 3] rad/s
    accel: torch.Tensor  # [M, 3] m/s^2
    valid: torch.Tensor  # [M] bool


class StateHistory(NamedTuple):
    """Pose trajectory through an ImuChunk, for deskew.  Index 0 is the
    pre-chunk state; index i+1 is the state after sample i."""

    t_rel: torch.Tensor  # [M+1] time relative to scan end
    p: torch.Tensor  # [M+1, 3]
    q: torch.Tensor  # [M+1, 4]
    valid: torch.Tensor  # [M+1] bool (entry 0 always valid)


class Scan(NamedTuple):
    """A fixed-capacity raw LiDAR scan in sensor frame, padded to
    `max_raw_points`."""

    points: torch.Tensor  # [N, 3]
    t_rel: torch.Tensor  # [N] point time relative to scan end (<= 0)
    valid: torch.Tensor  # [N] bool


class ProcessedScan(NamedTuple):
    """Deskewed + downsampled scan with per-point covariances, padded to
    `max_scan_points`."""

    points: torch.Tensor  # [K, 3] (IMU/body frame at scan end)
    covs: torch.Tensor  # [K, 3, 3] regularised plane covariances
    valid: torch.Tensor  # [K] bool


class Pose(NamedTuple):
    """Rigid transform as rotation matrix + translation."""

    R: torch.Tensor  # [3, 3]
    t: torch.Tensor  # [3]

    @staticmethod
    def identity(device: torch.device | str, dtype=torch.float32) -> "Pose":
        return Pose(
            torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device),
        )

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other (apply `other` first)."""
        return Pose(self.R @ other.R, self.R @ other.t + self.t)

    def inverse(self) -> "Pose":
        Rt = self.R.T
        return Pose(Rt, -(Rt @ self.t))

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return pts @ self.R.T + self.t
