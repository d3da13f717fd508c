"""Configuration system of the PyTorch port.

A copy of `eskf_lio_tpu/config.py`, kept in the port so that the port
imports nothing of the JAX package.  Fields, defaults and the YAML loader
are the same; `tests/test_torch_package.py` holds the two dataclasses
field for field so the copy cannot drift.  One field is the port's own and
comes last, `map_key_bits`, whose default is the JAX package's layout.
The schema is the reference's
(`config/hilti_config.yaml:1-53`) plus the static capacity knobs of the
fixed-shape design (the YAML `tpu:` section keeps its name, so one file
configures both packages).  Every time or rate quoted in the field
comments below was measured for the JAX package on a TPU; none is a figure
of this port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

GRAVITY_MAGNITUDE = 9.81


@dataclasses.dataclass(frozen=True)
class ImuConfig:
    """IMU intrinsics; raw datasheet units match the reference YAML
    (`hilti_config.yaml:9-17`), converted to SI in `noise_sigmas()` the same
    way the reference does in `ErrorStateKF.cpp:30-35`."""

    update_rate: float = 400.0
    bias_accel: tuple[float, float, float] = (0.0, 0.0, 0.0)
    bias_gyro: tuple[float, float, float] = (0.0, 0.0, 0.0)
    gravity: tuple[float, float, float] = (0.0, 0.0, GRAVITY_MAGNITUDE)
    accel_noise_density: tuple[float, float, float] = (105.0, 105.0, 135.0)  # µg/√Hz
    accel_zero_g_offset: float = 20.0  # mg
    gyro_noise_density: float = 0.014  # deg/s/√Hz
    gyro_zero_rate_offset: float = 1.0  # deg/s

    def noise_sigmas(self) -> dict[str, np.ndarray]:
        """Continuous->discrete noise conversion (ref `ErrorStateKF.cpp:30-41`)."""
        rate_sqrt = math.sqrt(self.update_rate)
        sigma_accel = (
            np.asarray(self.accel_noise_density, np.float64)
            * 1e-6
            * GRAVITY_MAGNITUDE
            * rate_sqrt
        )
        sigma_gyro = self.gyro_noise_density * rate_sqrt * math.pi / 180.0
        sigma_accel_walk = (
            self.accel_zero_g_offset * rate_sqrt * 1e-3 * GRAVITY_MAGNITUDE
        )
        sigma_gyro_walk = self.gyro_zero_rate_offset * rate_sqrt * math.pi / 180.0
        return {
            "accel_noise": sigma_accel,
            "gyro_noise": np.full(3, sigma_gyro),
            "accel_walk": np.full(3, sigma_accel_walk),
            "gyro_walk": np.full(3, sigma_gyro_walk),
        }


@dataclasses.dataclass(frozen=True)
class Config:
    """Full framework configuration (one flat frozen dataclass => hashable,
    usable as a jit static argument)."""

    # --- sensors ---------------------------------------------------------
    imu: ImuConfig = dataclasses.field(default_factory=ImuConfig)
    # LiDAR -> IMU extrinsics, quaternion xyzw + translation
    # (ref `hilti_config.yaml:22-23`).
    lidar_quat_xyzw: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    lidar_translation: tuple[float, float, float] = (0.0, 0.0, 0.0)

    # --- kalman filter (ref `hilti_config.yaml:34-36`) -------------------
    # The reference ships 1e-6/1e-6; with those, the velocity cross-gain
    # K_v = P_vp/(P_pp+V) is so hot that ICP pose noise feeds back through
    # deskew/prediction and the velocity estimate oscillates (measured:
    # |v| swings 2-8 m/s on a 1.8 m/s trajectory, then metres of drift).
    # V ~ 1e-3 damps the loop: on the synthetic benchmark ATE drops
    # 37 cm -> 0.5 cm and VGICP converges in <=3 iterations.  The reference
    # never noticed because it validates visually only (README.md:70-73).
    # Loading the reference YAML still applies its values verbatim.
    translation_noise: float = 1.0e-3
    rotation_noise: float = 3.0e-4
    init_P: float = 1.0e-3  # ref `Types.hpp:40`

    # --- local map (ref `hilti_config.yaml:38-45`) -----------------------
    map_voxel_size: float = 0.3
    max_points_per_voxel: int = 1000
    map_update_translation_sq_threshold: float = 1.0e-2
    map_update_cosine_threshold: float = 0.985
    remove_distant_points: bool = True
    remove_distance_threshold: float = 100.0
    remove_period: float = 10.0  # seconds of *sensor* time (deliberate change
    # from the reference's wall clock, `LocalMap.cpp:60` — reproducibility)

    # --- cloud preprocessor (ref `hilti_config.yaml:47-48`) --------------
    downsample_voxel_size: float = 0.3
    covariance_plane_factor: float = 1e-2  # ref `CloudPreprocessor.hpp:30-31`
    min_neighbors_for_covariance: int = 3  # ref `CloudPreprocessor.cpp:113`

    # --- registration (ref `hilti_config.yaml:50-53`) --------------------
    icp_max_iterations: int = 100
    icp_translation_sq_threshold: float = 1.0e-6
    icp_cosine_threshold: float = 0.9999
    # Re-match correspondences every k-th GN iteration (1 = the
    # reference's per-iteration re-matching, `Registration.cpp:16`).
    # Blind schedule — measured k=2 gives +31 % throughput but 1.8->3.4 cm
    # ATE, because the skipped re-match lands on the LARGE early steps.
    # Superseded by the adaptive threshold below; kept for parity/ablation.
    icp_relookup_every: int = 1
    # Adaptive lazy re-association (round-5): before each GN iteration,
    # bound how far the PREVIOUS increment could have moved any scan point
    # (theta * scan_radius + |(R-I)c + t|, c = scan centroid); below this
    # threshold (metres) the correspondences from the last re-match are
    # reused and the bucket gathers are skipped.  MEASURED on the heavy
    # bench (tools/ate_matrix.py, tools/probe_adaptive.py): the skip is
    # real (align 7.5 -> 3.1 ms when fully frozen) but freezing also makes
    # the convergence check fire early on stale matches — the increment is
    # computed against the SAME correspondences, so it biases toward zero
    # and the loop exits before the re-match residual is seen.  0.01 m:
    # 91.2 scans/s at 2.14 cm vs exact 88.6 at 1.81 cm.  The sub-voxel
    # re-matches carry mm-level signal (border points flipping voxels), so
    # every skip-based schedule trades ATE; default OFF = exact reference
    # re-match-every-iteration semantics.  The knob remains for
    # throughput-first deployments.
    icp_rematch_threshold: float = 0.0
    # Normal-equations backend: "auto" | "einsum" (batched 3x6 products) |
    # "pallas" (the fused normal-equations kernel; in this port that is the
    # CUDA kernel of `ops/gn_normal_eq.py`).  In the port "auto" and
    # "pallas" both take the fused path, which launches the CUDA kernel on
    # CUDA tensors and runs its plain PyTorch version on CPU tensors.
    gn_backend: str = "auto"

    # --- TPU static capacities (new; no reference counterpart) -----------
    max_raw_points: int = 131072  # per-scan raw point budget (padded)
    max_scan_points: int = 32768  # post-downsample point budget (padded)
    # Correspondence budget for the GN loop: align reads only the first
    # `max_align_points` rows of the processed scan (the downsampler emits
    # live voxels as a contiguous ascending-key prefix, so the slice is a
    # free static slice).  The per-iteration map lookup is latency-bound
    # PER QUERY ROW (~22 ns/row incl. padding, tools/probe_align_parts.py)
    # and is ~96 % of align, so halving the query rows nearly halves the
    # dominant stage.  Insertion still uses the full scan budget — no map
    # data is lost.  Live voxels beyond the budget are dropped from
    # correspondence only and counted in `align_slice_overflow`; a warm
    # heavy sweep occupies ~13k distinct voxels (BASELINE.md: real sensors
    # 8-20k), so 16384 does not bind in practice.  None = max_scan_points
    # (reference parity: every downsampled point participates).
    max_align_points: int | None = 16384
    max_imu_per_scan: int = 64  # IMU samples per scan interval (padded)
    hash_capacity_log2: int = 19  # voxel-map slots = 2**19 = 524288
    map_delta_log2: int | None = None  # LSM delta-tier slots (default C/16).
    # Trade-off: a larger delta makes folds (O(C) sorts + view rebuild,
    # ~tens of ms at 2^19) rarer but its view probe/scatter slightly
    # pricier per scan.  In steady state the world saturates and the
    # delta only accumulates genuinely new voxels, so folds are rare even
    # at C/16 = 2^15 (near the measured 2^14 sweet spot, with d_view
    # bucket load low enough that overflow drops stay ~zero); transient
    # bursts where a batch's new voxels exceed the delta fold the batch
    # straight into MAIN and never drop data.
    dtype: str = "float32"

    # --- parallelism -----------------------------------------------------
    mesh_axis_name: str = "map"
    # Per-device point-slice capacity factor for the compute-sharded step:
    # each device compacts the points it owns into a static
    # ceil(max_scan_points / n_devices * shard_slack) slice (rounded up to a
    # multiple of 128) before the GN einsums and the map insert, so
    # per-device FLOPs scale as N/D.  Candidates past the slice capacity are
    # dropped and counted in the step diagnostics.
    shard_slack: float = 2.0
    # GN ownership halo (metres): a device claims a point for registration
    # if it owns ANY voxel within +-halo of the point's guess-pose position.
    # The shard-local lookup is the exact ownership filter (off-shard keys
    # never hit), so duplication across devices cannot double-count; the
    # halo only guarantees that a point still finds its owner after the
    # pose moves up to `halo` metres away from the guess during GN.
    # Must be < map_voxel_size; costs ~(1 + 6*halo/voxel_size)x slice load.
    shard_halo: float = 0.02
    # --- the port's own (no JAX counterpart) -----------------------------
    # The voxel map's key split: bits per axis (x, y, z) of the packed key
    # around the map's origin, which each eviction re-centres on the sensor
    # (`map/voxel_map.py`, `ops/sortmerge.py::pack_keys`).  (10, 10, 10) is
    # the JAX package's layout, +-512 voxels a side (+-153.6 m at 0.3 m);
    # at most 31 bits in all.  A car that travels ~100 m between evictions
    # and sees 100 m ahead needs more: (11, 11, 9) is +-307.2 m across and
    # +-76.8 m in height at 0.3 m (benchmark/configs/hdl64-urban.json).
    map_key_bits: tuple[int, int, int] = (10, 10, 10)

    @property
    def hash_capacity(self) -> int:
        return 1 << self.hash_capacity_log2

    @property
    def align_capacity(self) -> int:
        if self.max_align_points is None:
            return self.max_scan_points
        return min(self.max_align_points, self.max_scan_points)

    @property
    def map_delta_capacity(self) -> int | None:
        return None if self.map_delta_log2 is None else 1 << self.map_delta_log2


def _get(d: dict, path: list[str], default: Any = None) -> Any:
    cur: Any = d
    for k in path:
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


def load_config(path: str) -> Config:
    """Load a reference-schema YAML file (`hilti_config.yaml`) into a Config.

    Unknown keys are ignored; missing keys keep defaults, so both the exact
    reference schema and extended schemas (with a `tpu:` section for the
    capacity knobs) load.
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)

    imu_params = _get(raw, ["sensors", "imu", "intrinsics", "parameters"], {}) or {}
    imu = ImuConfig(
        update_rate=_get(raw, ["sensors", "imu", "update_rate"], 400.0),
        bias_accel=tuple(imu_params.get("bias_a", (0.0, 0.0, 0.0))),
        bias_gyro=tuple(imu_params.get("bias_g", (0.0, 0.0, 0.0))),
        gravity=tuple(imu_params.get("gravity", (0.0, 0.0, GRAVITY_MAGNITUDE))),
        accel_noise_density=tuple(
            imu_params.get("accel_noise_density", (105.0, 105.0, 135.0))
        ),
        accel_zero_g_offset=imu_params.get("accel_zero_g_offset", 20.0),
        gyro_noise_density=imu_params.get("gyro_noise_density", 0.014),
        gyro_zero_rate_offset=imu_params.get("gyro_zero_rate_offset", 1.0),
    )

    kwargs: dict[str, Any] = dict(
        imu=imu,
        lidar_quat_xyzw=tuple(
            _get(raw, ["sensors", "lidar", "extrinsics", "quaternion"], (0, 0, 0, 1))
        ),
        lidar_translation=tuple(
            _get(raw, ["sensors", "lidar", "extrinsics", "translation"], (0, 0, 0))
        ),
        translation_noise=_get(
            raw, ["kalman_filter", "update", "translation_noise"], 1e-6
        ),
        rotation_noise=_get(raw, ["kalman_filter", "update", "rotation_noise"], 1e-6),
        map_voxel_size=_get(raw, ["local_map", "voxel_size"], 0.3),
        max_points_per_voxel=_get(raw, ["local_map", "max_num_points_per_voxel"], 1000),
        map_update_translation_sq_threshold=_get(
            raw, ["local_map", "update", "translation_sq_threshold"], 1e-2
        ),
        map_update_cosine_threshold=_get(
            raw, ["local_map", "update", "cosine_threshold"], 0.985
        ),
        remove_distant_points=_get(
            raw, ["local_map", "remove_distant_points", "enabled"], True
        ),
        remove_distance_threshold=_get(
            raw, ["local_map", "remove_distant_points", "distance_threshold"], 100.0
        ),
        remove_period=_get(
            raw, ["local_map", "remove_distant_points", "removing_period"], 10.0
        ),
        downsample_voxel_size=_get(raw, ["cloud_preprocessor", "voxel_size"], 0.3),
        icp_max_iterations=_get(raw, ["registration", "max_iteration"], 100),
        icp_translation_sq_threshold=_get(
            raw, ["registration", "translation_sq_threshold"], 1e-6
        ),
        icp_cosine_threshold=_get(raw, ["registration", "cosine_threshold"], 0.9999),
    )

    # TPU-extension section (not present in the reference schema).
    tpu = raw.get("tpu", {}) or {}
    for key in (
        "map_delta_log2",
        "max_raw_points",
        "max_scan_points",
        "max_imu_per_scan",
        "hash_capacity_log2",
        "dtype",
        "mesh_axis_name",
        "shard_slack",
        "shard_halo",
        "gn_backend",
        "icp_relookup_every",
        "icp_rematch_threshold",
        "max_align_points",
    ):
        if key in tpu:
            kwargs[key] = tpu[key]
    if "map_key_bits" in tpu:
        kwargs["map_key_bits"] = tuple(int(b) for b in tpu["map_key_bits"])

    return Config(**kwargs)
