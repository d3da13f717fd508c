"""Dependency-free rosbag2 ingestion (the port's copy of
`eskf_lio_tpu/io/rosbag2.py`: sqlite3 + struct + numpy, no device code).

The reference consumes a live ROS2 stream (`Subscriber.hpp:38-103`) fed by
`ros2 bag play` (`launch/eskf_lio.launch.py:11-13`).  No ROS is needed: a
rosbag2 file is just a sqlite3 database of CDR-serialized blobs — both in
the Python standard library's reach.  This module reads the bag directly:

* `topics` table → (id, name, type);
* `messages` table → (topic_id, timestamp, data);
* CDR (XCDR1, little-endian) decoding of `sensor_msgs/msg/Imu` and
  `sensor_msgs/msg/PointCloud2` with the same field extraction as the
  reference subscriber: x/y/z float32 + per-point float64 absolute
  `timestamp` (Hesai Pandar convention, `Subscriber.hpp:89-97`), sweep
  start/end from the first/last point (`Subscriber.hpp:99-101`).

Only the subset of CDR needed for these two fixed message types is
implemented (little-endian, no XCDR2 extensions) — exactly what rmw_fastrtps
writes for Hilti-2022 bags.
"""

from __future__ import annotations

import os
import sqlite3
import struct

import numpy as np

from eskf_lio_torch.io.dataset import ImuRecord, LidarRecord, Sequence


class _Cdr:
    """Minimal XCDR1 little-endian reader.  Alignment is relative to the
    start of the payload (after the 4-byte encapsulation header)."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("CDR blob too short")
        # encapsulation: {representation_id (2B, big-endian), options (2B)}
        rep = struct.unpack_from(">H", blob, 0)[0]
        if rep not in (0x0000, 0x0001, 0x0002, 0x0003):
            raise ValueError(f"unsupported CDR representation 0x{rep:04x}")
        if rep in (0x0000, 0x0002):  # {CDR,PL_CDR}_BE
            raise ValueError("big-endian CDR not supported")
        self.buf = blob
        self.pos = 4

    def _align(self, n: int) -> None:
        rel = self.pos - 4
        pad = (-rel) % n
        self.pos += pad

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def i32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<i", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def f64(self) -> float:
        self._align(8)
        v = struct.unpack_from("<d", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def f64n(self, n: int) -> None:
        self._align(8)
        self.pos += 8 * n

    def string(self) -> str:
        n = self.u32()  # includes the trailing NUL
        s = self.buf[self.pos : self.pos + max(n - 1, 0)]
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def bytes_seq(self) -> bytes:
        n = self.u32()
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def time(self) -> float:
        """builtin_interfaces/Time -> float64 seconds."""
        sec = self.i32()
        nsec = self.u32()
        return sec + nsec * 1e-9

    def header(self) -> float:
        t = self.time()
        self.string()  # frame_id
        return t


def parse_imu(blob: bytes) -> ImuRecord:
    """sensor_msgs/msg/Imu -> ImuRecord (ref `Subscriber.hpp:38-52`)."""
    c = _Cdr(blob)
    t = c.header()
    c.f64n(4)  # orientation quaternion (unused by the reference too)
    c.f64n(9)  # orientation_covariance
    gyro = np.array([c.f64(), c.f64(), c.f64()])
    c.f64n(9)  # angular_velocity_covariance
    accel = np.array([c.f64(), c.f64(), c.f64()])
    # linear_acceleration_covariance ignored (end of message)
    return ImuRecord(t=t, gyro=gyro, accel=accel)


_DATATYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 2, 5: 4, 6: 4, 7: 4, 8: 8}
FLOAT32, FLOAT64 = 7, 8


def parse_pointcloud2(blob: bytes) -> LidarRecord | None:
    """sensor_msgs/msg/PointCloud2 -> LidarRecord
    (ref `Subscriber.hpp:80-103`): reads x/y/z float32 and the per-point
    float64 absolute `timestamp` field; start/end times from the first and
    last point.  Returns None for an empty cloud."""
    c = _Cdr(blob)
    c.header()
    height = c.u32()
    width = c.u32()
    n_fields = c.u32()
    fields = {}
    for _ in range(n_fields):
        name = c.string()
        offset = c.u32()
        datatype = c.u8()
        count = c.u32()
        fields[name] = (offset, datatype, count)
    c.u8()  # is_bigendian
    point_step = c.u32()
    c.u32()  # row_step
    data = c.bytes_seq()
    n = height * width
    if n == 0 or point_step == 0:
        return None
    n = min(n, len(data) // point_step)

    raw = np.frombuffer(data[: n * point_step], dtype=np.uint8).reshape(
        n, point_step
    )

    def column(name: str, np_dtype, want_types) -> np.ndarray:
        off, dt, _ = fields[name]
        if dt not in want_types:
            raise ValueError(f"field {name}: unexpected datatype {dt}")
        width_b = np.dtype(np_dtype).itemsize
        return (
            raw[:, off : off + width_b]
            .copy()
            .view(np_dtype)
            .reshape(n)
        )

    xyz = np.stack(
        [
            column("x", np.float32, (FLOAT32,)),
            column("y", np.float32, (FLOAT32,)),
            column("z", np.float32, (FLOAT32,)),
        ],
        axis=1,
    )
    if "timestamp" in fields:
        # Hesai Pandar: float64 absolute seconds (`Subscriber.hpp:92`)
        ts = column("timestamp", np.float64, (FLOAT64,))
    elif "time" in fields:
        ts = column("time", np.float64, (FLOAT64,))
    else:
        raise ValueError(
            "PointCloud2 has no per-point 'timestamp' field; "
            f"fields = {sorted(fields)}"
        )
    # drop non-finite points (the reference relies on driver output being
    # clean; converted bags sometimes pad with NaNs)
    ok = np.isfinite(xyz).all(axis=1) & np.isfinite(ts)
    xyz, ts = xyz[ok], ts[ok]
    if len(ts) == 0:
        return None
    order = np.argsort(ts, kind="stable")
    xyz, ts = xyz[order], ts[order]
    return LidarRecord(
        points=np.ascontiguousarray(xyz, np.float32),
        t=ts,
        start_time=float(ts[0]),
        end_time=float(ts[-1]),
    )


def _db3_path(path: str) -> str:
    if os.path.isdir(path):
        db3 = sorted(
            f for f in os.listdir(path) if f.endswith(".db3")
        )
        if not db3:
            raise FileNotFoundError(f"no .db3 file in {path}")
        return os.path.join(path, db3[0])
    return path


def load_rosbag2(
    path: str,
    imu_topic: str = "/alphasense/imu",
    lidar_topic: str = "/hesai/pandar",
    max_scans: int | None = None,
) -> Sequence:
    """Read a rosbag2 directory (or .db3 file) into a Sequence.

    Topic defaults match the reference config (`hilti_config.yaml:3,20`)."""
    db = sqlite3.connect(f"file:{_db3_path(path)}?mode=ro", uri=True)
    try:
        topics = {
            name: (tid, typ)
            for tid, name, typ in db.execute(
                "SELECT id, name, type FROM topics"
            )
        }
        for t in (imu_topic, lidar_topic):
            if t not in topics:
                raise KeyError(
                    f"topic {t!r} not in bag (has: {sorted(topics)})"
                )
        imu_id = topics[imu_topic][0]
        lidar_id = topics[lidar_topic][0]

        imu: list[ImuRecord] = []
        scans: list[LidarRecord] = []
        cur = db.execute(
            "SELECT topic_id, data FROM messages WHERE topic_id IN (?, ?) "
            "ORDER BY timestamp",
            (imu_id, lidar_id),
        )
        for topic_id, blob in cur:
            if topic_id == imu_id:
                imu.append(parse_imu(blob))
            else:
                if max_scans is not None and len(scans) >= max_scans:
                    continue
                rec = parse_pointcloud2(blob)
                if rec is not None:
                    scans.append(rec)
    finally:
        db.close()
    return Sequence(imu=imu, scans=scans)
