"""The handheld traffic generator: an operator walks a spinning 32-beam LiDAR
and its IMU, held in the hand, around a free-standing building, made from a
seed.

The site (`site`, from the mix's `scene.seed`) is one building box with
piers and floor bands standing out of its core, so that its windows are
recesses; neighbouring buildings 20-40 m off its facades, a ring of far
buildings beyond 100 m (seen from the near side of the walk only, so that
eviction removes them), cylinders of trees and poles, a few parked cars and
the ground plane: the urban scene's primitives, cast by `urban.cast`.

The walk is a closed loop a few metres off the facades, the urban
generator's `Route` (straights, raised-cosine 90 degree left turns, a speed
dip through each, exactly periodic after a quintic ramp from rest) at a
walker's pace.  On top of it the hand moves: a vertical gait bob, roll and
pitch sway, and a pan in yaw, each a sine with a whole number of cycles a
lap, run on the loop's clock and faded in by a quintic smoothstep over the
ramp, so that the motion starts at rest, is C2 and is exactly periodic
after the ramp.  Body attitude: heading (the route's plus the pan), then
pitch, then roll, then the hold: the constant rotation that turns the
world's gravity, straight down, into the configuration's gravity vector in
the IMU's frame.  The filter starts at the identity, so the IMU frame at
rest is its world, and its gravity is the configuration's.

The sensor is `urban.py`'s: each ray cast from the LiDAR's pose at its
firing time, the nearest hit within range, Gaussian range noise, in the
LiDAR's frame.  The IMU samples at `imu_rate_hz` half a sample off the
sweep ends: the analytic body rates and specific force, plus the
configured biases and white noise of the sensor's standard deviations a
sample (per axis where it gives three).

As with the other generators, a benchmark generates the ramp and ONE lap
and continues the stream by replaying the lap shifted by whole laps
(`generator.Stream`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.traffic.generator import START_TIME, Stream, _quat_to_mat
from benchmark.traffic.urban import Route, _near, beam_directions, cast

F64 = torch.float64
OSCILLATIONS = ("bob", "roll", "pitch", "pan")  # the hand's motions, each a sine on the lap
MOTION_SWEEPS = 64  # sweeps whose firing poses `cast_sweeps` takes in one call


def _rot(axis: int, a: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotations by angles a about axis 0 (x), 1 (y) or 2 (z)."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    if axis == 0:
        rows = [[o, z, z], [z, c, -s], [z, s, c]]
    elif axis == 1:
        rows = [[c, z, s], [z, o, z], [-s, z, c]]
    else:
        rows = [[c, -s, z], [s, c, z], [z, z, o]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def hold_rotation(gravity) -> torch.Tensor:
    """[3, 3] R with R^T (0, 0, -|g|) = g: the IMU's attitude at rest in a
    world whose gravity points down -z, for the configuration's gravity g
    in the IMU's frame.  A half turn about x, then the shortest rotation
    that brings the flipped direction of g onto -z."""
    g = torch.tensor(gravity, dtype=F64)
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=F64))
    v = flip @ (g / torch.linalg.norm(g))  # where the flip takes g's direction
    down = torch.tensor([0.0, 0.0, -1.0], dtype=F64)
    axis = torch.linalg.cross(v, down)
    s, c = float(torch.linalg.norm(axis)), float(v @ down)
    if s < 1e-15:
        return flip
    k = axis / s
    K = torch.tensor([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]], dtype=F64)
    tilt = torch.eye(3, dtype=F64) + s * K + (1.0 - c) * (K @ K)
    return tilt @ flip


class Walk:
    """The rig's motion: the route of the mix's `walk.route` with the hand's
    oscillations on top (module docstring), on `device` in float64."""

    def __init__(self, walk: dict, ramp_s: float, gravity, device):
        self.dev = torch.device(device)
        self.route = Route(walk["route"], ramp_s, self.dev)
        self.period = self.route.period
        self.ramp_s = float(ramp_s)
        self.osc = {}
        for name in OSCILLATIONS:
            o = walk[name]
            scale = math.pi / 180.0 if name != "bob" else 1.0  # angles in degrees
            self.osc[name] = (2 * math.pi * int(o["cycles"]) / self.period, float(o["amp"]) * scale,
                              float(o["phase"]))
        self.hold = hold_rotation(gravity).to(self.dev)
        self.g_norm = float(np.linalg.norm(gravity))

    def _fade(self, t: torch.Tensor):
        """(s, s', s''): the quintic smoothstep of t over the ramp (the
        route's clock rate is this s)."""
        T = self.ramp_s
        x = torch.clamp(t / T, 0.0, 1.0)
        inside = t < T
        s = torch.where(inside, 10 * x**3 - 15 * x**4 + 6 * x**5, 1.0)
        ds = torch.where(inside, (30 * x**2 - 60 * x**3 + 30 * x**4) / T, 0.0)
        dds = torch.where(inside, (60 * x - 180 * x**2 + 120 * x**3) / T**2, 0.0)
        return s, ds, dds

    def oscillation(self, name: str, t: torch.Tensor):
        """(f, f', f'') of s(t) A sin(w u(t) + phase), u the loop's clock."""
        w, amp, ph = self.osc[name]
        u, du, ddu = self.route.clock(t)
        s, ds, dds = self._fade(t)
        arg = w * u + ph
        sn, cs = torch.sin(arg), torch.cos(arg)
        f = amp * s * sn
        df = amp * (ds * sn + s * w * du * cs)
        ddf = amp * (dds * sn + 2 * ds * w * du * cs + s * w * ddu * cs - s * (w * du) ** 2 * sn)
        return f, df, ddf

    def motion(self, t: torch.Tensor):
        """(position [..., 3], attitude R_wb [..., 3, 3], velocity [..., 3],
        acceleration [..., 3], body rates [..., 3] in the IMU's frame) at
        stream times t (s since the start)."""
        pos, heading, vel, acc, dheading = self.route.motion(t)
        z, dz, ddz = self.oscillation("bob", t)
        lift = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], -1)
        pos = pos + lift
        vel = vel + torch.stack([torch.zeros_like(z), torch.zeros_like(z), dz], -1)
        acc = acc + torch.stack([torch.zeros_like(z), torch.zeros_like(z), ddz], -1)
        pan, dpan, _ = self.oscillation("pan", t)
        roll, droll, _ = self.oscillation("roll", t)
        pitch, dpitch, _ = self.oscillation("pitch", t)
        yaw, dyaw = heading + pan, dheading + dpan
        R = _rot(2, yaw) @ _rot(1, pitch) @ _rot(0, roll) @ self.hold
        # Z-Y-X Euler rates in the frame after the roll, then through the hold
        sr, cr, sp, cp = torch.sin(roll), torch.cos(roll), torch.sin(pitch), torch.cos(pitch)
        w_euler = torch.stack([droll - dyaw * sp, dpitch * cr + dyaw * sr * cp,
                               -dpitch * sr + dyaw * cr * cp], -1)
        return pos, R, vel, acc, w_euler @ self.hold  # hold^T w, row-wise

    def gravity_w(self) -> torch.Tensor:
        return torch.tensor([0.0, 0.0, -self.g_norm], dtype=F64, device=self.dev)


def site(walk: Walk, mix_scene: dict) -> dict:
    """The site around the walk as primitives (float64 numpy): `boxes`
    [B, 6] (x0, y0, z0, x1, y1, z1) and `cylinders` [C, 4] (x, y, radius,
    height), drawn from `mix_scene["seed"]`."""
    rng = np.random.default_rng(mix_scene["seed"])
    y_a, x_b, y_c, x_d = walk.route.sides()
    off = float(mix_scene["setback_m"])  # the walk's straights to the facades
    bx0, bx1, by0, by1 = x_d + off, x_b - off, y_a + off, y_c - off
    h = rng.uniform(*mix_scene["building_height_m"])
    recess = rng.uniform(*mix_scene["recess_m"])
    boxes = [(bx0 + recess, by0 + recess, 0.0, bx1 - recess, by1 - recess, h)]  # the core
    floor, band = float(mix_scene["floor_m"]), float(mix_scene["band_m"])
    pier_w, pier_gap = mix_scene["pier_width_m"], mix_scene["pier_gap_m"]
    # each facade: floor bands and piers from the facade line in to the core
    for side in range(4):
        if side in (0, 2):
            a0, a1, line = bx0, bx1, (by0 if side == 0 else by1)
        else:
            a0, a1, line = by0, by1, (bx0 if side == 3 else bx1)
        inward = 1.0 if side in (0, 3) else -1.0
        n0, n1 = sorted((line, line + inward * recess))

        def put(l0, l1, z0, z1):
            boxes.append((l0, n0, z0, l1, n1, z1) if side in (0, 2) else (n0, l0, z0, n1, l1, z1))

        zf = 0.0
        while zf < h - band:
            put(a0, a1, zf, zf + band)
            zf += floor
        put(a0, a1, h - band, h)  # the parapet
        p = a0
        while p < a1:
            pw = min(rng.uniform(*pier_w), a1 - p)
            put(p, p + pw, 0.0, h)
            p += pw + rng.uniform(*pier_gap)
    # neighbours: rows of buildings facing each facade, 20-40 m off it
    lo_w, hi_w = mix_scene["neighbour_front_m"]
    lo_d, hi_d = mix_scene["neighbour_depth_m"]
    lo_h, hi_h = mix_scene["neighbour_height_m"]
    lo_o, hi_o = mix_scene["neighbour_offset_m"]
    reach = float(mix_scene["neighbour_reach_m"])
    for side in range(4):
        along = (bx0 - reach, bx1 + reach) if side in (0, 2) else (by0 - reach, by1 + reach)
        a = along[0] + rng.uniform(0.0, hi_w / 2)
        while a < along[1]:
            w, d, hh = rng.uniform(lo_w, hi_w), rng.uniform(lo_d, hi_d), rng.uniform(lo_h, hi_h)
            o = rng.uniform(lo_o, hi_o)
            if side == 0:
                boxes.append((a, by0 - o - d, 0.0, a + w, by0 - o, hh))
            elif side == 2:
                boxes.append((a, by1 + o, 0.0, a + w, by1 + o + d, hh))
            elif side == 1:
                boxes.append((bx1 + o, a, 0.0, bx1 + o + d, a + w, hh))
            else:
                boxes.append((bx0 - o - d, a, 0.0, bx0 - o, a + w, hh))
            a += w + rng.uniform(*mix_scene["neighbour_gap_m"])
    # the far ring: buildings at 100+ m from the site's centre
    cx, cy = 0.5 * (bx0 + bx1), 0.5 * (by0 + by1)
    n_far = int(mix_scene["far_count"])
    lo_r, hi_r = mix_scene["far_radius_m"]
    for i in range(n_far):
        ang = 2 * math.pi * (i + rng.uniform(0.0, 0.6)) / n_far
        r = rng.uniform(lo_r, hi_r)
        w, d, hh = rng.uniform(*mix_scene["far_front_m"]), rng.uniform(lo_d, hi_d), rng.uniform(
            *mix_scene["far_height_m"])
        x, y = cx + r * math.cos(ang), cy + r * math.sin(ang)
        boxes.append((x - w / 2, y - d / 2, 0.0, x + w / 2, y + d / 2, hh))
    # parked cars along the first neighbour row's street, outside the walk
    car = mix_scene["car_m"]
    y_car = by0 - off - float(mix_scene["car_street_m"])
    a = bx0 - 10.0
    while a + car[0] < bx1 + 10.0:
        if rng.uniform() < mix_scene["car_p"]:
            boxes.append((a, y_car - car[1] / 2, 0.0, a + car[0], y_car + car[1] / 2, car[2]))
        a += float(mix_scene["car_slot_m"])
    # trees and poles outside the walk: a ring between it and the neighbours
    cyls = []
    ring = off + float(mix_scene["tree_offset_m"])
    for side in range(4):
        if side in (0, 2):
            a0, a1, c = bx0 - ring, bx1 + ring, (by0 - ring if side == 0 else by1 + ring)
        else:
            a0, a1, c = by0 - ring, by1 + ring, (bx0 - ring if side == 3 else bx1 + ring)
        a = a0 + rng.uniform(0.0, mix_scene["tree_gap_m"][0])
        while a < a1:
            rad, hh = rng.uniform(*mix_scene["tree_radius_m"]), rng.uniform(*mix_scene["tree_height_m"])
            cyls.append((a, c, rad, hh) if side in (0, 2) else (c, a, rad, hh))
            a += rng.uniform(*mix_scene["tree_gap_m"])
    return {"boxes": np.asarray(boxes, np.float64), "cylinders": np.asarray(cyls, np.float64)}


def cast_sweeps(walk: Walk, world: dict, sensor: dict, sweeps, gen: torch.Generator, device, *,
                lidar_quat_xyzw, lidar_translation) -> dict:
    """{sweep: (points [n, 3] float32 in the LiDAR's frame, their firing
    times [n] in s since the start)} of the given sweeps, each ray cast from
    the LiDAR's pose at its firing time (`urban.cast_sweeps` with the full
    attitude).  The rig's poses are taken for `MOTION_SWEEPS` sweeps' firings
    in one call; the casts and their noise go sweep by sweep."""
    dev = torch.device(device)
    R_il = _quat_to_mat(lidar_quat_xyzw, dev)
    t_il = torch.tensor(lidar_translation, dtype=F64, device=dev)
    lo, hi = float(sensor["min_range_m"]), float(sensor["max_range_m"])
    boxes = torch.as_tensor(world["boxes"], device=dev)
    cyls = torch.as_tensor(world["cylinders"], device=dev)
    rays_l = beam_directions(sensor, dev)  # [A, L, 3]
    n_az, n_beams = rays_l.shape[:2]
    sweep = 1.0 / sensor["scan_rate_hz"]
    frac = (torch.arange(n_az, dtype=F64, device=dev) + 0.5) / n_az
    sweeps = list(sweeps)
    out = {}
    for g0 in range(0, len(sweeps), MOTION_SWEEPS):
        group = sweeps[g0:g0 + MOTION_SWEEPS]
        t_group = (torch.tensor(group, dtype=F64, device=dev)[:, None] + frac) * sweep  # [S, A]
        pos_g, R_g = walk.motion(t_group.reshape(-1))[:2]
        for j, s in enumerate(group):
            t_fire = t_group[j]
            pos, R_wb = pos_g[j * n_az:(j + 1) * n_az], R_g[j * n_az:(j + 1) * n_az]
            origin = pos + R_wb @ t_il
            mid = origin[n_az // 2]
            shift = torch.stack([mid[0], mid[1], torch.zeros_like(mid[2])])
            near_b = _near(boxes, mid[:2], hi + 2.0, cyl=False) - torch.cat([shift, shift])
            near_c = _near(cyls, mid[:2], hi + 2.0, cyl=True)
            near_c = torch.cat([near_c[:, :2] - mid[:2], near_c[:, 2:]], -1)
            d_w = torch.einsum("aij,alj->ali", R_wb @ R_il, rays_l).reshape(-1, 3)
            o = (origin - shift)[:, None, :].expand(-1, n_beams, -1).reshape(-1, 3)
            rng_m = cast(o.float(), d_w.float(), near_b.float(), near_c.float()).double()
            keep = (rng_m >= lo) & (rng_m <= hi)
            noisy = rng_m + sensor["range_noise_m"] * torch.randn(rng_m.shape, generator=gen,
                                                                  device=dev, dtype=F64)
            pts = (noisy[:, None] * rays_l.reshape(-1, 3))[keep]
            t_pts = t_fire[:, None].expand(-1, n_beams).reshape(-1)[keep]
            out[s] = (pts.to(torch.float32).cpu().numpy(), t_pts.cpu().numpy())
    return out


def imu(walk: Walk, sensor: dict, t: torch.Tensor, gen: torch.Generator | None):
    """(gyro [n, 3], accel [n, 3]) at stream times t: the body rates and the
    specific force R^T (a - g), plus the sensor's biases and, with `gen`,
    its white noise."""
    dev = t.device
    _, R, _, acc_w, w_b = walk.motion(t)
    accel = torch.einsum("nji,nj->ni", R, acc_w - walk.gravity_w())
    gyro = w_b + torch.tensor(sensor["gyro_bias"], dtype=F64, device=dev)
    accel = accel + torch.tensor(sensor["accel_bias"], dtype=F64, device=dev)
    if gen is not None:
        n = t.shape[0]
        sg = torch.tensor(sensor["imu_noise_gyro"], dtype=F64, device=dev)
        sa = torch.tensor(sensor["imu_noise_accel"], dtype=F64, device=dev)
        gyro = gyro + sg * torch.randn(n, 3, generator=gen, device=dev, dtype=F64)
        accel = accel + sa * torch.randn(n, 3, generator=gen, device=dev, dtype=F64)
    return gyro, accel


def generate(sensor: dict, mix: dict, seed: int, device, *, lidar_quat_xyzw, lidar_translation,
             gravity, sweeps: int | None = None) -> Stream:
    """The stream made from `seed`: `mix["ramp_s"]` seconds from rest, then
    one lap of the walk, with the sensor of `sensor` mounted at the
    LiDAR-to-IMU extrinsics given, in a world of the given gravity (the
    configuration's, in the IMU's frame at rest).  `sweeps`: only the first
    so many sweeps and the IMU through them (tests)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    walk = Walk(mix["walk"], mix["ramp_s"], gravity, dev)
    rate, imu_rate = sensor["scan_rate_hz"], sensor["imu_rate_hz"]
    ramp_sweeps = round(mix["ramp_s"] * rate)
    period_sweeps = round(walk.period * rate)
    n_sweeps = ramp_sweeps + period_sweeps
    period_imu = round(walk.period * imu_rate)
    n_imu = round(n_sweeps / rate * imu_rate)
    ramp_imu = n_imu - period_imu
    if sweeps is not None:
        n_sweeps = min(n_sweeps, int(sweeps))
        n_imu = min(n_imu, round((n_sweeps + 1) / rate * imu_rate))
    t_imu = (torch.arange(n_imu, dtype=F64, device=dev) + 0.5) / imu_rate
    gyro, accel = imu(walk, sensor, t_imu, gen)

    world = site(walk, mix["scene"])
    swept = cast_sweeps(walk, world, sensor, range(n_sweeps), gen, dev,
                        lidar_quat_xyzw=lidar_quat_xyzw, lidar_translation=lidar_translation)
    ends = torch.arange(1, n_sweeps + 1, dtype=F64, device=dev) / rate
    return Stream(
        imu_t=t_imu.cpu().numpy() + START_TIME,
        imu_gyro=gyro.cpu().numpy(), imu_accel=accel.cpu().numpy(),
        sweep_end=ends.cpu().numpy() + START_TIME,
        sweep_points=[swept[i][0] for i in range(n_sweeps)],
        sweep_t=[swept[i][1] + START_TIME for i in range(n_sweeps)],
        gt_positions=walk.motion(ends)[0].cpu().numpy(),
        ramp_sweeps=ramp_sweeps, period_sweeps=period_sweeps,
        ramp_imu=ramp_imu, period_s=float(walk.period),
    )
