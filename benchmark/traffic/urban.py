"""The urban traffic generator: a car's spinning 64-beam LiDAR and its IMU,
driven around one block of a street grid, made from a seed.

The scene is a grid of streets between blocks of building boxes, a ground
plane, boxes of parked cars along the kerbs and cylinders of poles and
tree trunks on the pavements (`scene`, from the mix's `scene.seed`).  The
grid reaches past the route by more than the sensor's range, so that the
sensor sees down every cross street as far as it reaches.

The car drives counter-clockwise around one block, its sides `side_a_s` and
`side_b_s` seconds long (`Route`): at `v_straight_mps` on the straights,
slowing to `v_corner_mps` through each left turn.  The heading rate is a
raised cosine over `corner_s` that turns exactly 90 degrees, the speed dips
by a raised cosine over `brake_s`, so that the acceleration is continuous;
opposite sides repeat each other turned by 180 degrees, so that the loop
closes, and the motion is exactly periodic.  The car starts at rest in the
middle of the first side and reaches the loop's speed along a quintic
smoothstep of the loop's clock over `ramp_s` seconds (zero speed, rate and
acceleration at its start, none of them jumps at its end): after the ramp
the motion is exactly periodic.  Positions come from a table of the loop,
integrated by 4-point Gauss-Legendre quadrature at `table_dt_s` and read by
cubic Hermite interpolation with the analytic velocity (errors far below a
micrometre); velocity, acceleration and yaw rate are analytic.  Yaw only: the
body stays level at `z0_m`.

The sensor (the configuration's `sensor`) is a spinning LiDAR of `beams`
lasers at elevations spread over two blocks, `azimuth_steps` firings a
revolution at `scan_rate_hz`: each firing's time follows its azimuth, and
each ray is cast from the LiDAR's pose at that time (the body's pose and the
configuration's extrinsics).  A point is the nearest hit within
`min_range_m` .. `max_range_m`, its range with Gaussian noise of
`range_noise_m`, in the LiDAR's frame; a ray that meets nothing in range
gives no point, so a sweep holds fewer points than rays.  The IMU samples at
`imu_rate_hz` half a sample off the sweep ends, from the analytic
acceleration and yaw rate with the existing generator's noise and bias
model (`generator.py`).  The stream is made on the device, one sweep of
rays at a time against the primitives within reach of that sweep.

As with `generator.py`, a benchmark generates the ramp and ONE period and
continues the stream by replaying the period shifted by whole periods
(`generator.Stream`); a sweep's points are an array of its own length.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.traffic.generator import GRAVITY_W, START_TIME, Stream, _quat_to_mat, _rot_z

F64 = torch.float64
# 4-point Gauss-Legendre nodes and weights on [0, 1]
_GL_X = [0.5 - 0.5 * 0.8611363115940526, 0.5 - 0.5 * 0.3399810435848563,
         0.5 + 0.5 * 0.3399810435848563, 0.5 + 0.5 * 0.8611363115940526]
_GL_W = [0.5 * 0.3478548451374538, 0.5 * 0.6521451548625461,
         0.5 * 0.6521451548625461, 0.5 * 0.3478548451374538]


class Route:
    """The car's motion: the loop around one block (module docstring), on
    `device` in float64."""

    def __init__(self, route: dict, ramp_s: float, device):
        self.dev = torch.device(device)
        self.r = route
        self.ramp_s = float(ramp_s)
        qa, qb = float(route["side_a_s"]), float(route["side_b_s"])
        self.t_c, self.t_v = float(route["corner_s"]), float(route["brake_s"])
        if not self.t_c <= self.t_v < min(qa, qb):
            raise ValueError("a turn's braking must hold its turn and fit between two turns")
        self.period = 2.0 * (qa + qb)
        # the four left turns: sides a, b, a, b between them, the loop's
        # clock starting in the middle of an a side
        self.corners = torch.tensor([qa / 2, qa / 2 + qb, 1.5 * qa + qb, 1.5 * qa + 2 * qb],
                                    dtype=F64, device=self.dev)
        self.v_s, self.v_c = float(route["v_straight_mps"]), float(route["v_corner_mps"])
        self.z0 = float(route["z0_m"])
        self._table(float(route.get("table_dt_s", 0.002)))

    # the loop, as functions of its own clock u in [0, period)

    def _x(self, u: torch.Tensor) -> torch.Tensor:
        """[..., 4] signed time from each turn's centre."""
        return torch.remainder(u, self.period)[..., None] - self.corners

    def heading(self, u: torch.Tensor):
        """(heading, its rate, the rate's rate) at loop times u."""
        x, tc = self._x(u), self.t_c
        inside = x.abs() < tc / 2
        arg = 2 * math.pi * x / tc
        turned = torch.where(x >= tc / 2, 1.0, torch.where(
            inside, x / tc + 0.5 + torch.sin(arg) / (2 * math.pi), 0.0))
        rate = torch.where(inside, (1.0 + torch.cos(arg)) / tc, 0.0)
        rate2 = torch.where(inside, -2 * math.pi * torch.sin(arg) / tc**2, 0.0)
        laps = torch.floor(u / self.period)
        q = math.pi / 2
        return (q * turned.sum(-1) + 2 * math.pi * laps, q * rate.sum(-1), q * rate2.sum(-1))

    def speed(self, u: torch.Tensor):
        """(speed, its rate) at loop times u."""
        x, tv = self._x(u), self.t_v
        inside = x.abs() < tv / 2
        arg = 2 * math.pi * x / tv
        dip = torch.where(inside, 0.5 * (1.0 + torch.cos(arg)), 0.0).sum(-1)
        ddip = torch.where(inside, -math.pi / tv * torch.sin(arg), 0.0).sum(-1)
        dv = self.v_s - self.v_c
        return self.v_s - dv * dip, -dv * ddip

    def _velocity(self, u: torch.Tensor) -> torch.Tensor:
        th = self.heading(u)[0]
        v = self.speed(u)[0]
        return torch.stack([v * torch.cos(th), v * torch.sin(th)], -1)

    def _table(self, h: float) -> None:
        n = int(round(self.period / h))
        self.h = self.period / n
        u0 = torch.arange(n, dtype=F64, device=self.dev) * self.h
        step = torch.zeros(n, 2, dtype=F64, device=self.dev)
        for x, w in zip(_GL_X, _GL_W):
            step += w * self._velocity(u0 + x * self.h)
        pos = torch.cat([torch.zeros(1, 2, dtype=F64, device=self.dev),
                         torch.cumsum(step * self.h, 0)])
        self.closure_m = float(torch.linalg.norm(pos[-1]))
        self.table = pos
        self.table_vel = self._velocity(torch.arange(n + 1, dtype=F64, device=self.dev) * self.h)

    def position(self, u: torch.Tensor) -> torch.Tensor:
        """[..., 2] loop position at loop times u (cubic Hermite)."""
        w = torch.remainder(u, self.period) / self.h
        i = torch.clamp(torch.floor(w).long(), 0, self.table.shape[0] - 2)
        s = (w - i)[..., None]
        p0, p1 = self.table[i], self.table[i + 1]
        m0, m1 = self.table_vel[i] * self.h, self.table_vel[i + 1] * self.h
        s2, s3 = s * s, s * s * s
        return ((2 * s3 - 3 * s2 + 1) * p0 + (s3 - 2 * s2 + s) * m0
                + (-2 * s3 + 3 * s2) * p1 + (s3 - s2) * m1)

    # the stream's clock t (s since the start) onto the loop's clock

    def clock(self, t: torch.Tensor):
        """(u, du/dt, d2u/dt2): a quintic smoothstep of the rate over the
        ramp, then u = t - ramp_s / 2."""
        T = self.ramp_s
        x = torch.clamp(t / T, 0.0, 1.0)
        u = torch.where(t < T, T * (2.5 * x**4 - 3 * x**5 + x**6), t - T / 2)
        du = torch.where(t < T, 10 * x**3 - 15 * x**4 + 6 * x**5, 1.0)
        ddu = torch.where(t < T, (30 * x**2 - 60 * x**3 + 30 * x**4) / T, 0.0)
        return u, du, ddu

    def motion(self, t: torch.Tensor):
        """(position [..., 3], yaw, velocity [..., 3], acceleration [..., 3],
        yaw rate) of the body at stream times t."""
        u, du, ddu = self.clock(t)
        th, dth, _ = self.heading(u)
        v, dv = self.speed(u)
        c, s = torch.cos(th), torch.sin(th)
        z = torch.zeros_like(u)
        xy = self.position(u)
        pos = torch.stack([xy[..., 0], xy[..., 1], z + self.z0], -1)
        tangent = torch.stack([c, s, z], -1)
        normal = torch.stack([-s, c, z], -1)
        vel = (v * du)[..., None] * tangent
        acc = ((dv * du**2 + v * ddu)[..., None] * tangent
               + (v * dth * du**2)[..., None] * normal)
        return pos, th, vel, acc, dth * du

    def sides(self) -> tuple[float, float, float, float]:
        """(y of side a, x of side b, y of the second a side, x of the second
        b side): the lines of the loop's four straights."""
        qa, qb = float(self.r["side_a_s"]), float(self.r["side_b_s"])
        mids = torch.tensor([0.0, qa / 2 + qb / 2, qa + qb, 1.5 * qa + 1.5 * qb], dtype=F64,
                            device=self.dev)
        p = self.position(mids).cpu().numpy()
        return float(p[0, 1]), float(p[1, 0]), float(p[2, 1]), float(p[3, 0])

    def lateral_accel_max(self) -> float:
        """The largest lateral acceleration of the loop, v dheading/dt."""
        u = torch.arange(0.0, self.period, 0.01, dtype=F64, device=self.dev)
        return float((self.speed(u)[0] * self.heading(u)[1]).abs().max())


def scene(route: Route, mix_scene: dict, reach_m: float) -> dict:
    """The street grid around the loop's block as primitives (float64 numpy):
    `boxes` [B, 6] (x0, y0, z0, x1, y1, z1) of buildings and parked cars and
    `cylinders` [C, 4] (x, y, radius, height) of poles and trunks, drawn
    from `mix_scene["seed"]`; the streets' centre lines run along the loop's
    straights and every `pitch` beyond them, out past `reach_m`."""
    rng = np.random.default_rng(mix_scene["seed"])
    y_a, x_b, y_c, x_d = route.sides()
    px, py = x_b - x_d, y_c - y_a
    nx = int(math.ceil(reach_m / px)) + 1
    ny = int(math.ceil(reach_m / py)) + 1
    xs = x_d + px * np.arange(-nx, nx + 2)
    ys = y_a + py * np.arange(-ny, ny + 2)
    setback = float(mix_scene["setback_m"])  # street centre line to the building fronts
    kerb = float(mix_scene["kerb_m"])  # street centre line to the parked cars' centres
    walk = float(mix_scene["pavement_m"])  # street centre line to the poles
    boxes, cyls = [], []
    lo_h, hi_h = mix_scene["building_height_m"]
    lo_w, hi_w = mix_scene["building_front_m"]
    lo_d, hi_d = mix_scene["building_depth_m"]
    pier_w, pier_d, pier_gap = mix_scene["pier_width_m"], mix_scene["pier_depth_m"], mix_scene["pier_gap_m"]
    for i in range(len(xs) - 1):
        for j in range(len(ys) - 1):
            x0, x1 = xs[i] + setback, xs[i + 1] - setback
            y0, y1 = ys[j] + setback, ys[j + 1] - setback
            # buildings along each side of the block, each front set back
            # from the street by its own amount, with piers (pilasters, bays)
            # standing out of it
            for side in range(4):
                along0, along1 = (x0, x1) if side in (0, 2) else (y0, y1)
                a = along0
                while a < along1 - 4.0:
                    w = min(rng.uniform(lo_w, hi_w), along1 - a)
                    d = rng.uniform(lo_d, hi_d)
                    h = rng.uniform(lo_h, hi_h)
                    back = rng.uniform(0.0, mix_scene["setback_jitter_m"])
                    parts = [(a, a + w, back, back + d, h)]
                    p = a + rng.uniform(0.0, pier_gap[1])
                    while p < a + w - pier_w[1]:
                        pw, pd = rng.uniform(*pier_w), rng.uniform(*pier_d)
                        parts.append((p, p + pw, back - pd, back, h))
                        p += pw + rng.uniform(*pier_gap)
                    for l0, l1, n0, n1, hh in parts:  # along, inward from the front line
                        if side == 0:
                            boxes.append((l0, y0 + n0, 0.0, l1, y0 + n1, hh))
                        elif side == 2:
                            boxes.append((l0, y1 - n1, 0.0, l1, y1 - n0, hh))
                        elif side == 1:
                            boxes.append((x1 - n1, l0, 0.0, x1 - n0, l1, hh))
                        else:
                            boxes.append((x0 + n0, l0, 0.0, x0 + n1, l1, hh))
                    a += w + (rng.uniform(2.0, 6.0) if rng.uniform() < mix_scene["alley_p"] else 0.0)
    cars = mix_scene["car_m"]  # length, width, height
    slot, clear = float(mix_scene["car_slot_m"]), float(mix_scene["junction_clear_m"])
    pole_gap = mix_scene["pole_gap_m"]
    for horizontal, lines, cross in ((True, ys, xs), (False, xs, ys)):
        for c in lines:
            for k in range(len(cross) - 1):
                a0, a1 = cross[k] + clear, cross[k + 1] - clear
                for sgn in (-1.0, 1.0):
                    off = c + sgn * kerb
                    a = a0
                    while a + cars[0] <= a1:
                        if rng.uniform() < mix_scene["car_p"]:
                            l0, l1 = a, a + cars[0]
                            w0, w1 = off - cars[1] / 2, off + cars[1] / 2
                            boxes.append((l0, w0, 0.0, l1, w1, cars[2]) if horizontal
                                         else (w0, l0, 0.0, w1, l1, cars[2]))
                        a += slot
                    a = a0 + rng.uniform(0.0, pole_gap[0])
                    while a <= a1:
                        o = c + sgn * walk
                        r, h = rng.uniform(*mix_scene["pole_radius_m"]), rng.uniform(*mix_scene["pole_height_m"])
                        cyls.append((a, o, r, h) if horizontal else (o, a, r, h))
                        a += rng.uniform(*pole_gap)
    return {"boxes": np.asarray(boxes, np.float64), "cylinders": np.asarray(cyls, np.float64)}


def beam_directions(sensor: dict, device) -> torch.Tensor:
    """[azimuth_steps, beams, 3] unit rays in the LiDAR's frame, in firing
    order: the head turns clockwise seen from above; the elevations spread
    evenly over the upper block's and the lower block's ranges."""
    up, low = sensor["upper_block_deg"], sensor["lower_block_deg"]
    nb = sensor["beams"] // 2
    el = torch.cat([torch.linspace(up[0], up[1], nb, dtype=F64),
                    torch.linspace(low[0], low[1], sensor["beams"] - nb, dtype=F64)]) * math.pi / 180
    n_az = sensor["azimuth_steps"]
    az = -2 * math.pi * torch.arange(n_az, dtype=F64) / n_az
    ce = torch.cos(el)
    d = torch.stack([ce[None, :] * torch.cos(az)[:, None], ce[None, :] * torch.sin(az)[:, None],
                     torch.sin(el)[None, :].expand(n_az, -1)], -1)
    return d.to(device)


def cast(o: torch.Tensor, d: torch.Tensor, boxes: torch.Tensor, cyls: torch.Tensor) -> torch.Tensor:
    """[R] distance along unit rays d [R, 3] from origins o [R, 3] to the
    nearest hit on the ground plane z = 0, a box [B, 6] or a vertical
    cylinder [C, 4] standing on the ground (inf: none ahead)."""
    inf = torch.tensor(float("inf"), dtype=o.dtype, device=o.device)
    t = torch.where(d[:, 2] < 0, -o[:, 2] / d[:, 2], inf)
    if len(boxes):
        dd = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        inv = 1.0 / dd
        t1 = (boxes[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
        t2 = (boxes[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        hit = (far >= near) & (near > 0)
        t = torch.minimum(t, torch.where(hit, near, inf).amin(-1))
    if len(cyls):
        ox = o[:, None, 0] - cyls[None, :, 0]
        oy = o[:, None, 1] - cyls[None, :, 1]
        a = (d[:, 0] ** 2 + d[:, 1] ** 2)[:, None]
        b = 2 * (d[:, None, 0] * ox + d[:, None, 1] * oy)
        c = ox**2 + oy**2 - cyls[None, :, 2] ** 2
        disc = b * b - 4 * a * c
        tc = (-b - torch.sqrt(disc.clamp(min=0.0))) / (2 * a.clamp(min=1e-12))
        z = o[:, None, 2] + tc * d[:, None, 2]
        hit = (disc >= 0) & (tc > 0) & (z >= 0) & (z <= cyls[None, :, 3])
        t = torch.minimum(t, torch.where(hit, tc, inf).amin(-1))
    return t


def _near(prims: torch.Tensor, xy: torch.Tensor, reach: float, cyl: bool) -> torch.Tensor:
    """The primitives whose footprint comes within `reach` of xy [2]."""
    if not len(prims):
        return prims
    if cyl:
        dist = torch.linalg.norm(prims[:, :2] - xy, dim=-1) - prims[:, 2]
    else:
        dx = torch.clamp(torch.maximum(prims[:, 0] - xy[0], xy[0] - prims[:, 3]), min=0.0)
        dy = torch.clamp(torch.maximum(prims[:, 1] - xy[1], xy[1] - prims[:, 4]), min=0.0)
        dist = torch.sqrt(dx * dx + dy * dy)
    return prims[dist <= reach]


def cast_sweeps(route: Route, world: dict, sensor: dict, sweeps, gen: torch.Generator, device, *,
                lidar_quat_xyzw, lidar_translation) -> dict:
    """{sweep: (points [n, 3] float32 in the LiDAR's frame, their firing
    times [n] in s since the start)} of the given sweeps (sweep i ends at
    (i + 1) / rate), each ray cast from the LiDAR's pose at its firing time
    against the primitives of `world` within reach, its range noise drawn
    from `gen`."""
    dev = torch.device(device)
    R_il = _quat_to_mat(lidar_quat_xyzw, dev)
    t_il = torch.tensor(lidar_translation, dtype=F64, device=dev)
    lo, hi = float(sensor["min_range_m"]), float(sensor["max_range_m"])
    boxes = torch.as_tensor(world["boxes"], device=dev)
    cyls = torch.as_tensor(world["cylinders"], device=dev)
    rays_l = beam_directions(sensor, dev)  # [A, L, 3]
    n_az, n_beams = rays_l.shape[:2]
    sweep = 1.0 / sensor["scan_rate_hz"]
    frac = (torch.arange(n_az, dtype=F64, device=dev) + 0.5) / n_az  # firing times in the sweep
    out = {}
    for s in sweeps:
        t_fire = (s + frac) * sweep  # [A]
        pos, yaw_t = route.motion(t_fire)[:2]
        R_wb = _rot_z(yaw_t)  # [A, 3, 3]
        origin = pos + R_wb @ t_il  # [A, 3]
        # the primitives within reach of this sweep, relative to its middle
        # in the plane (float32 ranges of a few hundred metres)
        mid = origin[n_az // 2]
        shift = torch.stack([mid[0], mid[1], torch.zeros_like(mid[2])])
        near_b = _near(boxes, mid[:2], hi + 2.0, cyl=False) - torch.cat([shift, shift])
        near_c = _near(cyls, mid[:2], hi + 2.0, cyl=True)
        near_c = torch.cat([near_c[:, :2] - mid[:2], near_c[:, 2:]], -1)
        d_w = torch.einsum("aij,alj->ali", R_wb @ R_il, rays_l).reshape(-1, 3)
        o = (origin - shift)[:, None, :].expand(-1, n_beams, -1).reshape(-1, 3)
        rng_m = cast(o.float(), d_w.float(), near_b.float(), near_c.float()).double()
        keep = (rng_m >= lo) & (rng_m <= hi)
        noisy = rng_m + sensor["range_noise_m"] * torch.randn(rng_m.shape, generator=gen, device=dev,
                                                              dtype=F64)
        pts = (noisy[:, None] * rays_l.reshape(-1, 3))[keep]
        t_pts = t_fire[:, None].expand(-1, n_beams).reshape(-1)[keep]
        out[s] = (pts.to(torch.float32).cpu().numpy(), t_pts.cpu().numpy())
    return out


def generate(sensor: dict, mix: dict, seed: int, device, *, lidar_quat_xyzw, lidar_translation) -> Stream:
    """The stream made from `seed`: `mix["ramp_s"]` seconds from rest, then
    one period of the loop, with the sensor of `sensor` mounted at the
    LiDAR-to-IMU extrinsics given."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    route = Route(mix["route"], mix["ramp_s"], dev)
    rate, imu_rate = sensor["scan_rate_hz"], sensor["imu_rate_hz"]
    ramp_sweeps = round(mix["ramp_s"] * rate)
    period_sweeps = round(route.period * rate)
    n_sweeps = ramp_sweeps + period_sweeps
    duration = n_sweeps / rate
    period_imu = round(route.period * imu_rate)

    # IMU over the ramp and the period, half a sample off the sweep ends
    n_imu = round(duration * imu_rate)
    t_imu = (torch.arange(n_imu, dtype=F64, device=dev) + 0.5) / imu_rate
    _, yaw, _, acc_w, dyaw = route.motion(t_imu)
    R = _rot_z(yaw)
    g_w = torch.tensor(GRAVITY_W, dtype=F64, device=dev)
    accel = torch.einsum("nji,nj->ni", R, acc_w - g_w)
    gyro = torch.stack([torch.zeros_like(dyaw), torch.zeros_like(dyaw), dyaw], -1)
    gyro = gyro + torch.tensor(sensor["gyro_bias"], dtype=F64, device=dev) + sensor[
        "imu_noise_gyro"] * torch.randn(n_imu, 3, generator=gen, device=dev, dtype=F64)
    accel = accel + torch.tensor(sensor["accel_bias"], dtype=F64, device=dev) + sensor[
        "imu_noise_accel"] * torch.randn(n_imu, 3, generator=gen, device=dev, dtype=F64)

    world = scene(route, mix["scene"], reach_m=float(sensor["max_range_m"]) + 50.0)
    swept = cast_sweeps(route, world, sensor, range(n_sweeps), gen, dev,
                        lidar_quat_xyzw=lidar_quat_xyzw, lidar_translation=lidar_translation)
    ends = torch.arange(1, n_sweeps + 1, dtype=F64, device=dev) / rate
    return Stream(
        imu_t=t_imu.cpu().numpy() + START_TIME,
        imu_gyro=gyro.cpu().numpy(), imu_accel=accel.cpu().numpy(),
        sweep_end=ends.cpu().numpy() + START_TIME,
        sweep_points=[swept[i][0] for i in range(n_sweeps)],
        sweep_t=[swept[i][1] + START_TIME for i in range(n_sweeps)],
        gt_positions=route.motion(ends)[0].cpu().numpy(),
        ramp_sweeps=ramp_sweeps, period_sweeps=period_sweeps,
        ramp_imu=n_imu - period_imu, period_s=float(route.period),
    )
