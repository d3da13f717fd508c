"""The urban cell's pieces on the CPU at a small size: the generator
(`benchmark/traffic/urban.py`), the check against the coordinate-map
reference (`benchmark/check_coord.py`) and the map's key split it forces.

The forcing: a car that has driven ~100 m since the map's last re-centring
sees 100 m ahead, up to ~200 m from the map's centre.  Rows of the small
stream taken there, from the car's true state and a map made at its true
poses since that re-centring, pass the check with the configuration's
split, (11, 11, 9), and drop points for their span, and so are not
correct, with the split forced to (10, 10, 10), whose span is +-153.6 m.
"""

import dataclasses
import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import check, check_coord, compare, harness
from benchmark.drivers import common
from benchmark.reference import pack
from benchmark.traffic import urban

torch.set_num_threads(2)

SEED = 2**31 + 12345
CONF = json.loads((harness.HERE / "configs" / "hdl64-urban.json").read_text())
MIX = json.loads((harness.HERE / "mixes" / "urban.json").read_text())
SMALL_SENSOR = dict(CONF["sensor"], beams=32, azimuth_steps=96)
SMALL_CAPS = dict(max_raw_points=4096, max_scan_points=4096, max_align_points=4096,
                  hash_capacity_log2=16)
# the forcing's rows, cast again at a resolution at which Gauss-Newton
# converges as at the sensor's own (a few passes a row), and their map at a
# quarter of its load
SHARP_SENSOR = dict(CONF["sensor"], beams=64, azimuth_steps=480)
SHARP_CAPS = dict(max_raw_points=32768, max_scan_points=16384, max_align_points=16384,
                  hash_capacity_log2=18)


@pytest.fixture(scope="module")
def stream():
    c = CONF["config"]
    return urban.generate(SMALL_SENSOR, MIX, SEED, "cpu", lidar_quat_xyzw=c["lidar_quat_xyzw"],
                          lidar_translation=c["lidar_translation"])


def test_the_loop_is_exactly_periodic_after_its_ramp_and_drivable():
    route = urban.Route(MIX["route"], MIX["ramp_s"], "cpu")
    t = torch.linspace(MIX["ramp_s"], MIX["ramp_s"] + route.period, 2001, dtype=torch.float64)
    a, b = route.motion(t), route.motion(t + route.period)
    for x, y in zip(a, b):
        d = y - x if x is not a[1] else y - x - 2 * math.pi
        assert float(d.abs().max()) < 1e-9
    # continuous through the ramp's end (its rate and acceleration too)
    eps = torch.tensor([MIX["ramp_s"] - 1e-6, MIX["ramp_s"] + 1e-6], dtype=torch.float64)
    pos, _, vel, acc, _ = route.motion(eps)
    assert float((acc[1] - acc[0]).norm()) < 1e-3 and float((vel[1] - vel[0]).norm()) < 1e-4
    # at rest at the start; a 400-600 m loop at 8-12 m/s on its straights,
    # lateral acceleration within 3 m/s^2, and the loop closes
    assert float(route.motion(torch.zeros(1, dtype=torch.float64))[2].norm()) == 0.0
    u = torch.arange(0.0, route.period, 0.01, dtype=torch.float64)
    length = float(torch.linalg.norm(torch.diff(route.position(u), dim=0), dim=-1).sum())
    assert 400.0 <= length <= 600.0 and 8.0 <= route.v_s <= 12.0 > route.v_c
    assert route.lateral_accel_max() <= 3.0 and route.closure_m < 1e-6


def test_the_sweeps_are_in_range_timed_by_azimuth_and_within_capacity(stream):
    lo, hi, noise = (SMALL_SENSOR[k] for k in ("min_range_m", "max_range_m", "range_noise_m"))
    rays = SMALL_SENSOR["beams"] * SMALL_SENSOR["azimuth_steps"]
    assert CONF["sensor"]["beams"] * CONF["sensor"]["azimuth_steps"] <= CONF["config"]["max_raw_points"]
    n_gen = stream.ramp_sweeps + stream.period_sweeps
    assert len(stream.sweep_points) == n_gen and stream.period_sweeps == 600
    for i in range(0, n_gen, 7):
        pts, t = stream.sweep_points[i], stream.sweep_t[i]
        r = np.linalg.norm(pts, axis=1)
        assert 0.8 * rays < len(pts) <= rays
        assert r.min() > lo - 6 * noise and r.max() < hi + 6 * noise
        # one firing time an azimuth step, rising through the sweep
        assert np.all(np.diff(t) >= 0) and stream.sweep_end[i] - 0.1 < t[0] and t[-1] < stream.sweep_end[i]
        az = np.unwrap(np.arctan2(pts[:, 1], pts[:, 0]))
        assert np.corrcoef(t, az)[0, 1] < -0.99  # the head turns clockwise


def _truth(stream, route, k):
    """The filter's state at stream sweep k's end from the generator's
    motion: position in the filter's frame (the body at the start), velocity,
    and yaw."""
    pos, yaw, vel, _, _ = route.motion(torch.tensor([stream.sweep_end_of(k) - 1000.0],
                                                    dtype=torch.float64))
    p = pos[0] - torch.tensor([0.0, 0.0, route.z0], dtype=torch.float64)
    return p.float(), vel[0].float(), float(yaw[0])


def _drops(stream, route, rows, center, bits, voxel):
    """Points of `rows` whose voxel, at the true pose, lies outside the span
    of `bits` centred on `center`."""
    from benchmark.traffic.generator import _quat_to_mat

    R_il = _quat_to_mat(CONF["config"]["lidar_quat_xyzw"], "cpu").numpy()
    t_il = np.array(CONF["config"]["lidar_translation"])
    half = np.array([1 << (b - 1) for b in bits])
    origin = np.floor(center / voxel).astype(np.int64) - half
    n = 0
    for k in rows:
        p, _, yaw = _truth(stream, route, k)
        c, s = math.cos(yaw), math.sin(yaw)
        body = stream.sweep_points[stream.sweep_index(k)[0]] @ R_il.T + t_il
        world = np.stack([c * body[:, 0] - s * body[:, 1], s * body[:, 0] + c * body[:, 1],
                          body[:, 2]], 1) + p.numpy()
        rel = np.floor(world / voxel).astype(np.int64) - origin
        n += int(((rel < 0) | (rel >= 2 * half)).any(1).sum())
    return n


@pytest.fixture(scope="module")
def far_block(stream):
    """The three rows before the first eviction whose rows see past the
    +-153.6 m span of its predecessor's re-centring, and that re-centring."""
    route = urban.Route(MIX["route"], MIX["ramp_s"], "cpu")
    c = CONF["config"]
    evicts = common.evict_flags(stream, 1000, c["remove_period"], True)
    ev = [k for k in range(len(evicts)) if evicts[k]]
    for e_prev, e in zip(ev, ev[1:]):
        center = _truth(stream, route, e_prev)[0].numpy()
        rows = [e - 3, e - 2, e - 1]
        if _drops(stream, route, rows, center, (10, 10, 10), c["map_voxel_size"]) > 0:
            assert _drops(stream, route, rows, center, (11, 11, 9), c["map_voxel_size"]) == 0
            return route, e_prev, rows
    pytest.fail("no eviction period of the small stream sees past the default span")


@pytest.fixture(scope="module")
def sharp(stream, far_block):
    """The small stream with the sweeps the forcing reads (every fourth since
    the re-centring, and the three rows) cast at `SHARP_SENSOR`'s resolution."""
    route, e_prev, rows = far_block
    c = CONF["config"]
    world = urban.scene(route, MIX["scene"], SHARP_SENSOR["max_range_m"] + 50.0)
    ks = list(range(e_prev, rows[0], 4)) + rows
    swept = urban.cast_sweeps(route, world, SHARP_SENSOR, ks, torch.Generator().manual_seed(SEED), "cpu",
                              lidar_quat_xyzw=c["lidar_quat_xyzw"],
                              lidar_translation=c["lidar_translation"])
    out = dataclasses.replace(stream, sweep_points=list(stream.sweep_points), sweep_t=list(stream.sweep_t))
    for k, (pts, t) in swept.items():
        out.sweep_points[k], out.sweep_t[k] = pts, t + urban.START_TIME
    return out


@pytest.mark.parametrize("bits", [(11, 11, 9), (10, 10, 10)])
def test_the_check_needs_the_configurations_key_split(sharp, far_block, bits):
    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.models import eskf
    from eskf_lio_torch.ops import lie, preprocess
    from eskf_lio_torch.pipeline import odometry as odo
    from eskf_lio_torch.types import ImuChunk, Scan

    route, e_prev, rows = far_block
    stream = sharp
    fields = dict(CONF["config"], **SHARP_CAPS, map_key_bits=list(bits))
    config = common.program_config(fields)
    ref_config = check_coord.reference_config(fields)
    cpu = torch.device("cpu")
    # the map since the last re-centring, made at the true poses
    voxmap = vm.VoxelMap.create(config.hash_capacity, device=cpu, key_bits=bits)
    voxmap = vm.evict_beyond(voxmap, _truth(stream, route, e_prev)[0], voxel_size=0.3,
                             distance_threshold=100.0, key_bits=bits)[0]
    T_il = odo.lidar_extrinsics(config, cpu)
    for k in range(e_prev, rows[0], 4):
        scan = Scan(*pack.row(stream, k, ref_config, cpu, shifted=False)[1])
        p, _, yaw = _truth(stream, route, k)
        R = lie.quat_to_mat(torch.tensor([math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]))
        pr = preprocess.downsample_and_covariances(T_il.apply(scan.points), scan.valid, config)
        voxmap, _ = vm.insert(voxmap, pr.points @ R.T + p, vm.pack_cov(R @ pr.covs @ R.T), pr.valid,
                              voxel_size=0.3, max_points_per_voxel=1000, key_bits=bits)
    # the filter's state at the block's start, from the truth
    p, v, yaw = _truth(stream, route, rows[0] - 1)
    q = torch.tensor([math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)])
    state = eskf.init_state(config, cpu)._replace(p=p, v=v, q=q)
    carry = (state, voxmap, lie.quat_to_mat(q), p)
    block = check.Block(ks=rows, evicts=[False] * 3, before=check.clone_carry(carry))
    core = odo.make_step_core(config, cpu)
    span = 0
    for k in rows:
        chunk, scan = pack.row(stream, k, ref_config, cpu, shifted=False)
        carry, diag = core(carry, (ImuChunk(*chunk), Scan(*scan), False))
        block.poses.append((carry[2], carry[3]))
        block.iterations.append(int(diag["icp_iterations"]))
        span += int(diag["span_dropped_points"])
    block.after = check.clone_carry(carry)
    gaps = check_coord.readings([block], stream, ref_config, bits, cpu)
    limits = json.loads((harness.HERE / "limits" / "hdl64-urban.replay.json").read_text())
    ok, checks = compare.judge({k: v for k, v in gaps.items() if k in limits}, limits)
    correct = ok and span == 0
    if bits == (11, 11, 9):
        assert correct and span == 0, json.dumps({"span": span, **checks})
    else:
        assert not correct and span > 0
        assert checks["map_count_gap"]["value"] > 0


_IMPORTS = ("import sys; sys.path.insert(0, {root!r}); import {mods}; "
            "print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))")


@pytest.mark.parametrize("mods, banned", [
    ("benchmark.drivers.urban, benchmark.traffic.urban", set(harness.FORBIDDEN)),
    ("benchmark.check_coord, benchmark.reference.coordmap, benchmark.reference.coordstep",
     {"eskf_lio_torch", *harness.FORBIDDEN}),
], ids=["driver", "reference"])
def test_the_new_files_import_no_jax_and_the_reference_nothing_of_the_port(mods, banned):
    out = subprocess.run([sys.executable, "-c", _IMPORTS.format(root=str(harness.ROOT), mods=mods)],
                         capture_output=True, text=True, timeout=300, check=True)
    assert "benchmark" in out.stdout.split() and not set(out.stdout.split()) & banned


def test_the_cells_are_declared_with_their_files():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == "hdl64-urban")
    assert conf["source"] == CONF["source"] and sorted(conf["reduced"]) == sorted(CONF["reduced"])
    cell = harness.load_cell("hdl64-urban.replay")
    assert cell.limits and cell.chips == 1 and cell.mix["driver"] == "urban"
    assert {m["name"] for m in cell.end_to_end} == {"replay_scans_per_s", "ate_cm", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert len(names) == 13 and {n for n in names if not n.endswith(".urban")} == {
        "segscan_roofline", "gn_normal_eq_roofline"}
    # a record without the program's spans and counters reads nothing
    assert all(harness.reader(m["name"])({}) is None for m in cell.per_layer)
