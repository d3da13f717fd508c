"""The handheld cell's pieces on the CPU at a small size: the generator
(`benchmark/traffic/handheld.py`), the configuration it runs
(`benchmark/configs/hilti2022-xt32.json`, `config/hilti.yaml`'s), its
check against the coordinate-map reference (`benchmark/drivers/handheld.py`)
and what the rig forces in the port: a LiDAR mounted upside down (a w = 0
quaternion), an align slice below the scan budget, and a filter held to
the rig's own IMU model.
"""

import dataclasses
import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, stats
from benchmark.drivers import common
from benchmark.drivers import handheld as driver
from benchmark.reference import pack
from benchmark.traffic import handheld

torch.set_num_threads(2)

SEED = 2**31 + 23
CONF = json.loads((harness.HERE / "configs" / "hilti2022-xt32.json").read_text())
MIX = json.loads((harness.HERE / "mixes" / "handheld.json").read_text())
GRAVITY = CONF["config"]["imu"]["gravity"]
IMU_RATE = CONF["sensor"]["imu_rate_hz"]
# 8 of the 32 beams (15, 10, 5, 0 and -1, -6, -11, -16 degrees), 500 firings
SMALL_SENSOR = dict(CONF["sensor"], beams=8, azimuth_steps=500)
SMALL_CAPS = dict(max_raw_points=4096, max_scan_points=4096, max_align_points=2048,
                  hash_capacity_log2=16)
# a quarter of the rays (16 of the 32 beams at 1,000 firings)
QUARTER_CAPS = dict(max_raw_points=16384, max_scan_points=8192, max_align_points=6144,
                    hash_capacity_log2=16)


def _walk():
    return handheld.Walk(MIX["walk"], MIX["ramp_s"], GRAVITY, "cpu")


def _vee(S: torch.Tensor) -> torch.Tensor:
    return torch.stack([S[..., 2, 1] - S[..., 1, 2], S[..., 0, 2] - S[..., 2, 0],
                        S[..., 1, 0] - S[..., 0, 1]], -1) / 2


def test_the_walk_is_exactly_periodic_after_its_ramp_and_a_walkers():
    walk = _walk()
    t = torch.linspace(MIX["ramp_s"], MIX["ramp_s"] + walk.period, 4001, dtype=torch.float64)
    for x, y in zip(walk.motion(t), walk.motion(t + walk.period)):
        assert float((y - x).abs().max()) < 1e-9
    # at rest at the start, C2 through the ramp's end
    zero = walk.motion(torch.zeros(1, dtype=torch.float64))
    assert float(zero[2].norm()) == 0.0 and float(zero[3].norm()) == 0.0 and float(zero[4].norm()) == 0.0
    eps = torch.tensor([MIX["ramp_s"] - 1e-6, MIX["ramp_s"] + 1e-6], dtype=torch.float64)
    _, R, vel, acc, w = walk.motion(eps)
    assert float((acc[1] - acc[0]).norm()) < 1e-3 and float((w[1] - w[0]).norm()) < 1e-3
    # a 140-170 m loop in 110-130 s, held 1.2-1.5 m up, 2-4 cm of gait bob,
    # body rates up to at least 1.5 rad/s on all three axes
    u = torch.arange(0.0, walk.period, 0.01, dtype=torch.float64)
    length = float(torch.linalg.norm(torch.diff(walk.route.position(u), dim=0), dim=-1).sum())
    assert 140.0 <= length <= 170.0 and 110.0 <= walk.period <= 130.0
    pos, _, _, _, w = walk.motion(t)
    assert 1.2 <= float(pos[:, 2].min()) and float(pos[:, 2].max()) <= 1.5
    assert 0.02 <= float(pos[:, 2].max() - pos[:, 2].min()) <= 0.04
    assert float(w.norm(dim=-1).max()) >= 1.5
    assert all(float(w[:, i].abs().max()) > 0.2 for i in range(3))


def test_the_imu_is_the_walks_rates_and_specific_force_at_400_hz():
    """Gyro and accelerometer (less their biases) against central
    differences of the attitude and the position at the IMU's rate, through
    the ramp and a stretch of the lap that turns a corner."""
    walk = _walk()
    h = 1.0 / IMU_RATE
    sensor = CONF["sensor"]
    for t0 in (0.5, MIX["ramp_s"] + 15.0):
        t = t0 + (torch.arange(4000, dtype=torch.float64) + 0.5) * h
        gyro, accel = handheld.imu(walk, sensor, t, None)
        gyro = gyro - torch.tensor(sensor["gyro_bias"], dtype=torch.float64)
        accel = accel - torch.tensor(sensor["accel_bias"], dtype=torch.float64)
        p_m, R_m = walk.motion(t - h)[:2]
        p_0, R_0 = walk.motion(t)[:2]
        p_p, R_p = walk.motion(t + h)[:2]
        w_fd = _vee(R_0.transpose(-1, -2) @ (R_p - R_m) / (2 * h))
        a_fd = (p_p - 2 * p_0 + p_m) / h**2
        f_fd = torch.einsum("nji,nj->ni", R_0, a_fd - walk.gravity_w())
        assert float((gyro - w_fd).abs().max()) < 1e-3
        assert float((accel - f_fd).abs().max()) < 2e-3
        if t0 > MIX["ramp_s"]:
            # roll and pitch move: rates on the body's x and y, not only yaw
            assert float(gyro[:, 0].abs().max()) > 0.2 and float(gyro[:, 1].abs().max()) > 0.2


def test_at_rest_the_imu_reads_the_configurations_gravity_and_biases():
    imu = CONF["config"]["imu"]
    walk = _walk()
    gyro, accel = handheld.imu(walk, CONF["sensor"], torch.zeros(1, dtype=torch.float64), None)
    want = np.asarray(imu["bias_accel"]) - np.asarray(imu["gravity"])
    np.testing.assert_allclose(accel[0].numpy(), want, atol=1e-12)
    np.testing.assert_allclose(gyro[0].numpy(), imu["bias_gyro"], atol=1e-15)
    # the sensor's biases are the configuration's, its noises its densities'
    assert CONF["sensor"]["accel_bias"] == imu["bias_accel"]
    assert CONF["sensor"]["gyro_bias"] == imu["bias_gyro"]
    from eskf_lio_torch.config import ImuConfig

    # a sample's standard deviation, as the filter converts the densities
    sig = ImuConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in imu.items()}).noise_sigmas()
    np.testing.assert_allclose(CONF["sensor"]["imu_noise_accel"], sig["accel_noise"], rtol=1e-12)
    np.testing.assert_allclose(CONF["sensor"]["imu_noise_gyro"], sig["gyro_noise"][0], rtol=1e-12)


def test_the_configuration_is_hilti_yaml_but_for_what_it_lists():
    from eskf_lio_torch.config import load_config

    want = dataclasses.asdict(load_config(str(harness.ROOT / "config" / "hilti.yaml")))
    got = dataclasses.asdict(common.program_config(CONF["config"]))
    differ = {k for k in got if got[k] != want[k]}
    assert differ <= set(CONF["not_in_hilti_yaml"]) | {"translation_noise", "rotation_noise"}
    assert ("update_noise" in CONF["reduced"]) == bool(differ & {"translation_noise", "rotation_noise"})
    assert set(CONF["reduced"]) <= {"route", "update_noise"}


def test_lidar_extrinsics_of_the_w_0_quaternion_is_the_exact_half_turn():
    """hilti.yaml's LiDAR quaternion (xyzw) [0.7071068, -0.7071068, 0, 0]:
    180 degrees about (1, -1, 0) / sqrt(2), in the port, the benchmark's
    reference and the generator alike."""
    from benchmark.reference import step as ref_step
    from benchmark.traffic.generator import _quat_to_mat
    from eskf_lio_torch.pipeline import odometry as odo

    config = common.program_config(CONF["config"])
    want = np.array([[0.0, -1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
    T = odo.lidar_extrinsics(config, "cpu")
    R = T.R.double().numpy()
    np.testing.assert_allclose(R, want, atol=2e-7)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    assert abs(np.trace(R) + 1.0) < 1e-6 and abs(np.linalg.det(R) - 1.0) < 1e-6
    np.testing.assert_allclose(R @ np.array([1.0, -1.0, 0.0]), [1.0, -1.0, 0.0], atol=1e-6)
    np.testing.assert_array_equal(T.t.numpy(), np.float32(CONF["config"]["lidar_translation"]))
    ref = ref_step.lidar_extrinsics(driver.check_coord.reference_config(CONF["config"]), "cpu")
    assert torch.equal(ref.R, T.R) and torch.equal(ref.t, T.t)
    np.testing.assert_allclose(_quat_to_mat(CONF["config"]["lidar_quat_xyzw"], "cpu").numpy(), want,
                               atol=1e-7)


@pytest.fixture(scope="module")
def stream():
    c = CONF["config"]
    return handheld.generate(SMALL_SENSOR, MIX, SEED, "cpu", lidar_quat_xyzw=c["lidar_quat_xyzw"],
                             lidar_translation=c["lidar_translation"], gravity=GRAVITY, sweeps=130)


def test_the_sweeps_are_in_range_timed_by_azimuth_and_within_capacity(stream):
    lo, hi, noise = (SMALL_SENSOR[k] for k in ("min_range_m", "max_range_m", "range_noise_m"))
    rays = SMALL_SENSOR["beams"] * SMALL_SENSOR["azimuth_steps"]
    assert CONF["sensor"]["beams"] * CONF["sensor"]["azimuth_steps"] <= CONF["config"]["max_raw_points"]
    assert len(stream.sweep_points) == 130 and stream.period_sweeps == round(10 * _walk().period)
    for i in range(0, 130, 9):
        pts, t = stream.sweep_points[i], stream.sweep_t[i]
        r = np.linalg.norm(pts, axis=1)
        assert 0.8 * rays < len(pts) <= rays
        assert r.min() > lo - 6 * noise and r.max() < hi + 6 * noise
        assert np.all(np.diff(t) >= 0) and stream.sweep_end[i] - 0.1 < t[0] and t[-1] < stream.sweep_end[i]
    # 40 samples a sweep at 400 Hz, the chunk 41 with the one past its end
    i0, i1 = stream.imu_after(stream.sweep_end[10]), stream.imu_after(stream.sweep_end[11])
    assert i1 - i0 == 40


def test_the_align_slice_overflows_by_the_excess_as_in_the_jax_package(stream):
    """A scan with more live voxels than `align_capacity`: the step counts
    the excess in `align_slice_overflow`, the port as the JAX package."""
    import jax.numpy as jnp

    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.models import eskf
    from eskf_lio_torch.pipeline import odometry as odo
    from eskf_lio_torch.types import ImuChunk, Scan
    from eskf_lio_tpu import config as jc
    from eskf_lio_tpu.map import voxel_map as j_vm
    from eskf_lio_tpu.models import eskf as j_eskf
    from eskf_lio_tpu.pipeline import odometry as j_odo
    from eskf_lio_tpu.types import ImuChunk as JChunk, Scan as JScan

    fields = dict(CONF["config"], **dict(SMALL_CAPS, max_align_points=1024))
    config = common.program_config(fields)
    ref_config = driver.check_coord.reference_config(fields)
    cpu = torch.device("cpu")
    init = pack.init_scan(stream, ref_config, cpu)
    rows = [pack.row(stream, k, ref_config, cpu, shifted=False) for k in (1, 2)]
    voxmap = vm.VoxelMap.create(config.hash_capacity, device=cpu, key_bits=tuple(config.map_key_bits))
    voxmap, _ = odo.make_init_step(config, cpu)(voxmap, Scan(*init))
    carry = (eskf.init_state(config, cpu), voxmap, torch.eye(3), torch.zeros(3))
    core = odo.make_step_core(config, cpu)
    names = {f.name for f in dataclasses.fields(jc.Config)}
    jf = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items() if k in names and k != "imu"}
    jcfg = jc.Config(imu=jc.ImuConfig(**{k: tuple(v) if isinstance(v, list) else v
                                         for k, v in fields["imu"].items()}), **jf)

    def jn(x):
        return jnp.asarray(x.numpy())

    jmap = j_vm.VoxelMap.create(jcfg.hash_capacity, jcfg.map_delta_capacity)
    jmap, _ = j_odo.make_init_step(jcfg)(jmap, JScan(*(jn(x) for x in init)))
    jstate, jR, jt = j_eskf.init_state(jcfg), jnp.eye(3), jnp.zeros(3)
    jstep = j_odo.make_scan_step(jcfg)
    for chunk, scan in rows:
        carry, diag = core(carry, (ImuChunk(*chunk), Scan(*scan), False))
        jstate, jmap, jR, jt, jdiag = jstep(jstate, jmap, jR, jt, JChunk(*(jn(x) for x in chunk)),
                                            JScan(*(jn(x) for x in scan)), jnp.asarray(False))
        n = int(diag["num_scan_points"])
        assert n > config.align_capacity
        assert int(diag["align_slice_overflow"]) == n - config.align_capacity
        assert int(jdiag["num_scan_points"]) == n
        assert int(jdiag["align_slice_overflow"]) == n - config.align_capacity


def _small_cell(**config) -> harness.Cell:
    """The cell at a size the CPU runs in seconds: a quarter of the walk
    (its sides and its oscillations' cycles a lap cut to a quarter, the hand's
    frequencies kept), a 4 s ramp, 8 of the 32 beams at 500 firings, small
    capacities, an eviction every second."""
    mix = json.loads(json.dumps(MIX))
    mix["ramp_s"] = 4.0
    walk = mix["walk"]
    walk["route"].update(side_a_s=walk["route"]["side_a_s"] / 4, side_b_s=walk["route"]["side_b_s"] / 4,
                         brake_s=3.0)
    for name in handheld.OSCILLATIONS:
        walk[name]["cycles"] = round(walk[name]["cycles"] / 4)
    conf = json.loads(json.dumps(CONF))
    conf["config"].update(QUARTER_CAPS, remove_period=0.3, **config)
    conf["sensor"].update(beams=16, azimuth_steps=1000)
    limits = json.loads((harness.HERE / "limits" / "hilti2022-xt32.replay.json").read_text())
    return harness.Cell(workload={"name": "hilti2022-xt32.replay", "chips": 1}, config=conf, mix=mix,
                        limits=limits, end_to_end=[], per_layer=[], chips=1)


def _fault(kind):
    def wrap(step):
        def broken(state, voxmap, prev_R, prev_t, chunks, scans, evicts, updates):
            if kind == "no_deskew":  # every point taken at the sweep's end
                scans = scans._replace(t_rel=torch.zeros_like(scans.t_rel))
            if kind == "no_evict":
                evicts = torch.zeros_like(evicts)
            return step(state, voxmap, prev_R, prev_t, chunks, scans, evicts, updates)
        return broken
    return wrap


@pytest.mark.parametrize("fault", [None, "no_deskew", "no_evict"])
def test_the_small_cell_is_correct_only_unbroken(fault):
    """The driver on the CPU: correct against the coordinate-map reference,
    every sampled block checked (the turning block among them); with the
    deskew left out or the evictions dropped, not correct."""
    cell = _small_cell(remove_distance_threshold=30.0)
    rec = driver.run(cell, SEED, 6.0, False, device="cpu", fault=None if fault is None else _fault(fault))
    info = rec["info"]
    assert rec["failed"] == 0 and info["span_dropped_points"] == 0
    if fault != "no_deskew":
        assert {"any", "evict", "pre_evict"} <= set(info["block_kinds"])
    assert rec["correct"] == (fault is None), rec["checks"]
    if fault is None:
        assert info["align_overflow_rows"] > 0
        assert info["imu_per_row_max"] == 41 and info["raw_points_max"] <= 16000
        assert any(n > 0 for n in info["reference_removed"])
    elif fault == "no_deskew":
        assert rec["checks"]["pose_gap_m"]["value"] > rec["checks"]["pose_gap_m"]["limit"]
    else:
        assert rec["checks"]["map_count_gap"]["value"] > rec["checks"]["map_count_gap"]["limit"]


def test_the_turning_block_holds_the_laps_fastest_rows(stream):
    """`turning_sweep` picks the three rows whose sweeps hold the lap's
    largest body rate: at least 1.5 rad/s, none larger elsewhere."""
    cell = harness.Cell(workload={}, config=CONF, mix=MIX, limits={}, end_to_end=[], per_layer=[], chips=1)
    k = driver.turning_sweep(cell, stream, 3)
    walk = _walk()
    assert stream.ramp_sweeps <= k < stream.ramp_sweeps + stream.period_sweeps
    t = torch.arange(stream.ramp_sweeps * 10, (stream.ramp_sweeps + stream.period_sweeps) * 10,
                     dtype=torch.float64) / 100.0
    rates = walk.motion(t)[4].norm(dim=-1)
    block = walk.motion(torch.arange(k * 100, (k + 3) * 100, dtype=torch.float64) / 1000.0)[4].norm(dim=-1)
    assert float(block.max()) >= 1.5 and float(block.max()) >= float(rates.max()) - 1e-2


def _track(noises, rows: int):
    """The port's positions over the first `rows` update rows of the cell's
    stream at a quarter of its rays (16 of 32 beams x 1,000 firings), from
    rest, at the given update noises: (ATE cm, over the first half, over
    the second half)."""
    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.models import eskf
    from eskf_lio_torch.pipeline import odometry as odo
    from eskf_lio_torch.types import ImuChunk, Scan

    fields = dict(CONF["config"], **QUARTER_CAPS, translation_noise=noises[0], rotation_noise=noises[1])
    sensor = dict(CONF["sensor"], beams=16, azimuth_steps=1000)
    cpu = torch.device("cpu")
    stream = handheld.generate(sensor, MIX, MIX["stream_seed"], cpu, gravity=GRAVITY, sweeps=rows + 2,
                               lidar_quat_xyzw=fields["lidar_quat_xyzw"],
                               lidar_translation=fields["lidar_translation"])
    config = common.program_config(fields)
    ref_config = driver.check_coord.reference_config(fields)
    evicts = common.evict_flags(stream, rows + 1, config.remove_period, True)
    voxmap = vm.VoxelMap.create(config.hash_capacity, device=cpu, key_bits=tuple(config.map_key_bits))
    voxmap, _ = odo.make_init_step(config, cpu)(voxmap, Scan(*pack.init_scan(stream, ref_config, cpu)))
    carry = (eskf.init_state(config, cpu), voxmap, torch.eye(3), torch.zeros(3))
    core = odo.make_step_core(config, cpu)
    est = []
    with torch.no_grad():
        for k in range(1, rows + 1):
            chunk, scan = pack.row(stream, k, ref_config, cpu, shifted=False)
            carry, _ = core(carry, (ImuChunk(*chunk), Scan(*scan), evicts[k]))
            est.append(carry[3].double().numpy())
    est, gt = np.asarray(est), stream.gt_positions[1: rows + 1]
    if not np.isfinite(est).all():
        return math.inf, math.inf, math.inf
    h = rows // 2
    return tuple(stats.ate_rmse(e, g) * 100 for e, g in ((est, gt), (est[:h], gt[:h]), (est[h:], gt[h:])))


def test_the_filter_tracks_the_walk_at_the_configurations_update_noises():
    """Step 1 of the cell: `config/hilti.yaml`'s update noises of 1e-6 with
    its own IMU model (bias walks of 3.9 m/s^2/sqrt(s) and 0.35 rad/s/sqrt(s)
    at 400 Hz) lose the walk within 15 s, as they do in the plain reference
    and the JAX package; the configuration's 1e-3 / 3e-4 track it over 30 s
    (300 rows: the ramp from rest, then the lap), the error of its second
    half a few cm, below its first half's, which holds the ramp."""
    assert (CONF["config"]["translation_noise"], CONF["config"]["rotation_noise"]) == (1e-3, 3e-4)
    ate, first, second = _track((1e-3, 3e-4), 300)
    assert ate < 15.0 and second < 3.0 and second < first, (ate, first, second)
    assert _track((1e-6, 1e-6), 150)[0] > 100.0


_IMPORTS = ("import sys; sys.path.insert(0, {root!r}); import benchmark.drivers.handheld, "
            "benchmark.traffic.handheld; print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))")


def test_the_new_files_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORTS.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=300, check=True)
    top = set(out.stdout.split())
    assert "benchmark" in top and not top & set(harness.FORBIDDEN)


def test_the_cell_is_declared_with_its_files():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == "hilti2022-xt32")
    assert conf["source"] == CONF["source"] and sorted(conf["reduced"]) == sorted(CONF["reduced"])
    assert len(conf["source"]) <= 200 and len(conf["why"]) <= 200
    cell = harness.load_cell("hilti2022-xt32.replay")
    assert cell.limits and cell.chips == 1 and cell.mix["driver"] == "handheld"
    assert cell.mix["phases"] == 1 and cell.mix["ate_laps"] >= 1
    assert {m["name"] for m in cell.end_to_end} == {"replay_scans_per_s", "ate_cm", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert len(names) == 14 and {n for n in names if not n.endswith(".handheld")} == {
        "segscan_roofline", "gn_normal_eq_roofline"}
    assert all(m["moves"] == "replay_scans_per_s" for m in cell.per_layer)
    # a record without the program's spans and counters reads nothing
    assert all(harness.reader(m["name"])({}) is None for m in cell.per_layer)


def test_the_map_layer_readers_read_the_fold_and_eviction_of_a_traced_record():
    """`fold_ms`, `evict_ms` and `folds_per_scan` of the handheld cell read
    the fold and evict stages and the `map_folds` count a row that the
    driver's traced run puts under `handheld`."""
    run = {"handheld": {"stage_ms": {"fold": 2.5, "evict": 1.25, "map_insert": 0.5},
                        "map_folds": 30, "folds_per_row": 0.3}}
    assert harness.reader("fold_ms.handheld")(run) == 2.5
    assert harness.reader("evict_ms.handheld")(run) == 1.25
    assert harness.reader("folds_per_scan.handheld")(run) == 0.3


def test_the_sweeps_are_the_same_whatever_the_motion_batch(monkeypatch):
    """`cast_sweeps` takes the rig's poses for `MOTION_SWEEPS` sweeps in one
    call: the points and their times are those of one call a sweep, bit for
    bit, across the batches' boundaries."""
    c = CONF["config"]
    walk = _walk()
    world = handheld.site(walk, MIX["scene"])
    sweeps = [3, 4, 5, 150, 151]
    out = {}
    for batch in (1, 2, handheld.MOTION_SWEEPS):
        monkeypatch.setattr(handheld, "MOTION_SWEEPS", batch)
        gen = torch.Generator()
        gen.manual_seed(SEED)
        out[batch] = handheld.cast_sweeps(walk, world, SMALL_SENSOR, sweeps, gen, "cpu",
                                          lidar_quat_xyzw=c["lidar_quat_xyzw"],
                                          lidar_translation=c["lidar_translation"])
    for batch in (2, handheld.MOTION_SWEEPS):
        assert list(out[batch]) == sweeps
        for s in sweeps:
            np.testing.assert_array_equal(out[batch][s][0], out[1][s][0])
            np.testing.assert_array_equal(out[batch][s][1], out[1][s][1])
