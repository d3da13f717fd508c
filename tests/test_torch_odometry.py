"""The port's streaming `Odometry` driver (`eskf_lio_torch/pipeline/
odometry.py`) vs the JAX package's, fed the same records in the same order.

* What the host hands the step — IMU chunk, packed scan, evict flag — is a
  pure function of the record stream, so its digest is equal BIT FOR BIT in
  both drivers (the digest of `tests/test_stream.py`).
* Trajectories agree within 1e-2 m, the bound `tests/test_torch_replay.py`
  states for the same f32 recursion computed two ways (seed differences of
  ~1e-7 grow through GN and the filter); convergence flags are equal.
* The overflow pre-advance (`max_imu_per_scan` below the ~40 samples a scan
  interval holds) and the stale-IMU prune (a pre-init sample fed after
  init) leave the same filter clock and the same pending list in both.
* The divergence latch fires as in `tests/test_cli_config.py`.
"""

import hashlib

import numpy as np
import pytest
import torch

from eskf_lio_torch.config import Config as TConfig, ImuConfig as TImu
from eskf_lio_torch.io import dataset as t_dataset
from eskf_lio_torch.pipeline.odometry import Odometry as TOdometry, StageTimer
from eskf_lio_torch.utils.metrics import ate_rmse
from eskf_lio_tpu.config import Config as JConfig, ImuConfig as JImu
from eskf_lio_tpu.pipeline.odometry import Odometry as JOdometry

torch.set_num_threads(2)

GRAVITY = (0.0, 0.0, -9.81)
# tests/test_stream.py's CFG
STREAM_KW = dict(
    max_raw_points=8192, max_scan_points=4096, max_imu_per_scan=48, hash_capacity_log2=16,
)
# tests/test_cli_config.py's divergence config, here also with a chunk that
# a 0.1 s scan interval at 400 Hz overflows twice
SMALL_KW = dict(
    translation_noise=1e-4, rotation_noise=3e-5, max_raw_points=2048,
    max_scan_points=1024, hash_capacity_log2=14,
)


def configs(kw):
    return TConfig(imu=TImu(gravity=GRAVITY), **kw), JConfig(imu=JImu(gravity=GRAVITY), **kw)


def chunk_digest(chunk, *more) -> str:
    """sha1 of an IMU chunk's consumed prefix (rows `valid & t_rel <= 0`:
    whether the first sample beyond scan end is already in the chunk depends
    on arrival timing, and nothing reads it) and of any further arrays."""
    h = hashlib.sha1()
    m = np.asarray(chunk.valid) & (np.asarray(chunk.t_rel) <= 0.0)
    for arr in (chunk.dt, chunk.t_rel, chunk.gyro, chunk.accel):
        a = np.ascontiguousarray(np.asarray(arr))
        mm = m.reshape(m.shape + (1,) * (a.ndim - m.ndim))
        h.update(np.ascontiguousarray(np.where(mm, a, 0)).tobytes())  # padding holds inf
    h.update(m.tobytes())
    for arr in more:
        h.update(np.ascontiguousarray(np.asarray(arr)).tobytes())
    return h.hexdigest()


def record_step_inputs(odo, log: list) -> None:
    """Wrap `odo.scan_step` (either package's) to log a digest of its
    stream-derived inputs, not of the carried state."""
    inner = odo.scan_step

    def wrapped(state, voxmap, prev_R, prev_t, chunk, scan, do_evict):
        log.append(chunk_digest(chunk, *scan, do_evict))
        return inner(state, voxmap, prev_R, prev_t, chunk, scan, do_evict)

    odo.scan_step = wrapped


def record_pre_advances(odo, log: list) -> None:
    """Wrap `odo.predict_only` to log each overflow window: the filter clock
    it starts from and the whole chunk (every row of a full window counts)."""
    inner = odo.predict_only

    def wrapped(state, chunk):
        h = hashlib.sha1()
        for arr in chunk:
            h.update(np.ascontiguousarray(np.asarray(arr)).tobytes())
        log.append((odo.t_last_update, h.hexdigest()))
        return inner(state, chunk)

    odo.predict_only = wrapped


@pytest.fixture(scope="module")
def seq2s():
    return t_dataset.make_synthetic_sequence(duration=2.0, points_per_scan=8000, seed=7)


def test_run_matches_jax(seq2s):
    tcfg, jcfg = configs(STREAM_KW)
    t_odo, j_odo = TOdometry(tcfg, device="cpu"), JOdometry(jcfg)
    t_in, j_in = [], []
    record_step_inputs(t_odo, t_in)
    record_step_inputs(j_odo, j_in)
    t_sum, j_sum = t_odo.run(seq2s), j_odo.run(seq2s)

    assert t_sum["num_scans"] == j_sum["num_scans"] == len(seq2s.scans)
    assert t_in == j_in and len(t_in) == len(seq2s.scans) - 1
    assert t_odo.trajectory_t == j_odo.trajectory_t
    np.testing.assert_allclose(t_odo.positions, j_odo.positions, atol=1e-2)
    assert [bool(d["icp_converged"]) for d in t_odo.diags] == [
        bool(d["icp_converged"]) for d in j_odo.diags
    ]
    assert set(t_odo.diags[0]) == set(j_odo.diags[0])
    # poses that differ by f32 rounding move a few border points across voxels
    assert not t_sum["diverged"]
    assert abs(t_sum["map_voxels"] - j_sum["map_voxels"]) <= 0.01 * j_sum["map_voxels"]
    assert set(t_sum) == set(j_sum)
    assert ate_rmse(t_odo.positions, seq2s.gt_positions[: len(t_odo.positions)], align=True) < 0.1


def test_driver_counts_its_transfers(seq2s):
    tcfg, _ = configs(STREAM_KW)
    odo = TOdometry(tcfg, device="cpu")
    odo.run(seq2s, max_scans=3)
    # one read per update scan; 3 scans and 2 chunks uploaded
    assert odo.device_reads == 2
    scan_bytes = tcfg.max_raw_points * (12 + 4 + 1)
    chunk_bytes = tcfg.max_imu_per_scan * (4 + 4 + 12 + 12 + 1)
    assert odo.h2d_bytes == 3 * scan_bytes + 2 * chunk_bytes
    assert odo.trajectory_p[1].dtype == np.float32 and odo.trajectory_R[1].shape == (3, 3)
    assert odo.diags[0]["icp_converged"].dtype == bool
    assert int(odo.diags[0]["dropped_raw_points"]) == 0


def test_overflow_pre_advance_and_stale_prune_match_jax():
    tcfg, jcfg = configs(dict(SMALL_KW, max_imu_per_scan=16))
    seq = t_dataset.make_synthetic_sequence(duration=0.6, points_per_scan=1500, seed=2)
    t_odo, j_odo = TOdometry(tcfg, device="cpu"), JOdometry(jcfg)
    logs = {}
    for name, odo in (("t", t_odo), ("j", j_odo)):
        logs[name] = ([], [])
        record_step_inputs(odo, logs[name][0])
        record_pre_advances(odo, logs[name][1])

    t_init = seq.scans[0].end_time
    stale = [r for r in seq.imu if r.t < t_init][-1]
    for odo in (t_odo, j_odo):
        imu = iter(seq.imu)
        nxt = next(imu)
        for k, scan in enumerate(seq.scans):
            if k == 1:
                # a pre-init sample that arrives after init, ahead of the rest
                odo.imu_pending.insert(0, stale)
            while nxt is not None and nxt.t <= scan.end_time + 0.05:
                odo.feed_imu(nxt)
                nxt = next(imu, None)
            assert odo.process_scan(scan) is not None
            if k >= 1:
                assert all(r.t > odo.t_last_update for r in odo.imu_pending)

    assert t_odo.t_last_update == j_odo.t_last_update == seq.scans[-1].end_time
    assert [r.t for r in t_odo.imu_pending] == [r.t for r in j_odo.imu_pending]
    # ~40 samples a scan against 16 a chunk: two pre-advances on every update scan
    n_upd = len(seq.scans) - 1
    assert len(logs["t"][1]) == len(logs["j"][1]) >= 2 * n_upd
    assert logs["t"][1] == logs["j"][1]  # same clocks, same windows, bit for bit
    assert logs["t"][0] == logs["j"][0]  # the stale sample reached neither step
    # (trajectories are compared in test_run_matches_jax, on a scan with
    # enough points to pin the pose; here the first step alone, to 1e-3 m)
    np.testing.assert_allclose(t_odo.positions[:2], j_odo.positions[:2], atol=1e-3)
    assert np.isfinite(t_odo.positions).all() and not t_odo.diverged


def test_gate_waits_for_imu_coverage():
    tcfg, _ = configs(SMALL_KW)
    seq = t_dataset.make_synthetic_sequence(duration=0.4, points_per_scan=1500, seed=2)
    odo = TOdometry(tcfg, device="cpu")
    assert odo.process_scan(seq.scans[0]) == {"initialized": True}
    assert odo.process_scan(seq.scans[1]) is None  # no IMU yet
    for r in seq.imu:
        if r.t < seq.scans[1].end_time:
            odo.feed_imu(r)
    assert odo.process_scan(seq.scans[1]) is None  # none at/after scan end
    assert odo.summary()["num_scans"] == 1 and odo.summary()["scans_per_sec"] == 0.0


def test_divergence_flag():
    """Sustained loss of correspondences raises the diverged flag."""
    tcfg, _ = configs(dict(SMALL_KW, max_imu_per_scan=48))
    seq = t_dataset.make_synthetic_sequence(duration=2.2, points_per_scan=1500, seed=2)
    odo = TOdometry(tcfg, device="cpu")
    odo.zero_corr_limit = 3
    # teleport every scan far away: no correspondences ever
    for i, s in enumerate(seq.scans):
        s.points[:] = s.points + 1000.0 * (i + 1)
    odo.run(seq)
    assert odo.diverged
    assert odo.summary()["diverged"]


def test_stage_timer():
    t = StageTimer()
    assert t.avg == 0.0
    t.add(0.5)
    t.add(1.5)
    assert (t.avg, t.max, t.count) == (1.0, 1.5, 2)


def test_odometry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TOdometry(configs(SMALL_KW)[0])
