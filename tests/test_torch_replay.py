"""The slice end to end: the port's replay (`eskf_lio_torch/pipeline/`) vs
the JAX package's, and state handed from JAX to the port mid-run.

* On `test_replay.py`'s config and sequence (12 scans) the port's
  trajectory stays within 1e-2 m of JAX `run_replay` — the bound
  `test_replay.py` itself uses for the same f32 recursion compiled two
  ways, whose ~1e-7 seed differences grow chaotically through GN and the
  filter — and the convergence flags are equal.
* On `test_pipeline.py`'s sequence the port tracks ground truth: ATE
  < 0.15 m and convergence > 0.9 (that test's bounds).
* After k scans of JAX, the JAX filter state and map go to the port
  through `utils/convert.py`; the next step from that state agrees with
  JAX's next step to 1e-3 m (one step: only f32 rounding differs) with the
  same GN iteration count.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eskf_lio_torch.config import Config as TConfig, ImuConfig as TImu
from eskf_lio_torch.io import dataset as t_dataset
from eskf_lio_torch.map import voxel_map as t_vm
from eskf_lio_torch.models import eskf as t_eskf
from eskf_lio_torch.pipeline import odometry as t_odo
from eskf_lio_torch.pipeline import replay as t_replay
from eskf_lio_torch.types import ImuChunk as TChunk, Scan as TScan
from eskf_lio_torch.utils import convert
from eskf_lio_torch.utils.metrics import ate_rmse
from eskf_lio_tpu.config import Config as JConfig, ImuConfig as JImu
from eskf_lio_tpu.io import dataset as j_dataset
from eskf_lio_tpu.map import voxel_map as j_vm
from eskf_lio_tpu.models import eskf as j_eskf
from eskf_lio_tpu.pipeline import odometry as j_odo
from eskf_lio_tpu.pipeline import replay as j_replay

torch.set_num_threads(2)

# tests/test_replay.py's CFG
REPLAY_KW = dict(
    translation_noise=1e-4, rotation_noise=3e-5, max_raw_points=8192,
    max_scan_points=4096, max_imu_per_scan=48, hash_capacity_log2=16,
)
# tests/test_pipeline.py's CFG
PIPELINE_KW = dict(
    translation_noise=1e-4, rotation_noise=3e-5, max_raw_points=16384,
    max_scan_points=8192, max_imu_per_scan=48, hash_capacity_log2=17,
)
GRAVITY = (0.0, 0.0, -9.81)


def configs(kw):
    return TConfig(imu=TImu(gravity=GRAVITY), **kw), JConfig(imu=JImu(gravity=GRAVITY), **kw)


@pytest.fixture(scope="module")
def seq12():
    return t_dataset.make_synthetic_sequence(duration=3.0, points_per_scan=8000, seed=7)


def test_sequences_are_the_same_in_both_packages(seq12):
    j = j_dataset.make_synthetic_sequence(duration=3.0, points_per_scan=8000, seed=7)
    np.testing.assert_array_equal(seq12.scans[3].points, j.scans[3].points)
    np.testing.assert_array_equal(seq12.gt_positions, j.gt_positions)


def test_replay_matches_jax(seq12):
    tcfg, jcfg = configs(REPLAY_KW)
    pos_t, _, diags_t, _ = t_replay.run_replay(tcfg, seq12, max_scans=12, device="cpu")
    pos_j, _, diags_j, _ = j_replay.run_replay(jcfg, seq12, max_scans=12)
    assert pos_t.shape == (12, 3)
    np.testing.assert_allclose(pos_t, pos_j, atol=1e-2)
    assert list(diags_t["icp_converged"]) == [bool(c) for c in diags_j["icp_converged"]]


def test_replay_tracks_ground_truth():
    tcfg, _ = configs(PIPELINE_KW)
    seq = t_dataset.make_synthetic_sequence(duration=6.0, points_per_scan=12000, seed=3)
    # the true initial velocity in the body frame at the first scan end,
    # as test_pipeline.py starts its filter
    traj = t_dataset.AnalyticTrajectory(t_dataset.TrajectoryParams())
    t0 = np.asarray([seq.scans[0].end_time - 1000.0])
    _, R0 = traj.pose(t0)
    v_body = (R0[0].T @ traj.velocity(t0)[0]).astype(np.float32)
    state = t_eskf.init_state(tcfg, device="cpu")._replace(v=torch.as_tensor(v_body))
    pos, _, diags, voxmap = t_replay.run_replay(tcfg, seq, init_state=state, device="cpu")
    assert len(pos) == len(seq.scans)
    err = ate_rmse(pos, seq.gt_positions[: len(pos)], align=True)
    assert err < 0.15, f"ATE {err:.3f} m"
    assert diags["icp_converged"].mean() > 0.9
    assert np.median(diags["num_correspondences"]) > 500
    assert int(voxmap.num_voxels()) > 1000


def test_scan_step_and_predict_only_follow_the_replay_rows(seq12):
    """The single-scan builders run the replay's step: the same pose and
    state from the same carry and row."""
    tcfg, _ = configs(REPLAY_KW)
    init_scan, chunks, scans, evicts, updates, _ = t_replay.pack_sequence(
        tcfg, seq12, 4, device="cpu"
    )
    state = t_eskf.init_state(tcfg, device="cpu")
    voxmap, _ = t_odo.make_init_step(tcfg, device="cpu")(
        t_vm.VoxelMap.create(tcfg.hash_capacity, device="cpu"), init_scan
    )
    carry = (state, voxmap, torch.eye(3), torch.zeros(3))
    row = slice(0, 1)
    out = t_replay.make_replay_step(tcfg, device="cpu")(
        *carry, TChunk(*(x[row] for x in chunks)), TScan(*(x[row] for x in scans)),
        evicts[row], updates[row],
    )
    chunk, scan = TChunk(*(x[0] for x in chunks)), TScan(*(x[0] for x in scans))
    one = t_odo.make_scan_step(tcfg, device="cpu")(*carry, chunk, scan, bool(evicts[0]))
    np.testing.assert_array_equal(one[3].numpy(), out[5][0].numpy())
    np.testing.assert_array_equal(one[0].P.numpy(), out[0].P.numpy())
    predicted = t_odo.make_predict_only(tcfg, device="cpu")(state, chunk)
    noise = t_eskf.make_noise_params(tcfg, device="cpu")
    np.testing.assert_array_equal(
        predicted.p.numpy(), t_eskf.predict_chunk_prefix(state, chunk, noise)[0].p.numpy()
    )


def test_state_handoff_from_jax(seq12):
    """JAX runs k scans; its state and map continue in the port."""
    tcfg, jcfg = configs(REPLAY_KW)
    k = 6
    init_scan, chunks, scans, evicts, updates, _ = j_replay.pack_sequence(jcfg, seq12, 12)
    state = j_eskf.init_state(jcfg)
    voxmap, _ = j_odo.make_init_step(jcfg)(
        j_vm.VoxelMap.create(jcfg.hash_capacity, jcfg.map_delta_capacity), init_scan
    )
    step = j_replay.make_replay_step(jcfg)
    rows = lambda tree, s: jax.tree.map(lambda a: a[s], tree)
    carry = step(state, voxmap, jnp.eye(3), jnp.zeros(3), rows(chunks, slice(0, k)),
                 rows(scans, slice(0, k)), evicts[:k], updates[:k])[:4]
    nxt = slice(k, k + 1)
    j_out = step(*carry, rows(chunks, nxt), rows(scans, nxt), evicts[nxt], updates[nxt])

    # hand over: JAX arrays -> numpy -> the port's tensors
    host = jax.tree.map(np.asarray, carry)
    t_state = convert.filter_state_from_numpy(host[0], device="cpu")
    t_map = convert.voxel_map_from_numpy(host[1], device="cpu")
    for a, b in zip(convert.to_numpy(t_map), host[1]):
        np.testing.assert_array_equal(a, b)
    noise = convert.noise_from_numpy(
        jax.tree.map(np.asarray, j_eskf.make_noise_params(jcfg)), device="cpu"
    )
    for a, b in zip(noise, t_eskf.make_noise_params(tcfg, device="cpu")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    t_step = t_replay.make_replay_step(tcfg, device="cpu")
    as_t = lambda cls, tree: cls(*(convert.from_numpy(np.asarray(a)[k:k + 1], "cpu") for a in tree))
    t_out = t_step(
        t_state, t_map, convert.from_numpy(host[2], "cpu"), convert.from_numpy(host[3], "cpu"),
        as_t(TChunk, chunks), as_t(TScan, scans),
        np.asarray(evicts)[nxt], np.asarray(updates)[nxt],
    )
    np.testing.assert_allclose(t_out[5].numpy(), np.asarray(j_out[5]), atol=1e-3)
    np.testing.assert_allclose(t_out[4].numpy(), np.asarray(j_out[4]), atol=1e-3)
    assert t_out[6]["icp_iterations"].tolist() == np.asarray(j_out[6]["icp_iterations"]).tolist()
    np.testing.assert_allclose(t_out[0].p.numpy(), np.asarray(j_out[0].p), atol=1e-3)
