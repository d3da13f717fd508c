"""Device-side control flow (`eskf_lio_torch/utils/graphs.py`): the port's
`lax.cond` / `lax.while_loop` and the captured step.

On the CPU `device_if` and `device_while` run eagerly (one read of the
predicate) or, under `select_branches()`, run every branch and merge with
`torch.where`: the values a captured graph computes, with no host read.
Checked here:

* both modes give a Python branch's and loop's values;
* the guarded GN loop (`icp_max_iterations` guarded passes in select mode)
  equals the eager loop BIT FOR BIT and the JAX `align` within 1e-4, the
  tolerance of `tests/test_torch_registration.py` — with the adaptive
  re-match and with `icp_relookup_every = 2`;
* `insert`'s fold / append choice gives the JAX package's map words (payloads
  at the rtol 1e-5 / atol 1e-6 of `tests/test_torch_voxel_map.py`) across a
  fold and an append, in both modes, the two modes bit-equal;
* the whole `make_step_core` in select mode runs under a dispatch mode that
  raises on any host read (`aten._local_scalar_dense`, `aten.nonzero`, a
  bool-mask index) and tracks the JAX driver within 1e-2 m, the bound of
  `tests/test_torch_odometry.py` for the same recursion computed two ways;
* the prediction's covariance does not depend on the CPU's thread count.

The captured path itself needs the card: its tests are in
`tests/test_torch_cuda.py`, which runs without JAX.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eskf_lio_torch.config import Config as TConfig, ImuConfig as TImu
from eskf_lio_torch.io import dataset as t_dataset
from eskf_lio_torch.map import voxel_map as t_vm
from eskf_lio_torch.models import eskf as t_eskf
from eskf_lio_torch.models import registration as t_reg
from eskf_lio_torch.pipeline import odometry as t_odo
from eskf_lio_torch.types import ImuChunk, Pose as TPose, ProcessedScan as TScan
from eskf_lio_torch.utils import graphs
from eskf_lio_tpu.config import Config as JConfig, ImuConfig as JImu
from eskf_lio_tpu.map import voxel_map as j_vm
from eskf_lio_tpu.models import registration as j_reg
from eskf_lio_tpu.pipeline.odometry import Odometry as JOdometry
from eskf_lio_tpu.types import Pose as JPose, ProcessedScan as JScan
from _torch_no_host_read import NoHostRead
from test_torch_registration import N_SCAN, scan_from, world  # noqa: F401 (fixture)
from test_torch_voxel_map import assert_maps_equal, rand_cloud

torch.set_num_threads(2)

GRAVITY = (0.0, 0.0, -9.81)


def test_no_host_read_mode_catches_reads():
    x = torch.arange(4.0)
    for read in (lambda: bool(x.sum() > 0), lambda: x[x.sum().long() % 4],
                 lambda: x[x > 1], lambda: x.nonzero()):
        with pytest.raises(AssertionError, match="host read"), NoHostRead():
            read()


# ---------------------------------------------------------------------------
# device_if / device_while
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("with_else", [True, False])
def test_device_if_matches_a_python_branch(flag, with_else):
    a, b = torch.arange(6.0).reshape(2, 3), torch.full((2, 3), -1.0)
    pred = torch.tensor(flag)

    def taken():
        return a * 2, a.sum().reshape(())

    def other():
        return b + 1, b.sum().reshape(())

    outs = (b, torch.zeros(()))
    if flag:
        want = taken()
    else:
        want = other() if with_else else outs
    for select in (False, True):
        with graphs.select_branches() if select else torch.no_grad():
            got = graphs.device_if(pred, taken, outs, otherwise=other if with_else else None)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # nothing was written in place
    assert torch.equal(b, torch.full((2, 3), -1.0))


def test_device_while_matches_a_python_loop():
    def body(c):
        go, k, x = c
        k = k + 1
        x = x * 1.5 + k
        return k < 7, k, x

    carry = (torch.tensor(True), torch.tensor(0), torch.ones(3))
    want = carry
    while bool(want[0]):
        want = body(want)
    eager = graphs.device_while(body, carry, 20)
    with graphs.select_branches():
        select = graphs.device_while(body, carry, 20)
    for w, e, s in zip(want, eager, select):
        assert torch.equal(w, e) and torch.equal(w, s)
    assert int(eager[1]) == 7


# ---------------------------------------------------------------------------
# the guarded GN loop and the insert fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "extra", [{}, {"icp_relookup_every": 2}, {"icp_rematch_threshold": 0.01}],
    ids=["rematch-every-pass", "relookup-every-2", "adaptive-rematch"],
)
def test_guarded_align_equals_eager_and_jax(world, extra):  # noqa: F811
    pts, covs, t_map, j_map = world
    body, bcovs, valid = scan_from(pts, covs, [0.05, -0.04, 0.02, 0.01, -0.02, 0.03], 4)
    base = dict(max_scan_points=N_SCAN, icp_max_iterations=30, gn_backend="einsum", **extra)
    j = j_reg.align(JScan(jnp.asarray(body), jnp.asarray(bcovs), jnp.asarray(valid)), j_map,
                    JPose(jnp.eye(3), jnp.zeros(3)), JConfig(**base))
    scan = TScan(torch.as_tensor(body), torch.as_tensor(bcovs), torch.as_tensor(valid))
    for backend in ("einsum", "auto"):
        cfg = TConfig(**{**base, "gn_backend": backend})
        eager = t_reg.align(scan, t_map, TPose.identity("cpu"), cfg)
        with graphs.select_branches():
            guarded = t_reg.align(scan, t_map, TPose.identity("cpu"), cfg)
        for e, g in ((eager.pose.R, guarded.pose.R), (eager.pose.t, guarded.pose.t),
                     (eager.iterations, guarded.iterations),
                     (eager.converged, guarded.converged),
                     (eager.num_correspondences, guarded.num_correspondences)):
            assert torch.equal(e, g), backend
        assert int(guarded.iterations) == int(j.iterations)
        np.testing.assert_allclose(guarded.pose.t.numpy(), np.asarray(j.pose.t), atol=1e-4)
        np.testing.assert_allclose(guarded.pose.R.numpy(), np.asarray(j.pose.R), atol=1e-4)


def test_insert_fold_and_append_match_jax_in_both_modes():
    """Three inserts into a 2,048-row delta: an append first, then inserts
    whose new voxels overflow it and fold into MAIN."""
    rng = np.random.default_rng(0)
    kw = dict(voxel_size=0.3, max_points_per_voxel=1000)
    j_map = j_vm.VoxelMap.create(1 << 12)
    t_maps = {"eager": t_vm.VoxelMap.create(1 << 12, device="cpu")}
    t_maps["select"] = t_maps["eager"]
    folded = []
    for n, center in ((1500, (0, 0, 0)), (1500, (1, 0, 0)), (3000, (6, 2, 0))):
        p, c = rand_cloud(rng, n, center)
        valid = np.ones(n, bool)
        valid[-50:] = False
        j_map, j_drop = j_vm.insert(j_map, jnp.asarray(p), jnp.asarray(c), jnp.asarray(valid), **kw)
        for mode in ("eager", "select"):
            with graphs.select_branches() if mode == "select" else torch.no_grad():
                t_maps[mode], t_drop = t_vm.insert(
                    t_maps[mode], torch.as_tensor(p), torch.as_tensor(c),
                    torch.as_tensor(valid), **kw
                )
            assert int(t_drop) == int(j_drop)
            assert_maps_equal(t_maps[mode], j_map)
        for x, y in zip(t_maps["eager"], t_maps["select"]):
            assert torch.equal(x, y)
        folded.append(int(t_maps["eager"].d_fill()) == 0)
    assert folded[0] is False and True in folded


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------


def test_whole_step_in_select_mode_reads_nothing_and_matches_jax():
    """The port's driver with its scan step run in select mode under
    `NoHostRead`, beside the JAX driver on the same records.  Every scan is
    inserted (~3,600 new voxels each), so the 4,096-row delta tier folds
    every other scan."""
    kw = dict(translation_noise=1e-4, rotation_noise=3e-5, max_raw_points=8192,
              max_scan_points=4096, max_imu_per_scan=48, hash_capacity_log2=15,
              map_delta_log2=12, icp_max_iterations=20,
              map_update_translation_sq_threshold=0.0)
    t_cfg, j_cfg = TConfig(imu=TImu(gravity=GRAVITY), **kw), JConfig(imu=JImu(gravity=GRAVITY), **kw)
    seq = t_dataset.make_synthetic_sequence(duration=1.0, points_per_scan=8000, seed=5)
    t_o, j_o = t_odo.Odometry(t_cfg, device="cpu"), JOdometry(j_cfg)
    step, folds = t_o.scan_step, []

    def guarded(state, voxmap, *rest):
        with graphs.select_branches(), NoHostRead():
            out = step(state, voxmap, *rest)
        folds.append(not torch.equal(out[1].skey, voxmap.skey))  # the main tier moved
        return out

    t_o.scan_step = guarded
    t_o.run(seq)
    j_o.run(seq)
    assert len(t_o.trajectory_p) == len(j_o.trajectory_p) == len(seq.scans)
    assert any(folds) and not all(folds)
    np.testing.assert_allclose(t_o.positions, j_o.positions, atol=1e-2)
    assert [bool(d["icp_converged"]) for d in t_o.diags] == [
        bool(d["icp_converged"]) for d in j_o.diags
    ]


def test_predict_covariance_does_not_depend_on_the_thread_count():
    """The base covariance sums 48 products over the chunk: as one long
    matrix product its CPU result followed the number of threads, and two
    runs of a driver could differ when that number did."""
    cfg = TConfig(imu=TImu(gravity=GRAVITY), max_imu_per_scan=48)
    rng = np.random.default_rng(1)
    m = cfg.max_imu_per_scan
    chunk = ImuChunk(
        dt=torch.full((m,), 0.0025), t_rel=torch.linspace(-0.1, 0.01, m),
        gyro=torch.as_tensor(rng.normal(size=(m, 3)).astype(np.float32)) * 0.1,
        accel=torch.as_tensor(rng.normal(size=(m, 3)).astype(np.float32)) + torch.tensor([0, 0, 9.81]),
        valid=torch.ones(m, dtype=torch.bool),
    )
    state = t_eskf.init_state(cfg, "cpu")
    state = state._replace(P=state.P + 1e-3 * torch.ones(18, 18))
    noise = t_eskf.make_noise_params(cfg, "cpu")
    before = torch.get_num_threads()
    try:
        results = []
        for n in (1, 2, 3):
            torch.set_num_threads(n)
            results.append(t_eskf.predict_chunk_prefix(state, chunk, noise)[0].P)
    finally:
        torch.set_num_threads(before)
    assert all(torch.equal(results[0], r) for r in results[1:])


def test_graph_stress_eager_loop_runs_on_the_cpu(monkeypatch):
    """`utils/graph_stress.py`'s loop with both steps eager (`--eager`),
    two short rounds on the CPU (its synchronize a no-op here): every scan
    of both steps runs, single-device and sharded; and two eager runs of
    each step over the same scans give the same bits by its `differing`."""
    from eskf_lio_torch.utils import graph_stress as gs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    dev = torch.device("cpu")
    res = gs.stress("small", 2, 2, dev, graphed=False)
    assert res["scans_run"] == 2 * 2 * 2 and res["scans_compared"] == 0
    config = gs.make_config("small")
    inp = gs.prepare_inputs(config, gs.make_sequence("small", 2), dev, 2)
    for sharded in (False, True):
        runs = []
        for _ in range(2):
            carry, core = gs.start(config, dev, inp, sharded)
            for b, evict in enumerate(gs.evict_flags(2, first=True)):
                out = core(*carry, inp.chunks[b], inp.scans[b], evict)
                carry = list(out[:4])
            runs.append(gs.flat(out, gs.step_keys(sharded)))
        assert gs.differing(*runs) == []
        assert len(runs[0]) > 10
