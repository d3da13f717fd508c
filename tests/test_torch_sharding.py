"""The port's sharded map (`eskf_lio_torch/parallel/sharded_map.py`) vs the
JAX package's, in one process: the JAX side on its 8 virtual CPU devices
(`tests/conftest.py`), the port with all shards on the CPU and its plain
kernel versions; the same inputs, made with numpy from a seed, through both.

Tolerances, each stated where it is used:
* integers, masks and sliced rows: equal;
* map words after the init step: integer words equal, counts and means at
  1e-5; covariances at 1e-4 for 95 % of the voxels, at 1e-2 for 99 %, all
  within 0.3.  The spread is the downsampler's, not the sharding's: a
  near-isotropic neighbourhood has a small eigengap, which turns 1 ulp of
  difference in the moments into a tilt of the plane normal
  (`tests/test_torch_preprocess.py`), and every voxel beyond 1e-4 here holds
  a single point of the first scan;
* one step continued from a JAX state: 1e-5 m;
* trajectories of the two packages: 1e-2 m over 12 scans, the bound of
  `tests/test_torch_replay.py` for the same f32 recursion computed two ways;
* sharded against single device and D = 2 against D = 8: 2e-2 m, the bound
  of `tests/test_sharding.py` (another order of the same sums);
* the captured sharded step (`GraphedShardedScanStep`), its function run on
  the CPU as a replay would run it: equal bit for bit to the eager sharded
  step (the same ops; select mode only merges the untaken side away).
"""

import contextlib
import dataclasses
import socket

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eskf_lio_torch.config import Config as TConfig, ImuConfig as TImu
from eskf_lio_torch.io import dataset as t_dataset
from eskf_lio_torch.io import export as t_export
from eskf_lio_torch.map import voxel_map as t_vm
from eskf_lio_torch.models import registration as t_reg
from eskf_lio_torch.ops import voxel as t_vx
from eskf_lio_torch.parallel import distributed as t_dist
from eskf_lio_torch.parallel import sharded_map as t_smod
from eskf_lio_torch.parallel.distributed import ShardMesh
from eskf_lio_torch.parallel.sharded_map import ShardedOdometry as TSharded
from eskf_lio_torch.pipeline import odometry as t_odo
from eskf_lio_torch.pipeline.odometry import Odometry as TOdometry
from eskf_lio_torch.types import ProcessedScan as TProcessed
from eskf_lio_torch.utils import checkpoint as t_checkpoint
from eskf_lio_torch.utils.metrics import ate_rmse
from eskf_lio_tpu.config import Config as JConfig, ImuConfig as JImu
from eskf_lio_tpu.io import export as j_export
from eskf_lio_tpu.ops import voxel as j_vx
from eskf_lio_tpu.parallel import sharded_map as j_smod
from eskf_lio_tpu.parallel.sharded_map import ShardedOdometry as JSharded
from eskf_lio_tpu.utils import checkpoint as j_checkpoint
from _torch_dist_worker import graphed_on_cpu as worker_graphed_on_cpu

torch.set_num_threads(2)

GRAVITY = (0.0, 0.0, -9.81)
# tests/test_sharding.py's CFG
KW = dict(
    translation_noise=1e-4, rotation_noise=3e-5, max_raw_points=8192,
    max_scan_points=4096, max_imu_per_scan=48, hash_capacity_log2=16,
)
TCFG = TConfig(imu=TImu(gravity=GRAVITY), **KW)
JCFG = JConfig(imu=JImu(gravity=GRAVITY), **KW)
INT32_MAX = t_vm.INT32_MAX


@pytest.fixture(scope="module")
def seq():
    return t_dataset.make_synthetic_sequence(duration=3.0, points_per_scan=8000, seed=7)


def run(odo_obj, seq, n=None):
    odo_obj.run(seq, max_scans=n)
    return odo_obj.positions


def continue_run(odo, seq, start, stop):
    """Feed scans [start, stop) and the IMU after the filter clock to a
    restored driver, as `Odometry.run` would have."""
    odo.imu_pending = []
    imu = iter([r for r in seq.imu if r.t > odo.t_last_update])
    nxt = next(imu, None)
    out = None
    for scan in seq.scans[start:stop]:
        while nxt is not None and nxt.t <= scan.end_time + 0.05:
            odo.feed_imu(nxt)
            nxt = next(imu, None)
        out = odo.process_scan(scan)
    return out


def distinct_voxels(m):
    # exact host-side count across both tiers; `num_voxels()` assumes a
    # globally sorted main tier, which a block-sharded map is not
    live = np.concatenate([np.asarray(m.skey), np.asarray(m.d_skey)])
    return len(np.unique(live[live != INT32_MAX]))


def point_mass(m):
    return float(np.asarray(m.payload)[:, 0].sum() + np.asarray(m.d_payload)[:, 0].sum())


# ---------------------------------------------------------------------------
# the building blocks, against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,d,slack",
    [(4096, 8, 2.0), (16384, 4, 2.0), (16384, 2, 2.0), (32768, 4, 2.0), (1024, 4, 2.0),
     (4096, 1, 2.0), (1000, 3, 1.5), (4096, 8, 1.01)],
)
def test_slice_capacity_matches_jax(n, d, slack):
    assert t_smod.slice_capacity(n, d, slack) == j_smod.slice_capacity(n, d, slack)


def test_slice_capacity_at_the_shipped_sizes():
    assert t_smod.slice_capacity(16384, 4, 2.0) == 8192
    assert t_smod.slice_capacity(16384, 2, 2.0) == 16384
    assert t_smod.slice_capacity(32768, 4, 2.0) == 16384


@pytest.mark.parametrize("n_owners", [2, 3, 4, 8])
def test_owner_hash_matches_jax(n_owners):
    """int32 wrap-around done in int64, owner counts that are no power of
    two included; negative and large coordinates."""
    rng = np.random.default_rng(n_owners)
    keys = rng.integers(-70000, 70000, size=(5000, 3)).astype(np.int32)
    t = t_vx.owner_hash(torch.as_tensor(keys), n_owners).numpy()
    j = np.asarray(j_vx.owner_hash(jnp.asarray(keys), n_owners))
    np.testing.assert_array_equal(t, j)
    assert set(np.unique(t)) == set(range(n_owners))


@pytest.mark.parametrize("halo", [0.0, 0.02])
def test_owner_candidates_match_jax(halo):
    rng = np.random.default_rng(31)
    # many points within the halo of a voxel border
    pts = (rng.integers(-40, 40, size=(6000, 3)) * 0.3
           + rng.choice([0.001, 0.15, 0.299], size=(6000, 3))).astype(np.float32)
    claimed = np.zeros(len(pts), int)
    for my in range(8):
        t = t_smod._owner_candidates(torch.as_tensor(pts), halo, 0.3, 8, my).numpy()
        j = np.asarray(j_smod._owner_candidates(jnp.asarray(pts), halo, 0.3, 8, my))
        np.testing.assert_array_equal(t, j)
        claimed += t
    # every point is claimed; only the halo lets two shards claim one
    assert claimed.min() == 1
    assert (claimed.max() == 1) if halo == 0.0 else (claimed.max() > 1)


@pytest.mark.parametrize("n_cand,s_cap", [(300, 512), (900, 512), (0, 128), (2048, 2048)])
def test_compact_slice_matches_jax(n_cand, s_cap):
    """Candidates lead in scan order (the sort is stable); `valid` marks
    them; `overflow` counts those beyond the slice."""
    rng = np.random.default_rng(n_cand)
    n = 2048
    cand = np.zeros(n, bool)
    cand[rng.permutation(n)[:n_cand]] = True
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.normal(size=(n, 6)).astype(np.float32)
    (ta, tb), t_valid, t_of = t_smod._compact_slice(
        torch.as_tensor(cand), (torch.as_tensor(a), torch.as_tensor(b)), s_cap
    )
    (ja, jb), j_valid, j_of = j_smod._compact_slice(
        jnp.asarray(cand), (jnp.asarray(a), jnp.asarray(b)), s_cap
    )
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert int(t_of) == int(j_of) == max(n_cand - s_cap, 0)
    kept = min(n_cand, s_cap)
    np.testing.assert_array_equal(ta.numpy()[:kept], a[cand][:kept])


def test_empty_map_is_cut_into_the_jax_blocks():
    """The global map cut in D: 2^16 slots and the default 4,096 delta rows
    give 8,192 slots and 512 delta rows a shard (a small map's own default
    would be 2,048), with the views that go with them."""
    t, j = TSharded(TCFG, n_devices=8, device="cpu"), JSharded(JCFG, n_devices=8)
    assert len(t.voxmap.blocks) == 8
    for block in t.voxmap.blocks:
        assert block.capacity == 8192 and block.delta_capacity == 512
        assert block.view.shape == (4096, 128) and block.d_view.shape == (256, 128)
    for name in t_vm.VoxelMap._fields:
        got, want = getattr(t.voxmap, name), np.asarray(getattr(j.voxmap, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError, match="do not divide"):
        ShardMesh.create(0, "cpu")
    with pytest.raises(ValueError, match="rows do not divide"):
        TSharded(TCFG, n_devices=3, device="cpu")


# ---------------------------------------------------------------------------
# the steps, against the JAX steps
# ---------------------------------------------------------------------------


def test_sharded_init_step_matches_jax(seq):
    """Block by block (no reduction is involved yet): integer words equal,
    counts and means at 1e-5, covariances as the downsampler's (see the
    module docstring)."""
    t, j = TSharded(TCFG, n_devices=8, device="cpu"), JSharded(JCFG, n_devices=8)
    t.run(seq, max_scans=1)
    j.run(seq, max_scans=1)
    tm, jm = t.voxmap, j.voxmap
    for name in ("origin", "skey", "d_skey"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    words = np.r_[0:2, t_vm._SLOT_PAY:t_vm.VIEW_SLOT]
    for name in ("view", "d_view"):
        a = getattr(tm, name).numpy().reshape(-1, t_vm.VIEW_SLOT)
        b = np.asarray(getattr(jm, name)).reshape(-1, t_vm.VIEW_SLOT)
        np.testing.assert_array_equal(a[:, words], b[:, words])
    for name in ("payload", "d_payload"):
        a, b = getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=1e-5, atol=1e-5)
        live = a[:, 0] > 0
        err = np.abs(a[:, 4:] - b[:, 4:]).max(1)[live]
        assert live.sum() > 1000
        assert np.mean(err <= 1e-4) >= 0.95 and np.mean(err <= 1e-2) >= 0.99
        assert err.max() <= 0.3
        assert (a[live, 0][err > 1e-4] == 1.0).all()
    # a shard whose 512 delta rows the first scan overflows has folded, in
    # both packages alike (the skeys above are equal tier by tier)
    d_live = (tm.d_skey.numpy() != INT32_MAX).reshape(8, -1).sum(1)
    assert (d_live == 0).any() and (d_live > 0).any()
    assert distinct_voxels(tm) == distinct_voxels(jm) > 3000


@pytest.fixture(scope="module")
def jax_run_12(seq):
    j = JSharded(JCFG, n_devices=8)
    j.run(seq, max_scans=12)
    return j


def test_sharded_scan_step_from_a_jax_state(tmp_path, seq):
    """Three scans in the JAX package, its checkpoint loaded into the port,
    scan 4 in both: the pose within 1e-5 m, the diagnostics equal, the same
    voxels in the same slots of every shard."""
    j = JSharded(JCFG, n_devices=8)
    j.run(seq, max_scans=3)
    ckpt = str(tmp_path / "j3")
    j_checkpoint.save_checkpoint(ckpt, j)
    t = TSharded(TCFG, n_devices=8, device="cpu")
    t_checkpoint.load_checkpoint(ckpt, t)
    np.testing.assert_array_equal(t.voxmap.skey.numpy(), np.asarray(j.voxmap.skey))

    t_diag = continue_run(t, seq, 3, 4)
    j_diag = continue_run(j, seq, 3, 4)
    np.testing.assert_allclose(t.positions[-1], j.positions[-1], atol=1e-5)
    np.testing.assert_allclose(t.trajectory_R[-1], j.trajectory_R[-1], atol=1e-5)
    assert set(t_diag) == set(j_diag)
    for key in j_diag:
        assert int(t_diag[key]) == int(j_diag[key]), key
    for name in ("skey", "d_skey"):
        np.testing.assert_array_equal(getattr(t.voxmap, name).numpy(),
                                      np.asarray(getattr(j.voxmap, name)))


def test_sharded_trajectory_matches_jax(seq, jax_run_12):
    t = TSharded(TCFG, n_devices=8, device="cpu")
    positions = run(t, seq, n=12)
    assert positions.shape == jax_run_12.positions.shape
    np.testing.assert_allclose(positions, jax_run_12.positions, atol=1e-2)
    assert [bool(d["icp_converged"]) for d in t.diags] == [
        bool(d["icp_converged"]) for d in jax_run_12.diags
    ]
    assert set(t.diags[0]) == set(jax_run_12.diags[0])
    nv_t, nv_j = distinct_voxels(t.voxmap), distinct_voxels(jax_run_12.voxmap)
    assert abs(nv_t - nv_j) <= 0.01 * nv_j
    # the report's voxel count is the JAX package's, blind spot included
    assert set(t.summary()) == set(jax_run_12.summary())


def test_adaptive_rematch_is_per_shard_as_in_jax(seq):
    """`icp_rematch_threshold` > 0: the re-match predicate comes from each
    shard's own slice in both packages; 1e-2 m over 5 scans."""
    kw = dict(icp_rematch_threshold=0.05)
    t = TSharded(dataclasses.replace(TCFG, **kw), n_devices=2, device="cpu")
    j = JSharded(dataclasses.replace(JCFG, **kw), n_devices=2)
    np.testing.assert_allclose(run(t, seq, n=5), run(j, seq, n=5), atol=1e-2)
    assert [int(d["icp_iterations"]) for d in t.diags] == [
        int(d["icp_iterations"]) for d in j.diags
    ]


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_sharding.py
# ---------------------------------------------------------------------------


def test_sharded_matches_single_device(seq):
    single = run(TOdometry(TCFG, device="cpu"), seq, n=12)
    sharded = run(TSharded(TCFG, n_devices=8, device="cpu"), seq, n=12)
    assert single.shape == sharded.shape
    # identical algorithm, different reduction order -> tiny f32 divergence
    # that compounds through the filter; trajectories must stay close
    np.testing.assert_allclose(sharded, single, atol=2e-2)


def test_sharded_tracks_ground_truth(seq):
    odo = TSharded(TCFG, n_devices=8, device="cpu")
    odo.run(seq)
    est = odo.positions
    err = ate_rmse(est, seq.gt_positions[: len(est)], align=True)
    assert err < 0.2, f"sharded ATE {err:.3f}"


def test_sharded_map_is_partitioned(seq):
    """Each voxel key must live on exactly one shard."""
    odo = TSharded(TCFG, n_devices=8, device="cpu")
    odo.run(seq, max_scans=5)
    n_dev = 8
    sub = TCFG.hash_capacity // n_dev
    keys = odo.voxmap.keys(TCFG.map_key_bits).numpy().reshape(n_dev, sub, 3)
    occ = odo.voxmap.live().numpy().reshape(n_dev, sub)
    total = 0
    for d in range(n_dev):
        k = keys[d][occ[d]]
        if len(k) == 0:
            continue
        owners = t_vx.owner_hash(torch.as_tensor(k), n_dev).numpy()
        assert np.all(owners == d), f"shard {d} holds foreign keys"
        total += len(k)
    assert total > 500


def test_sharded_different_device_counts(seq):
    """Result should be independent of the shard count (modulo f32 noise)."""
    p2 = run(TSharded(TCFG, n_devices=2, device="cpu"), seq, n=8)
    p8 = run(TSharded(TCFG, n_devices=8, device="cpu"), seq, n=8)
    np.testing.assert_allclose(p2, p8, atol=2e-2)


def test_per_device_compute_scales(monkeypatch, seq):
    """The GN loop must run on owner-compacted N/D·slack slices, not the
    full scan: `align` gets one [S] slice per local shard, and the normal
    equations (kernel A's plain version here) S rows a call."""
    recorded, kernel_rows = [], []
    orig_align, orig_gn = t_reg.align, t_reg.gn_normal_eq.normal_equations_rotated

    def spy(scan, voxmap, guess, config, **kw):
        recorded.append(tuple(scan.points.shape))
        return orig_align(scan, voxmap, guess, config, **kw)

    def gn_spy(pts_w, *rest):
        kernel_rows.append(tuple(pts_w.shape))
        return orig_gn(pts_w, *rest)

    monkeypatch.setattr(t_smod.registration, "align", spy)
    monkeypatch.setattr(t_reg.gn_normal_eq, "normal_equations_rotated", gn_spy)
    odo = TSharded(TCFG, n_devices=8, device="cpu")
    odo.run(seq, max_scans=3)
    s_expected = t_smod.slice_capacity(TCFG.max_scan_points, 8, TCFG.shard_slack)
    assert s_expected * 2 <= TCFG.max_scan_points, "slice must shrink the work"
    assert recorded and all(s == (8, s_expected, 3) for s in recorded), recorded
    iters = sum(int(d["icp_iterations"]) for d in odo.diags)
    assert kernel_rows == [(s_expected, 3)] * (8 * iters)


def _delta_occupancy(voxmap, n_dev):
    """Per-shard delta liveness masks, [n_dev, d_cap/n_dev]."""
    return (voxmap.d_skey.numpy() != INT32_MAX).reshape(n_dev, -1)


def test_sharded_delta_tier_bookkeeping(seq):
    """The three invariants of `tests/test_sharding.py` on every scan of an
    8-shard run with a delta sized above the run's distinct voxel count:
    live delta rows form a contiguous prefix per shard, live delta keys are
    unique per shard, and per-shard occupancy never drops (no fold fires)."""
    cfg = dataclasses.replace(TCFG, map_delta_log2=15)
    odo = TSharded(cfg, n_devices=8, device="cpu")
    occ_hist = []

    def check(o):
        n = len(occ_hist)
        occ = _delta_occupancy(o.voxmap, 8)
        d_skeys = o.voxmap.d_skey.numpy().reshape(8, -1)
        for d in range(8):
            live = occ[d]
            fill = int(live.sum())
            assert live[:fill].all() and not live[fill:].any(), (
                f"scan {n} shard {d}: delta liveness not a contiguous prefix (fill={fill})"
            )
            keys = d_skeys[d][live]
            assert len(np.unique(keys)) == len(keys), (
                f"scan {n} shard {d}: duplicate delta keys (row overwrite)"
            )
        occ_hist.append(occ.sum(axis=1))

    odo.run(seq, max_scans=16, on_scan=check)
    occ_hist = np.stack(occ_hist)  # [n_scans, n_dev]
    assert (np.diff(occ_hist, axis=0) >= 0).all(), (
        f"delta occupancy dropped (unexpected fold):\n{occ_hist.tolist()}"
    )
    assert occ_hist[-1].sum() > 0, "delta tier never accumulates"


def test_sharded_map_state_matches_single_device(seq):
    """Map-STATE parity D=8 vs D=1 (not just trajectories) over 24 scans
    with evictions: distinct voxel count and total point mass within 2 %."""
    cfg = dataclasses.replace(TCFG, remove_period=1.2)  # force evictions
    single = TOdometry(cfg, device="cpu")
    sharded = TSharded(cfg, n_devices=8, device="cpu")
    single.run(seq, max_scans=24)
    sharded.run(seq, max_scans=24)

    nv_single = distinct_voxels(single.voxmap)
    nv_sharded = distinct_voxels(sharded.voxmap)
    assert nv_single > 1000
    assert abs(nv_sharded - nv_single) <= 0.02 * nv_single, (
        f"voxel count diverged: single={nv_single} sharded={nv_sharded}"
    )
    pm_single, pm_sharded = point_mass(single.voxmap), point_mass(sharded.voxmap)
    assert pm_single > 0
    assert abs(pm_sharded - pm_single) <= 0.02 * pm_single, (
        f"point mass diverged: single={pm_single} sharded={pm_sharded}"
    )
    # the eviction clock fired on the same scans in both drivers
    assert [int(d["removed_voxels"]) > 0 for d in single.diags].count(True) == \
        [int(d["removed_voxels"]) > 0 for d in sharded.diags].count(True)


def test_no_slice_overflow(seq):
    """With the default slack, owner slices must not overflow on a uniform
    scan (overflow = silently dropped correspondences/inserts)."""
    odo = TSharded(TCFG, n_devices=8, device="cpu")
    odo.run(seq, max_scans=10)
    assert sum(int(d["gn_slice_overflow"]) for d in odo.diags) == 0
    assert sum(int(d["insert_slice_overflow"]) for d in odo.diags) == 0


def test_slice_overflow_is_counted_and_gated(seq):
    """A slack below 1 cannot hold a shard's points: both counters fire, and
    `insert_slice_overflow` only on scans whose insert ran."""
    cfg = dataclasses.replace(TCFG, shard_slack=0.5)
    odo = TSharded(cfg, n_devices=2, device="cpu")
    odo.run(seq, max_scans=4)
    assert all(int(d["gn_slice_overflow"]) > 0 for d in odo.diags)
    for d in odo.diags:
        assert (int(d["insert_slice_overflow"]) > 0) == bool(d["inserted"])


# ---------------------------------------------------------------------------
# align's reduce_fn hook
# ---------------------------------------------------------------------------


def align_inputs(seq):
    """A processed scan and the map it aligns against, after 4 scans."""
    from eskf_lio_torch.models import eskf
    from eskf_lio_torch.ops import preprocess

    odo = TOdometry(TCFG, device="cpu")
    odo.run(seq, max_scans=4)
    processed = preprocess.downsample_and_covariances(
        t_odo.lidar_extrinsics(TCFG, "cpu").apply(torch.as_tensor(seq.scans[4].points[:8192])),
        torch.ones(min(len(seq.scans[4].points), 8192), dtype=torch.bool), TCFG,
    )
    guess = eskf.pose_of(odo.state)
    return processed, odo.voxmap, guess


def test_reduce_fn_identity_leaves_align_bit_equal(seq):
    processed, voxmap, guess = align_inputs(seq)
    plain = t_reg.align(processed, voxmap, guess, TCFG)
    calls = []

    def identity(JTJ, JTr, n):
        calls.append((tuple(JTJ.shape), tuple(JTr.shape), tuple(n.shape)))
        return JTJ, JTr, n

    hooked = t_reg.align(processed, voxmap, guess, TCFG, reduce_fn=identity)
    assert torch.equal(plain.pose.R, hooked.pose.R) and torch.equal(plain.pose.t, hooked.pose.t)
    assert (plain.iterations, plain.converged) == (hooked.iterations, hooked.converged)
    assert int(plain.num_correspondences) == int(hooked.num_correspondences) > 100
    # called after the normal equations of every iteration, with their shapes
    assert calls == [((6, 6), (6,), ())] * plain.iterations


@pytest.mark.parametrize("backend", ["auto", "einsum"])
def test_reduce_fn_sums_two_halves_of_a_scan(seq, backend):
    """The scan as two stacked halves with a hook that adds their normal
    equations equals the whole scan within 1e-5 (another order of the same
    f32 sums); without the hook a stacked scan is refused."""
    cfg = dataclasses.replace(TCFG, gn_backend=backend)
    processed, voxmap, guess = align_inputs(seq)
    whole = t_reg.align(processed, voxmap, guess, cfg)
    halves = TProcessed(*(x.reshape(2, x.shape[0] // 2, *x.shape[1:]) for x in processed))

    def lookup_fn(pts):
        out = [t_vm.lookup(voxmap, p, voxel_size=cfg.map_voxel_size,
                           max_points_per_voxel=cfg.max_points_per_voxel) for p in pts]
        return tuple(torch.stack(x) for x in zip(*out))

    def add_halves(JTJ, JTr, n):
        assert JTJ.shape == (2, 6, 6) and JTr.shape == (2, 6) and n.shape == (2,)
        return JTJ[0] + JTJ[1], JTr[0] + JTr[1], n[0] + n[1]

    summed = t_reg.align(halves, None, guess, cfg, lookup_fn=lookup_fn, reduce_fn=add_halves)
    np.testing.assert_allclose(summed.pose.t.numpy(), whole.pose.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(summed.pose.R.numpy(), whole.pose.R.numpy(), atol=1e-5)
    assert summed.iterations == whole.iterations
    assert int(summed.num_correspondences) == int(whole.num_correspondences)
    with pytest.raises(ValueError, match="reduce_fn"):
        t_reg.align(halves, None, guess, cfg, lookup_fn=lookup_fn)


def test_shard_sum_packs_43_floats():
    """The hook of the sharded step: local partials added pairwise in index
    order, so that two processes of two shards each compute the expression
    of one process of four; the count rides as the 43rd float and comes back
    exact."""
    rng = np.random.default_rng(3)
    JTJ = torch.as_tensor(rng.normal(size=(4, 6, 6)).astype(np.float32))
    JTr = torch.as_tensor(rng.normal(size=(4, 6)).astype(np.float32))
    n = torch.tensor([1000.0, 2345.0, 16384.0, 7.0])
    a, b, c = t_smod._shard_sum_fn(4)(JTJ, JTr, n)
    assert torch.equal(a, (JTJ[0] + JTJ[1]) + (JTJ[2] + JTJ[3])) and a.shape == (6, 6)
    assert torch.equal(b, (JTr[0] + JTr[1]) + (JTr[2] + JTr[3])) and b.shape == (6,)
    assert float(c) == 19736.0 and c.shape == ()
    halves = [t_smod._shard_sum_fn(2)(JTJ[i:i + 2], JTr[i:i + 2], n[i:i + 2]) for i in (0, 2)]
    assert torch.equal(halves[0][0] + halves[1][0], a)
    odd = t_smod._shard_sum_fn(3)(JTJ[:3], JTr[:3], n[:3])
    assert torch.equal(odd[0], (JTJ[0] + JTJ[1]) + JTJ[2])
    # an integer count (the einsum backend's) is carried as f32
    assert float(t_smod._shard_sum_fn(1)(JTJ[:1], JTr[:1], torch.tensor([77]))[2]) == 77.0


# ---------------------------------------------------------------------------
# checkpoint and export of a sharded map
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_d4(seq, tmp_path_factory):
    """Four scans of the JAX package's D = 4 driver and its checkpoint."""
    j = JSharded(JCFG, n_devices=4)
    j.run(seq, max_scans=4)
    path = str(tmp_path_factory.mktemp("jax_d4") / "ckpt")
    j_checkpoint.save_checkpoint(path, j)
    return j, path


def test_sharded_checkpoint_interchange(tmp_path, seq, jax_d4):
    """D = 4: JAX sharded -> port sharded and back, map words equal; the
    port's resumed run equals its straight run exactly."""
    j, j_dir = jax_d4
    t_dir = str(tmp_path / "t")

    t = TSharded(TCFG, n_devices=4, device="cpu")
    t_checkpoint.load_checkpoint(j_dir, t)
    assert len(t.voxmap.blocks) == 4 and t.voxmap.blocks[0].capacity == TCFG.hash_capacity // 4
    for name in t_vm.VoxelMap._fields:
        np.testing.assert_array_equal(
            getattr(t.voxmap, name).numpy().view(np.int32),
            np.asarray(getattr(j.voxmap, name)).view(np.int32), err_msg=name,
        )
    t_checkpoint.save_checkpoint(t_dir, t)
    back = JSharded(JCFG, n_devices=4)
    j_checkpoint.load_checkpoint(t_dir, back)
    for name in t_vm.VoxelMap._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(back.voxmap, name)).view(np.int32),
            np.asarray(getattr(j.voxmap, name)).view(np.int32), err_msg=name,
        )
    assert back.t_last_update == j.t_last_update and len(back.trajectory_p) == 4
    # and the JAX driver runs on from the port's checkpoint
    assert continue_run(back, seq, 4, 5) is not None

    straight = TSharded(TCFG, n_devices=4, device="cpu")
    straight.run(seq, max_scans=7)
    first = TSharded(TCFG, n_devices=4, device="cpu")
    first.run(seq, max_scans=4)
    t_checkpoint.save_checkpoint(t_dir, first)
    resumed = TSharded(TCFG, n_devices=4, device="cpu")
    t_checkpoint.load_checkpoint(t_dir, resumed)
    continue_run(resumed, seq, 4, 7)
    np.testing.assert_array_equal(resumed.positions, straight.positions)
    for x, y in zip(resumed.voxmap, straight.voxmap):
        assert torch.equal(x, y)


def test_sharded_map_exports_like_jax(jax_d4):
    """The cloud of a sharded map: the same JAX checkpoint through both
    exporters gives the same points in the same order."""
    j, ckpt = jax_d4
    t = TSharded(TCFG, n_devices=4, device="cpu")
    t_checkpoint.load_checkpoint(ckpt, t)
    t_pts, t_counts = t_export.map_to_cloud(t.voxmap)
    j_pts, j_counts = j_export.map_to_cloud(j.voxmap)
    assert len(t_pts) == distinct_voxels(t.voxmap) == len(j_pts)
    np.testing.assert_allclose(t_pts, j_pts, atol=1e-6)
    np.testing.assert_array_equal(t_counts, j_counts)
    dense = t_export.map_to_dense_cloud(t.voxmap, samples_per_voxel=3)
    assert dense.shape == j_export.map_to_dense_cloud(j.voxmap, samples_per_voxel=3).shape


def test_dryrun():
    cfg = TConfig(imu=TImu(gravity=GRAVITY), max_raw_points=2048, max_scan_points=1024,
                  hash_capacity_log2=14)
    runner = t_smod.ShardedOdometryRunner(cfg, 4, device="cpu")
    runner.dryrun()
    assert len(runner.odo.trajectory_t) == 2 and len(runner.odo.diags) == 1
    assert np.isfinite(runner.odo.positions).all()


def test_sharded_odometry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSharded(TCFG, n_devices=2)


# ---------------------------------------------------------------------------
# the captured sharded step, its function run on the CPU
# ---------------------------------------------------------------------------


def graphed_on_cpu(config, n_devices: int, no_read: bool = True) -> TSharded:
    """A sharded driver whose scan step is a `GraphedShardedScanStep` over
    CPU buffers, each of its graphs a stand-in for `StepGraph` whose replay
    calls the function the graph would capture: with `no_read`, in select
    mode (every branch and loop pass run, merged by `torch.where`) under
    `NoHostRead`, which fails on any read of a device value
    (`tests/_torch_dist_worker.py::graphed_on_cpu`)."""
    odo = TSharded(config, n_devices=n_devices, device="cpu")
    assert not odo.graphed and odo.step_reason == "eager: the step runs on the cpu"
    return worker_graphed_on_cpu(odo, no_read)


def assert_same_runs(a, b):
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(np.stack(a.trajectory_R), np.stack(b.trajectory_R))
    assert [{k: int(v) for k, v in d.items()} for d in a.diags] == [
        {k: int(v) for k, v in d.items()} for d in b.diags
    ]
    for name, x, y in zip(t_vm.VoxelMap._fields, a.voxmap, b.voxmap):
        assert torch.equal(x, y), name


def test_graphed_sharded_step_reads_nothing_and_matches_eager_and_jax(seq, jax_d4):
    """D = 4: the captured step's function, in select mode under
    `NoHostRead`, over the JAX fixture's four scans: it reads nothing back,
    equals the eager sharded step bit for bit and the JAX `ShardedOdometry`
    within 1e-2 m (the trajectories' bound above)."""
    j, _ = jax_d4
    graphed = graphed_on_cpu(TCFG, 4)
    graphed.run(seq, max_scans=4)
    eager = TSharded(TCFG, n_devices=4, device="cpu")
    eager.run(seq, max_scans=4)
    assert_same_runs(graphed, eager)
    np.testing.assert_allclose(graphed.positions, j.positions, atol=1e-2)
    assert [bool(d["icp_converged"]) for d in graphed.diags] == [
        bool(d["icp_converged"]) for d in j.diags
    ]


def test_graphed_sharded_step_folds_and_evicts_like_the_eager_step(seq):
    """D = 4 with every scan inserted, the delta tiers folding and an
    eviction every other scan: both graphs of the step (with and without
    eviction), select mode under `NoHostRead`, equal to the eager step bit
    for bit."""
    cfg = dataclasses.replace(TCFG, map_update_translation_sq_threshold=0.0,
                              remove_period=0.15, remove_distance_threshold=8.0,
                              icp_max_iterations=12)
    folds = []

    def delta_fill(o):
        folds.append([int((b.d_skey != INT32_MAX).sum()) for b in o.voxmap.blocks])

    graphed = graphed_on_cpu(cfg, 4)
    graphed.run(seq, max_scans=6)
    eager = TSharded(cfg, n_devices=4, device="cpu")
    eager.run(seq, max_scans=6, on_scan=delta_fill)
    assert_same_runs(graphed, eager)
    assert sum(int(d["removed_voxels"]) > 0 for d in eager.diags) >= 2
    # a block whose delta tier emptied after it held rows has folded
    assert any(b == 0 < a for prev, now in zip(folds, folds[1:]) for a, b in zip(prev, now))


def test_map_read_after_scan_k_is_the_map_of_scan_k(seq):
    """The captured step writes its map blocks in place, and a
    `ShardedVoxelMap` keeps its gathered arrays once read: the driver's map,
    read (gathered) after every scan, must be that scan's map, as the eager
    step's is — never the gathered arrays of an earlier scan."""
    cfg = dataclasses.replace(TCFG, map_update_translation_sq_threshold=0.0)
    read = {"graph": [], "eager": []}
    for mode in read:
        odo = graphed_on_cpu(cfg, 4, no_read=False) if mode == "graph" else TSharded(
            cfg, n_devices=4, device="cpu")
        odo.run(seq, max_scans=5, on_scan=lambda o, m=read[mode]: m.append(
            [x.clone() for x in o.voxmap]))
    assert len(read["graph"]) == len(read["eager"]) == 5
    for k, (g, e) in enumerate(zip(read["graph"], read["eager"])):
        assert all(torch.equal(x, y) for x, y in zip(g, e)), f"the map read after scan {k + 1}"
    # every scan inserted: each read is a new map
    assert all(not torch.equal(a[1], b[1]) or not torch.equal(a[4], b[4])
               for a, b in zip(read["graph"], read["graph"][1:]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_step_graph_choice_follows_the_backend_and_says_why(monkeypatch):
    """`_make_steps` picks the step by `graph_choice`, from the device and
    the process group's backend alone: on a CUDA device without a group and
    under `nccl` the captured step (under `nccl` the all-reduce is captured
    inside the GN loop); under `gloo` on a CUDA device eager (gloo stages
    its all-reduce through the host); on the CPU eager; each with its
    reason in `step_reason`.  `GraphedShardedScanStep` refuses only the
    staged case, so a `gloo` group on the CPU may run the captured
    function."""
    cuda = torch.device("cuda", 0)
    alone = t_smod.graph_choice(cuda)
    assert alone[0] is True and "shard sum is local" in alone[1]
    assert t_smod.graph_choice(torch.device("cpu")) == (False, "eager: the step runs on the cpu")
    assert t_dist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu",
                             timeout_s=30.0) == (1, 0)
    try:
        graphed, why = t_smod.graph_choice(cuda)
        assert graphed is False and why.startswith("eager: a gloo process group")
        assert "staged through the host" in why
        assert t_smod.graph_choice(torch.device("cpu")) == (
            False, "eager: the step runs on the cpu")
        odo = TSharded(TCFG, n_devices=4, device="cpu")
        assert odo.graphed is False and odo.step_reason == "eager: the step runs on the cpu"
        assert not isinstance(odo.scan_step, t_smod.GraphedShardedScanStep)
        with pytest.raises(RuntimeError, match="staged through the host"):
            t_smod.GraphedShardedScanStep(TCFG, ShardMesh(4, cuda))
        # accepted on the CPU (its graphs stand-ins that hold the function)
        monkeypatch.setattr(t_odo, "StepGraph", lambda fn, *a, **k: fn)
        monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
        assert callable(t_smod.GraphedShardedScanStep(TCFG, odo.mesh).graphs[False])
        # an nccl group (this CPU build of torch has no NCCL: its backend's
        # name stands in for it)
        monkeypatch.setattr(torch.distributed, "get_backend", lambda *a, **k: "nccl")
        graphed, why = t_smod.graph_choice(cuda)
        assert graphed is True and why.startswith("graph: under the nccl process group")
        assert "captured inside the GN loop" in why
        assert t_smod.graph_choice(torch.device("cpu"))[0] is False
        assert not t_dist.staged(cuda) and not t_dist.staged(torch.device("cpu"))
    finally:
        monkeypatch.undo()
        t_dist.shutdown(wait=False)
    assert t_smod.graph_choice(cuda) == alone
