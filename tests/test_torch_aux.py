"""Auxiliary subsystems of the port: checkpoint / resume (alone and across
packages), export formats, rosbag2 ingestion, the native runtime bindings,
profiling helpers and the viewers — each held against the JAX package's
counterpart on the same inputs.

Tolerances: a resumed run of the port equals the straight run exactly (the
CPU path is deterministic); a step continued in the other package agrees to
1e-3 m (one step: only f32 rounding differs, the bound of
`tests/test_torch_replay.py::test_state_handoff_from_jax`); integer words,
file contents and host-side numpy results are equal.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eskf_lio_torch.config import Config as TConfig, ImuConfig as TImu
from eskf_lio_torch.io import dataset as t_dataset
from eskf_lio_torch.io import export as t_export
from eskf_lio_torch.io import native_runtime as t_native
from eskf_lio_torch.io import rosbag2 as t_rosbag2
from eskf_lio_torch.map import voxel_map as t_vm
from eskf_lio_torch.pipeline.odometry import Odometry as TOdometry
from eskf_lio_torch.utils import checkpoint as t_checkpoint
from eskf_lio_torch.utils import convert
from eskf_lio_torch.utils import profiling as t_profiling
from eskf_lio_tpu.config import Config as JConfig, ImuConfig as JImu
from eskf_lio_tpu.io import export as j_export
from eskf_lio_tpu.io import native_runtime as j_native
from eskf_lio_tpu.io import rosbag2 as j_rosbag2
from eskf_lio_tpu.map import voxel_map as j_vm
from eskf_lio_tpu.pipeline.odometry import Odometry as JOdometry
from eskf_lio_tpu.utils import checkpoint as j_checkpoint
from test_rosbag2 import encode_cloud, encode_imu, make_bag

torch.set_num_threads(2)

# tests/test_aux.py's CFG
KW = dict(
    translation_noise=1e-4, rotation_noise=3e-5, max_raw_points=8192,
    max_scan_points=4096, max_imu_per_scan=48, hash_capacity_log2=15,
)
GRAVITY = (0.0, 0.0, -9.81)
TCFG = TConfig(imu=TImu(gravity=GRAVITY), **KW)
JCFG = JConfig(imu=JImu(gravity=GRAVITY), **KW)


@pytest.fixture(scope="module")
def short_seq():
    return t_dataset.make_synthetic_sequence(duration=2.0, points_per_scan=6000, seed=5)


def continue_run(odo, seq, start, stop):
    """Feed scans [start, stop) and the IMU after the filter clock, as
    `Odometry.run` would have (a checkpoint does not carry the pending
    samples: they are fed again, to a restored driver and to one that ran on)."""
    odo.imu_pending = []
    imu_iter = iter([r for r in seq.imu if r.t > odo.t_last_update])
    next_imu = next(imu_iter, None)
    out = None
    for scan in seq.scans[start:stop]:
        while next_imu is not None and next_imu.t <= scan.end_time + 0.05:
            odo.feed_imu(next_imu)
            next_imu = next(imu_iter, None)
        out = odo.process_scan(scan)
    return out


def assert_maps_bit_equal(a, b, why=""):
    for name, x, y in zip(a._fields, convert.to_numpy(a), convert.to_numpy(b)):
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32), err_msg=f"{name} {why}")


def where_runs_part(a, c) -> str:
    """Where two drivers' runs part, for a failure's message: the first
    scan whose position differs and by how many ulps, then every state
    field (ulps) and map field (differing words) that differs at the end."""
    def ulps(x, y):
        x, y = (np.asarray(v, np.float32).view(np.int32).astype(np.int64) for v in (x, y))
        return int(np.abs(x - y).max()) if x.size else 0

    parts = [f"scan {k}: position {ulps(p, q)} ulps apart"
             for k, (p, q) in enumerate(zip(a.trajectory_p, c.trajectory_p))
             if not np.array_equal(p, q)][:1]
    parts += [f"state.{n}: {ulps(x.numpy(), y.numpy())} ulps"
              for n, x, y in zip(a.state._fields, a.state, c.state) if not torch.equal(x, y)]
    parts += [f"map.{n}: {int((x.view(np.int32) != y.view(np.int32)).sum())} words"
              for n, x, y in zip(a.voxmap._fields, convert.to_numpy(a.voxmap),
                                 convert.to_numpy(c.voxmap))
              if not np.array_equal(x.view(np.int32), y.view(np.int32))]
    return "; ".join(parts) or "no difference"


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


def test_checkpoint_resume_exact(tmp_path, short_seq):
    """Run A: scans 0..9 straight.  Run B: 0..4, checkpoint, restore into a
    fresh instance, 5..9.  Trajectories and maps must match exactly."""
    a = TOdometry(TCFG, device="cpu")
    a.run(short_seq, max_scans=10)

    b = TOdometry(TCFG, device="cpu")
    b.run(short_seq, max_scans=5)
    ckpt = str(tmp_path / "ckpt")
    t_checkpoint.save_checkpoint(ckpt, b)

    c = TOdometry(TCFG, device="cpu")
    assert t_checkpoint.load_checkpoint(ckpt, c) is c
    assert c.initialized and c.t_last_update == b.t_last_update
    assert c.voxmap.skey.dtype == torch.int32 and c.state.P.dtype == torch.float32
    continue_run(c, short_seq, 5, 10)

    why = where_runs_part(a, c)
    np.testing.assert_array_equal(np.stack(a.trajectory_p), np.stack(c.trajectory_p), err_msg=why)
    np.testing.assert_array_equal(np.stack(a.trajectory_R), np.stack(c.trajectory_R), err_msg=why)
    assert a.trajectory_t == c.trajectory_t, why
    assert_maps_bit_equal(a.voxmap, c.voxmap, why)
    for x, y in zip(a.state, c.state):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=why)


def test_checkpoint_layout_is_the_jax_packages(tmp_path, short_seq):
    t_odo, j_odo = TOdometry(TCFG, device="cpu"), JOdometry(JCFG)
    t_odo.run(short_seq, max_scans=2)
    j_odo.run(short_seq, max_scans=2)
    t_checkpoint.save_checkpoint(str(tmp_path / "t"), t_odo)
    j_checkpoint.save_checkpoint(str(tmp_path / "j"), j_odo)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    with np.load(tmp_path / "t" / "arrays.npz") as tz, np.load(tmp_path / "j" / "arrays.npz") as jz:
        assert sorted(tz.files) == sorted(jz.files)
        for name in tz.files:
            assert tz[name].shape == jz[name].shape, name
            assert tz[name].dtype == jz[name].dtype, name


def test_checkpoint_from_jax_continues_in_the_port(tmp_path, short_seq):
    """JAX runs 5 scans and saves; the port loads, and its next step agrees
    with JAX's own next step."""
    j = JOdometry(JCFG)
    j.run(short_seq, max_scans=5)
    ckpt = str(tmp_path / "from_jax")
    j_checkpoint.save_checkpoint(ckpt, j)

    t = TOdometry(TCFG, device="cpu")
    t_checkpoint.load_checkpoint(ckpt, t)
    # the map's words arrive unchanged (payloads are f32 bits)
    for name in t.voxmap._fields:
        np.testing.assert_array_equal(
            getattr(t.voxmap, name).numpy().view(np.int32),
            np.asarray(getattr(j.voxmap, name)).view(np.int32), err_msg=name,
        )
    assert t.trajectory_t == j.trajectory_t and t.t_last_evict == j.t_last_evict

    t_diag = continue_run(t, short_seq, 5, 6)
    j_diag = continue_run(j, short_seq, 5, 6)
    np.testing.assert_allclose(t.trajectory_p[-1], j.trajectory_p[-1], atol=1e-3)
    np.testing.assert_allclose(t.trajectory_R[-1], j.trajectory_R[-1], atol=1e-3)
    assert int(t_diag["icp_iterations"]) == int(j_diag["icp_iterations"])
    for name in ("origin", "skey", "d_skey"):
        np.testing.assert_array_equal(
            getattr(t.voxmap, name).numpy(), np.asarray(getattr(j.voxmap, name)), err_msg=name
        )


def test_checkpoint_from_the_port_continues_in_jax(tmp_path, short_seq):
    t = TOdometry(TCFG, device="cpu")
    t.run(short_seq, max_scans=5)
    ckpt = str(tmp_path / "from_torch")
    t_checkpoint.save_checkpoint(ckpt, t)

    j = JOdometry(JCFG)
    j_checkpoint.load_checkpoint(ckpt, j)
    for name in t.voxmap._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(j.voxmap, name)).view(np.int32),
            getattr(t.voxmap, name).numpy().view(np.int32), err_msg=name,
        )
    np.testing.assert_array_equal(np.asarray(j.state.P), t.state.P.numpy())
    t_diag = continue_run(t, short_seq, 5, 6)
    j_diag = continue_run(j, short_seq, 5, 6)
    np.testing.assert_allclose(np.asarray(j.trajectory_p[-1]), t.trajectory_p[-1], atol=1e-3)
    assert int(t_diag["icp_iterations"]) == int(j_diag["icp_iterations"])


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def test_export_roundtrip(tmp_path, short_seq):
    odo = TOdometry(TCFG, device="cpu")
    odo.run(short_seq, max_scans=6)
    cloud = str(tmp_path / "map.pcd")
    traj = str(tmp_path / "traj.json")
    t_export.save_run(odo, cloud, traj)

    pts = t_export.read_pcd(cloud)
    assert len(pts) == int(odo.voxmap.num_voxels())
    times, Rs, ps = t_export.read_trajectory_json(traj)
    assert len(times) == len(odo.trajectory_t)
    np.testing.assert_allclose(np.asarray(ps), np.stack(odo.trajectory_p), atol=1e-9)
    np.testing.assert_allclose(np.asarray(Rs[2]), odo.trajectory_R[2], atol=1e-9)
    # the files are the JAX package's formats: its readers take them
    np.testing.assert_array_equal(j_export.read_pcd(cloud), pts)
    assert j_export.read_trajectory_json(traj)[0] == times


@pytest.fixture(scope="module")
def same_map_in_both():
    """One small map, built by the port, and the same arrays as a JAX map."""
    rng = np.random.default_rng(3)
    # 64 voxel sites, 5 points each -> per-voxel counts of 5
    sites = rng.uniform(-5, 5, size=(64, 3)).astype(np.float32)
    pts = np.repeat(sites, 5, axis=0) + rng.normal(scale=0.02, size=(320, 3)).astype(np.float32)
    covs = np.tile(np.eye(3, dtype=np.float32) * 1e-4, (320, 1, 1))
    m = t_vm.VoxelMap.create(1 << 12, device="cpu")
    m, _ = t_vm.insert(
        m, torch.as_tensor(pts), t_vm.pack_cov(torch.as_tensor(covs)),
        torch.ones(320, dtype=torch.bool), voxel_size=TCFG.map_voxel_size,
        max_points_per_voxel=1000,
    )
    return m, j_vm.VoxelMap(*(jnp.asarray(a) for a in convert.to_numpy(m)))


def test_dense_cloud_export_equals_jax(same_map_in_both):
    t_map, j_map = same_map_in_both
    sparse, counts = t_export.map_to_cloud(t_map)
    j_sparse, j_counts = j_export.map_to_cloud(j_map)
    np.testing.assert_array_equal(counts, j_counts)
    np.testing.assert_allclose(sparse, j_sparse, rtol=1e-6, atol=1e-7)  # one fold each
    assert counts.max() > 1

    dense = t_export.map_to_dense_cloud(t_map, samples_per_voxel=3)
    assert len(dense) == int(np.minimum(counts, 3).sum()) > len(sparse)
    np.testing.assert_array_equal(dense, t_export.map_to_dense_cloud(t_map, samples_per_voxel=3))
    # the same host draw (numpy, seed 0) around statistics equal to f32 rounding
    j_dense = j_export.map_to_dense_cloud(j_map, samples_per_voxel=3)
    np.testing.assert_allclose(dense, j_dense, rtol=1e-5, atol=1e-6)
    other = t_export.map_to_dense_cloud(t_map, samples_per_voxel=3, seed=1)
    assert not np.array_equal(dense, other)


def test_pcd_and_trajectory_files_equal_jax(tmp_path, rng):
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    Rs = [np.eye(3) for _ in range(4)]
    ps = [rng.normal(size=3) for _ in range(4)]
    t_export.write_pcd(str(tmp_path / "t.pcd"), pts)
    j_export.write_pcd(str(tmp_path / "j.pcd"), pts)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    t_export.write_trajectory_json(str(tmp_path / "t.json"), [0.0, 0.1, 0.2, 0.3], Rs, ps)
    j_export.write_trajectory_json(str(tmp_path / "j.json"), [0.0, 0.1, 0.2, 0.3], Rs, ps)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert "POINTS 50" in (tmp_path / "t.pcd").read_text()


# ---------------------------------------------------------------------------
# rosbag2, native runtime
# ---------------------------------------------------------------------------


def assert_sequences_equal(a, b):
    assert len(a.imu) == len(b.imu) and len(a.scans) == len(b.scans)
    for x, y in zip(a.imu, b.imu):
        assert x.t == y.t
        np.testing.assert_array_equal(x.gyro, y.gyro)
        np.testing.assert_array_equal(x.accel, y.accel)
    for x, y in zip(a.scans, b.scans):
        np.testing.assert_array_equal(x.points, y.points)
        np.testing.assert_array_equal(x.t, y.t)
        assert (x.start_time, x.end_time) == (y.start_time, y.end_time)


def test_rosbag2_roundtrip(tmp_path, rng):
    t0 = 1000.0
    imu_msgs = []
    for i in range(40):
        t = t0 + i * 0.0025
        imu_msgs.append((t, encode_imu(t, rng.normal(size=3), rng.normal(size=3) + [0, 0, 9.81])))
    cloud_msgs, true_clouds = [], []
    for k in range(2):
        xyz = rng.uniform(-5, 5, size=(50, 3)).astype(np.float32)
        xyz[7] = np.nan  # dropped
        ts = np.sort(t0 + 0.05 * k + rng.uniform(0, 0.05, 50))
        true_clouds.append((xyz, ts))
        cloud_msgs.append((ts[0], encode_cloud(ts[0], xyz, ts)))
    bag = str(tmp_path / "test.db3")
    make_bag(bag, imu_msgs, cloud_msgs)

    seq = t_rosbag2.load_rosbag2(bag)
    assert len(seq.imu) == 40 and len(seq.scans) == 2
    for rec, (xyz, ts) in zip(seq.scans, true_clouds):
        ok = np.isfinite(xyz).all(axis=1)
        np.testing.assert_array_equal(rec.points, xyz[ok])
        np.testing.assert_array_equal(rec.t, ts[ok])
        assert rec.end_time == ts[ok].max()
    assert_sequences_equal(seq, j_rosbag2.load_rosbag2(bag))
    assert len(t_rosbag2.load_rosbag2(bag, max_scans=1).scans) == 1
    with pytest.raises(KeyError):
        t_rosbag2.load_rosbag2(bag, lidar_topic="/nope")


def test_rosbag2_golden_fixture_equals_jax():
    bag = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden.db3")
    seq = t_rosbag2.load_rosbag2(bag)
    assert len(seq.imu) > 0 and len(seq.scans) > 0
    assert_sequences_equal(seq, j_rosbag2.load_rosbag2(bag))
    assert_sequences_equal(seq, t_rosbag2.load_rosbag2(os.path.dirname(bag)))


def scan_to_pack(rng, n=1000):
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz[17] = np.nan  # dropped
    return xyz, 1000.0 + np.sort(rng.uniform(-0.1, 0, n))


@pytest.mark.parametrize("cap", [1200, 64])
def test_pack_scan_native_vs_numpy(rng, monkeypatch, cap):
    xyz, t = scan_to_pack(rng)
    with monkeypatch.context() as mp:
        mp.setattr(t_native, "load", lambda build_if_missing=True: None)
        assert not t_native.native_available()
        plain = t_native.pack_scan(xyz, t, 1000.0, cap)
    finite = np.isfinite(xyz).all(axis=1)
    n = min(int(finite.sum()), cap)
    assert plain[3] == n and plain[2].sum() == n and plain[2].dtype == bool
    np.testing.assert_array_equal(plain[0][:n], xyz[finite][:n])
    np.testing.assert_array_equal(plain[1][:n], (t[finite][:n] - 1000.0).astype(np.float32))
    assert not plain[0][n:].any() and not plain[1][n:].any()
    if not t_native.native_available():
        pytest.skip("native runtime not built: the numpy path is checked above")
    native = t_native.pack_scan(xyz, t, 1000.0, cap)
    for a, b in zip(native[:3], plain[:3]):
        np.testing.assert_array_equal(a, b)
    assert native[3] == plain[3]
    # both packages bind one source's library, the same way
    for a, b in zip(native[:3], j_native.pack_scan(xyz, t, 1000.0, cap)[:3]):
        np.testing.assert_array_equal(a, b)
    assert t_native.IMU_DTYPE == j_native.IMU_DTYPE


def test_native_spsc_queue():
    if not t_native.native_available():
        with pytest.raises(t_native.NativeRuntimeUnavailable):
            t_native.NativeSpscQueue(t_native.IMU_DTYPE, 16)
        pytest.skip("native runtime not built")
    q = t_native.NativeSpscQueue(t_native.IMU_DTYPE, 4)
    rec = np.zeros((), dtype=t_native.IMU_DTYPE)
    for i in range(4):
        rec["t"] = float(i)
        assert q.push(rec)
    assert not q.push(rec) and len(q) == 4  # full
    assert q.pop()["t"] == 0.0
    np.testing.assert_array_equal(q.pop_all()["t"], [1.0, 2.0, 3.0])
    assert q.pop() is None


PACK_AND_COMPARE = """
import numpy as np
from eskf_lio_torch.io import native_runtime as n
rng = np.random.default_rng(3)
xyz = rng.normal(size=(500, 3)).astype(np.float32)
t = 1000.0 + np.sort(rng.uniform(-0.1, 0, 500))
native = n.pack_scan(xyz, t, 1000.0, 640)
assert n.native_available()
n.load = lambda build_if_missing=True: None
plain = n.pack_scan(xyz, t, 1000.0, 640)
assert all(np.array_equal(a, b) for a, b in zip(native, plain))
print(n.library_path())
"""


def test_port_never_loads_a_library_another_builder_is_writing(tmp_path):
    """The JAX package builds `native/libeskf_runtime.so` in place and
    without a lock, so while its `make` links, the file is there but short;
    the port loaded that file and raised OSError ("file too short") when it
    packed its first scan then (ROADMAP.md, queue 3).  A copy of the port
    and of `native/`'s sources beside such a file (an ELF header alone), in
    a process of its own: the port leaves it alone, builds and loads its
    own library under `build/native/`, and packs a scan as the numpy path
    does."""
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    root = tmp_path / "checkout"
    shutil.copytree(repo / "eskf_lio_torch", root / "eskf_lio_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "native").mkdir()
    for name in ("Makefile", "eskf_runtime.cpp"):
        shutil.copy(repo / "native" / name, root / "native")
    # a 64-bit ELF header and nothing after it, as a linker starts the file
    head = Path(sys.executable).resolve().read_bytes()[:64]
    (root / "native" / "libeskf_runtime.so").write_bytes(head)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PACK_AND_COMPARE], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    built = Path(proc.stdout.split()[-1])
    assert built.parent == root / "build" / "native" and built.is_file()
    assert (root / "native" / "libeskf_runtime.so").stat().st_size == 64


# ---------------------------------------------------------------------------
# profiling, viewers
# ---------------------------------------------------------------------------


def test_stopwatch():
    sw = t_profiling.Stopwatch()
    with sw.lap() as out:
        out["result"] = torch.ones((64, 64)) @ torch.ones((64, 64))
    with sw.lap():
        pass
    assert len(sw.laps) == 2
    assert sw.avg > 0 and sw.max >= sw.avg
    assert "avg" in sw.summary() and "n=2" in sw.summary()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with t_profiling.device_trace(str(tmp_path / "trace")):
        with t_profiling.annotate("a_named_region"):
            torch.ones((32, 32)) @ torch.ones((32, 32))
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    assert "a_named_region" in files[0].read_text()


def test_offline_viewer(tmp_path, short_seq):
    pytest.importorskip("matplotlib")
    from eskf_lio_torch.viz.visualize import render

    odo = TOdometry(TCFG, device="cpu")
    odo.run(short_seq, max_scans=4)
    cloud, traj, out = (str(tmp_path / n) for n in ("map.pcd", "traj.json", "view.png"))
    t_export.save_run(odo, cloud, traj)
    render(cloud, traj, out)
    assert os.path.getsize(out) > 10_000


def test_live_viewer(tmp_path, short_seq):
    pytest.importorskip("matplotlib")
    from eskf_lio_torch.viz.live import LiveViewer

    out = str(tmp_path / "live.png")
    viewer = LiveViewer(out, every=3)
    odo = TOdometry(TCFG, device="cpu")
    odo.run(short_seq, max_scans=7, on_scan=viewer.on_scan)
    viewer.close()
    assert viewer.renders >= 1
    assert os.path.getsize(out) > 10_000
