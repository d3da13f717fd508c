"""The port's multi-process runtime (`eskf_lio_torch/parallel/distributed.py`
and the sharded driver across processes): two localhost processes under
`torch.distributed` with the `gloo` backend on CPU tensors, two local map
shards each (D = 4), against the one-process four-shard run of the port and
of the JAX package — the counterpart of `tests/test_distributed.py`, at the
sizes of `tests/_dist_worker.py`.

Tolerances: both processes hold the same replicated state bit for bit
(digests every scan, positions at 1e-6); two processes against the port's
one process 1e-6 m (the shards' sums are added pairwise, the same f32
expression in both layouts) and against the JAX package's one process
2e-2 m (`tests/test_distributed.py`'s bound: the same sums in another
order); a run resumed from a checkpoint 1e-3 m (restore is exact; on this
CPU path the continuation is too).  The captured sharded step's function
under the group (its all-reduce inside every pass of the GN loop) equals
the eager step of the same two processes and the one-process captured run
bit for bit.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist_worker import (
    GRAPHED_DURATION_S, distinct_voxels, graphed_on_cpu, make_seq, run_record, worker_config,
)
from eskf_lio_torch.io import export
from eskf_lio_torch.parallel import distributed as dist
from eskf_lio_torch.parallel.distributed import ShardMesh
from eskf_lio_torch.parallel.sharded_map import ShardedOdometry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
PROCESS_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_processes(commands, env=None):
    """Start the commands together, wait for each under a timeout of its
    own, kill what is left; returns [(returncode, stdout, stderr)]."""
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for cmd in commands
    ]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=PROCESS_TIMEOUT_S)
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_two_process_sharded_run(tmp_path):
    port = _free_port()
    outs = [str(tmp_path / f"out_{i}.json") for i in range(2)]
    ckpt = str(tmp_path / "ckpt")
    done = run_processes([
        [sys.executable, WORKER, "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(i), "--out", outs[i], "--ckpt", ckpt]
        for i in range(2)
    ])
    for rc, _, err in done:
        assert rc == 0, err[-3000:]
    results = []
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))

    assert [r["process"] for r in results] == [0, 1]
    assert results[0]["backend"] == "gloo" and results[0]["global_shards"] == 4
    assert not results[0]["diverged"]
    # both processes hold the identical replicated state, scan by scan
    p0, p1 = (np.asarray(r["positions"]) for r in results)
    np.testing.assert_allclose(p0, p1, atol=1e-6)
    assert len(results[0]["state_digests"]) == 6
    assert results[0]["state_digests"] == results[1]["state_digests"]
    assert results[0]["icp_iterations"] == results[1]["icp_iterations"]
    assert results[0]["map_voxels"] == results[1]["map_voxels"] > 1000

    # checkpoint + resume across the process group: only process 0 wrote
    assert sorted(os.listdir(f"{ckpt}_0")) == ["arrays.npz", "meta.pkl"]
    assert not os.path.exists(f"{ckpt}_1")
    r0 = np.asarray(results[0]["resumed_positions"])
    assert r0.shape == p0.shape
    np.testing.assert_allclose(r0, p0, atol=1e-3)
    np.testing.assert_allclose(np.asarray(results[1]["resumed_positions"]), r0, atol=1e-6)
    assert abs(results[0]["resumed_map_voxels"] - results[0]["map_voxels"]) <= 5

    # the same four shards in one process
    ref = ShardedOdometry(worker_config(), n_devices=4, device="cpu")
    ref.run(make_seq(), max_scans=6)
    np.testing.assert_allclose(p0, ref.positions, atol=1e-6)
    assert distinct_voxels(ref.voxmap) == results[0]["map_voxels"]

    # and the JAX package's one-process mesh of four devices on the same
    # configuration and sequence (the reference of tests/test_distributed.py)
    from _dist_worker import make_seq as j_make_seq, worker_config as j_worker_config
    from eskf_lio_tpu.parallel.sharded_map import ShardedOdometry as JSharded

    j_ref = JSharded(j_worker_config(), n_devices=4)
    j_ref.run(j_make_seq(), max_scans=6)
    np.testing.assert_allclose(p0, j_ref.positions, atol=2e-2)


def test_two_process_graphed_step_equals_eager_and_one_process(tmp_path):
    """The captured sharded step under a process group: two `gloo`
    processes, two shards each, run `GraphedShardedScanStep` with its
    graphs' function called in select mode (every GN pass run, so the
    43-float all-reduce sits inside every pass, as it sits inside the WHILE
    node of the graph under `nccl`) under `NoHostRead`, over 12 scans.
    Each process's run equals its eager sharded step, the two processes
    agree, and both equal the one-process captured run of the four shards,
    bit for bit (trajectory, diagnostics, every word of the gathered map);
    the JAX package's one-process mesh of four devices is within 2e-2 m over
    the six scans that `test_two_process_sharded_run` holds to that bound.
    (Past them the two packages' runs of this 1,800-point configuration part
    by centimetres and more, whatever the layout: on some scans its GN loop
    takes tens of iterations, in both packages.)"""
    port = _free_port()
    outs = [str(tmp_path / f"graphed_{i}.json") for i in range(2)]
    done = run_processes([
        [sys.executable, WORKER, "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(i), "--out", outs[i], "--graphed"]
        for i in range(2)
    ])
    for rc, _, err in done:
        assert rc == 0, err[-3000:]
    results = []
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))
    assert [r["backend"] for r in results] == ["gloo", "gloo"]
    assert len(results[0]["graph"]["positions"]) == 12
    for r in results:
        assert r["graph"] == r["eager"]
    assert results[0]["graph"] == results[1]["graph"]
    assert sum(d["icp_iterations"] for d in results[0]["graph"]["diags"]) > 11

    seq = make_seq(GRAPHED_DURATION_S)
    one = graphed_on_cpu(ShardedOdometry(worker_config(), n_devices=4, device="cpu"))
    one.run(seq)
    assert run_record(one) == results[0]["graph"]

    from _dist_worker import worker_config as j_worker_config
    from eskf_lio_tpu.io import dataset as j_dataset
    from eskf_lio_tpu.parallel.sharded_map import ShardedOdometry as JSharded

    j_ref = JSharded(j_worker_config(), n_devices=4)
    j_ref.run(j_dataset.make_synthetic_sequence(
        duration=GRAPHED_DURATION_S, points_per_scan=1800, seed=7))
    np.testing.assert_allclose(np.asarray(results[0]["graph"]["positions"])[:6],
                               j_ref.positions[:6], atol=2e-2)


SMALL_YAML = (
    "imu:\n  frequency: 400.0\n"
    "local_map:\n  map_resolution: 0.3\n"
    "tpu:\n"
    "  max_raw_points: 8192\n"
    "  max_scan_points: 4096\n"
    "  max_imu_per_scan: 48\n"
    "  hash_capacity_log2: 15\n"
)


def test_two_process_cli_writes_from_process_zero_only(tmp_path):
    """`python -m eskf_lio_torch.cli --devices 4 --coordinator ...` as two
    processes: both exit 0, process 0 writes the cloud, the trajectory and
    the checkpoint, process 1 writes nothing; then both resume from it."""
    cfg = tmp_path / "small.yaml"
    cfg.write_text(SMALL_YAML)

    def command(i, port, *more):
        return [sys.executable, "-m", "eskf_lio_torch.cli", "--config", str(cfg),
                "--synthetic", "1.5", "--points-per-scan", "3000", "--device", "cpu",
                "--devices", "4", "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "2", "--process-id", str(i), *more]

    def artifacts(i, tag):
        return [str(tmp_path / f"{tag}{i}.{ext}") for ext in ("pcd", "json", "ckpt")]

    port = _free_port()
    done = run_processes([
        command(i, port, "--max-scans", "8", "--cloud-out", artifacts(i, "a")[0],
                "--traj-out", artifacts(i, "a")[1], "--checkpoint-out", artifacts(i, "a")[2])
        for i in range(2)
    ])
    for i, (rc, out, err) in enumerate(done):
        assert rc == 0, err[-3000:]
        assert f"distributed: process {i}/2" in out
        # the JAX CLI's report lines, on every process
        assert "step average elapsed time = " in out and "map voxels = " in out
    assert all(os.path.exists(p) for p in artifacts(0, "a"))
    assert not any(os.path.exists(p) for p in artifacts(1, "a"))
    assert f"saved {artifacts(0, 'a')[0]}" in done[0][1] and "saved" not in done[1][1]
    times, _, positions = export.read_trajectory_json(artifacts(0, "a")[1])
    assert len(times) == 8 and np.isfinite(np.asarray(positions)).all()
    assert len(export.read_pcd(artifacts(0, "a")[0])) > 500

    # both processes resume from process 0's checkpoint
    port = _free_port()
    done = run_processes([
        command(i, port, "--resume-from", artifacts(0, "a")[2], "--traj-out", artifacts(i, "b")[1])
        for i in range(2)
    ])
    for rc, _, err in done:
        assert rc == 0, err[-3000:]
    assert os.path.exists(artifacts(0, "b")[1]) and not os.path.exists(artifacts(1, "b")[1])
    assert len(export.read_trajectory_json(artifacts(0, "b")[1])[0]) >= 8


def test_a_process_without_its_peer_fails_with_a_message():
    """No stuck run: the group's timeout ends a process whose peer never
    comes."""
    code = (
        "from eskf_lio_torch.parallel import distributed as dist\n"
        f"dist.initialize('localhost:{_free_port()}', 2, 0, device='cpu', timeout_s=3.0)\n"
    )
    (rc, _, err), = run_processes([[sys.executable, "-c", code]])
    assert rc != 0
    assert "imed out" in err, err[-2000:]


# ---------------------------------------------------------------------------
# the helpers, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "device,per_host,cards,want",
    [("cpu", 2, 0, "gloo"), ("cpu", 1, 8, "gloo"), ("cuda", 1, 1, "nccl"),
     ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl"), ("cuda", 2, 1, "gloo"),
     ("cuda", 8, 4, "gloo")],
)
def test_backend_follows_the_layout(device, per_host, cards, want):
    """nccl when every process of a host has a card of its own; gloo for
    CPU tensors and for processes that share a card."""
    assert dist.choose_backend(torch.device(device), per_host, cards) == want


def test_initialize_without_arguments_is_single_process(monkeypatch):
    for name in (dist.ENV_COORDINATOR, dist.ENV_NUM_PROCESSES, dist.ENV_PROCESS_ID,
                 dist.ENV_PROCESSES_PER_HOST):
        assert name.startswith("ESKF_LIO_")
        monkeypatch.delenv(name, raising=False)
    assert dist.initialize(device="cpu") == (1, 0)
    assert dist.initialize(num_processes=1, device="cpu") == (1, 0)
    assert not dist.is_initialized()
    assert (dist.process_count(), dist.process_index()) == (1, 0)
    # without a group the collectives are the identity
    x = torch.arange(6.0).reshape(3, 2)
    assert dist.all_reduce_sum(x) is x and dist.gather_blocks(x) is x
    assert dist.gather_blocks(x, root=0) is x
    dist.barrier()
    dist.shutdown()


@pytest.mark.parametrize(
    "kw", [dict(num_processes=2), dict(coordinator="localhost:1"),
           dict(coordinator="localhost:1", num_processes=2),
           dict(coordinator="localhost:1", num_processes=2, process_id=2)],
    ids=["no-coordinator", "no-count", "no-id", "id-out-of-range"],
)
def test_initialize_refuses_half_a_layout(monkeypatch, kw):
    """Never one process in silence when more were asked for."""
    for name in (dist.ENV_COORDINATOR, dist.ENV_NUM_PROCESSES, dist.ENV_PROCESS_ID):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="process"):
        dist.initialize(device="cpu", **kw)
    assert not dist.is_initialized()


def test_initialize_reads_its_environment(monkeypatch):
    monkeypatch.setenv(dist.ENV_NUM_PROCESSES, "2")
    monkeypatch.delenv(dist.ENV_COORDINATOR, raising=False)
    with pytest.raises(ValueError, match="ESKF_LIO_COORDINATOR"):
        dist.initialize(device="cpu")


def test_mesh_deals_shards_in_rank_order():
    dev = torch.device("cpu")
    assert list(ShardMesh(4, dev, 2, 1).local_shards) == [2, 3]
    assert list(ShardMesh(4, dev, 4, 3).local_shards) == [3]
    assert list(ShardMesh(8, dev).local_shards) == list(range(8))
    mesh = ShardMesh(4, dev, 2, 1)
    full = torch.arange(24).reshape(8, 3)
    blocks = dist.local_blocks(full, mesh)
    assert [b.tolist() for b in blocks] == [full[4:6].tolist(), full[6:8].tolist()]
    blocks[0][0, 0] = -1  # a tensor of its own, not a view
    assert full[4, 0] == 12
    with pytest.raises(ValueError, match="do not divide"):
        dist.local_blocks(torch.zeros(6), mesh)


def test_a_group_of_one_process_still_calls_its_backend():
    """`initialize` with a coordinator and one process forms a real group
    (gloo here): the collectives run through it and `shutdown` leaves it."""
    assert dist.initialize(f"localhost:{_free_port()}", 1, 0, device="cpu", timeout_s=30.0) == (1, 0)
    try:
        assert dist.is_initialized() and torch.distributed.get_backend() == "gloo"
        x = torch.arange(43.0)
        assert torch.equal(dist.all_reduce_sum(x.clone()), x)
        assert torch.equal(dist.gather_blocks(x), x)
        assert torch.equal(dist.gather_blocks(x, root=0), x)
        dist.barrier()
        odo = ShardedOdometry(worker_config(), n_devices=2, device="cpu")
        assert odo.mesh == ShardMesh(2, torch.device("cpu"), 1, 0)
    finally:
        dist.shutdown(wait=False)
    assert not dist.is_initialized()
