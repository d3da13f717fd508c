"""The port's tracer (`eskf_lio_torch/utils/profiling.py::Tracer`) on the
CPU: spans that nest and share sweep ids and export as a Chrome trace;
nothing recorded or made without a tracer; the eager step's stage spans in
order inside `Odometry.process_scan`; the threaded runner's spans tiling each
posed sweep from its put to its pose; the replay row's spans; the command
line's `--trace-out`.  The card's side (stamps inside the captured step,
device spans) is in `tests/test_torch_cuda.py`."""

import json

import numpy as np
import pytest
import torch

from eskf_lio_torch import cli
from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io import dataset
from eskf_lio_torch.models import eskf
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.pipeline import odometry, replay, stream
from eskf_lio_torch.pipeline.odometry import Odometry
from eskf_lio_torch.pipeline.stream import StreamingRunner, merged_stream
from eskf_lio_torch.utils import profiling
from eskf_lio_torch.utils.profiling import Tracer

torch.set_num_threads(2)

STAGES = ("predict", "preprocess", "align", "pose_update", "map_insert")
PROCESS_CHILDREN = ("chunk_build", "scan_pack", "upload", "step_launch", "read_back", "record")
# eviction every 0.3 s beyond 3 m, so that a short run evicts
CFG = Config(
    imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), translation_noise=1e-4, rotation_noise=3e-5,
    max_raw_points=2048, max_scan_points=1024, max_imu_per_scan=48, hash_capacity_log2=14,
    remove_period=0.3, remove_distance_threshold=3.0,
)


@pytest.fixture(scope="module")
def seq():
    return dataset.make_synthetic_sequence(duration=1.0, points_per_scan=1500, seed=3)


def by_sweep(tracer: Tracer) -> dict:
    """sweep -> name -> list of (start, end, parent, index)."""
    out: dict = {}
    for i, (name, a, b, parent, sweep) in enumerate(tracer.spans()):
        out.setdefault(sweep, {}).setdefault(name, []).append((a, b, parent, i))
    return out


def test_tracer_spans_nest_share_sweep_ids_and_export_as_chrome_json(tmp_path, monkeypatch):
    monkeypatch.setattr(Tracer, "SPANS", 3)
    tr = Tracer()
    outer = tr.begin("outer", 7)
    tr.begin("a")
    tr.switch("b")
    tr.end()
    tr.record("elsewhere", 5, 9, sweep=7)
    tr.count("polls")
    tr.count("polls", 2)
    tr.end()
    spans = tr.spans()
    assert [s[0] for s in spans] == ["outer", "a", "b", "elsewhere"]
    assert {s[4] for s in spans} == {7}  # the children take the parent's sweep
    assert [s[3] for s in spans] == [-1, outer, outer, outer]
    (_, o0, o1, _, _), (_, a0, a1, _, _), (_, b0, b1, _, _) = spans[:3]
    assert o0 <= a0 <= a1 == b0 <= b1 <= o1  # `switch` tiles: a ends where b starts
    assert tr.counters == {"polls": 3}
    assert tr.summary()["spans"]["a"]["count"] == 1
    path = tmp_path / "t.json"
    tr.export(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    xs = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(xs) == {"outer", "a", "b", "elsewhere"}
    assert xs["a"]["ts"] >= xs["outer"]["ts"] and xs["a"]["args"]["sweep"] == 7
    assert xs["elsewhere"]["tid"] != xs["outer"]["tid"]  # its own track
    assert any(e["ph"] == "C" and e["args"] == {"polls": 3} for e in events)
    # the lists grew past their first room (3 spans) and keep every span
    for k in range(20):
        tr.begin("x", k)
        tr.end()
    assert tr.n == 24 and len(tr._name) == 24
    assert [s[4] for s in tr.spans()[4:]] == list(range(20))
    assert tr.spans()[:4] == spans


def test_overlaps_name_the_leaf_spans_and_the_rest():
    tr = Tracer()
    tr.begin("parent", 0, t=100)
    tr.begin("child", t=100)
    tr.end(t=300)
    tr.end(t=400)
    tr.record("other", 350, 500)
    named = dict(tr.overlaps(200, 600))
    assert named["child"] == pytest.approx(1e-4)  # 100 ns of it, in ms
    assert named["other"] == pytest.approx(1.5e-4)
    assert "parent" not in named  # its child speaks for it
    assert named["outside the program"] == pytest.approx(1.5e-4)  # 300-350 and 500-600


def test_nothing_is_traced_or_made_without_a_tracer(seq, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a tracer was used on an untraced path")

    for name in ("__init__", "begin", "end", "switch", "record", "count", "stage",
                 "device_begin", "attach", "anchor"):
        monkeypatch.setattr(Tracer, name, refuse)
    monkeypatch.setattr(profiling, "now", refuse)
    monkeypatch.setattr(stream, "now", refuse)  # bound at the runner's import
    odo = Odometry(CFG, device="cpu")
    assert odo.tracer is None
    odo.run(seq, max_scans=4)
    assert len(odo.trajectory_t) == 4
    runner = StreamingRunner(CFG, device="cpu")
    assert runner._put_t is None
    runner.run(merged_stream(seq), max_scans=3)
    init_scan, chunks, scans, evicts, updates, _ = replay.pack_sequence(
        CFG, seq, max_scans=3, device="cpu")
    voxmap, _ = odometry.make_init_step(CFG, "cpu")(
        vm.VoxelMap.create(CFG.hash_capacity, CFG.map_delta_capacity, device="cpu"), init_scan)
    out = replay.make_replay_step(CFG, "cpu")(
        eskf.init_state(CFG, "cpu"), voxmap, torch.eye(3), torch.zeros(3),
        chunks, scans, evicts, updates)
    assert out[5].shape == (chunks.dt.shape[0], 3)


@pytest.mark.parametrize("shards", [None, 2])
def test_eager_stage_spans_come_in_order_inside_process_scan(seq, shards):
    """The single-device driver, and the sharded one (its step takes the
    same marks)."""
    tr = Tracer()
    if shards is None:
        odo = Odometry(CFG, device="cpu", tracer=tr)
    else:
        from eskf_lio_torch.parallel.sharded_map import ShardedOdometry

        odo = ShardedOdometry(CFG, n_devices=shards, device="cpu", tracer=tr)
    odo.run(seq)
    sweeps = by_sweep(tr)
    posed = range(1, len(odo.trajectory_t))
    evicted = 0
    for k in posed:
        spans = sweeps[k]
        (p0, p1, _, pi), = spans["process_scan"]
        children = [spans[n][0] for n in PROCESS_CHILDREN]
        assert all(c[2] == pi for c in children)
        assert children[0][0] == p0 and children[-1][1] == p1
        for (a0, a1, *_), (b0, b1, *_) in zip(children, children[1:]):
            assert a1 == b0 <= b1  # in order, without gaps
        (l0, l1, _, li) = spans["step_launch"][0]
        names = [n for n in (*STAGES, "fold", "evict") if n in spans]
        assert names[:5] == list(STAGES)
        stages = [spans[n][0] for n in names]
        assert all(s[2] == li and l0 <= s[0] <= s[1] <= l1 for s in stages)
        for (a0, a1, *_), (b0, b1, *_) in zip(stages, stages[1:]):
            # predict < preprocess < align < pose_update < map_insert [< fold] [< evict]
            assert a1 == b0
        # one GN tick a pass, inside `align`
        diag = odo.diags[k - 1]
        assert len(spans["gn"]) == int(diag["icp_iterations"])
        assert all(spans["align"][0][0] <= t0 <= spans["align"][0][1] for t0, *_ in spans["gn"])
        evicted += "evict" in spans
    assert evicted >= 1


def test_streaming_spans_tile_each_posed_sweep_from_put_to_pose(seq):
    tr = Tracer()
    runner = StreamingRunner(CFG, device="cpu", tracer=tr)
    runner.run(merged_stream(seq))
    sweeps = by_sweep(tr)
    n = len(runner.odo.trajectory_t)
    assert n == len(seq.scans)
    for k in range(1, n):
        spans = sweeps[k]
        for name in ("scan_put", "scan_queue", "gate", "process_scan", "on_scan"):
            assert len(spans[name]) == 1, (k, name)
        put, queued, gate = spans["scan_put"][0], spans["scan_queue"][0], spans["gate"][0]
        proc, on = spans["process_scan"][0], spans["on_scan"][0]
        assert queued[0] == put[0]  # the queue's wait starts with the put
        assert queued[1] <= gate[0] <= gate[1] <= proc[0] <= proc[1] <= on[0]
        # what no span covers between the put and the pose: the loop's own lines
        untraced = (gate[0] - queued[1]) + (proc[0] - gate[1]) + (on[0] - proc[1])
        assert untraced < 0.05 * (on[0] - put[0]) + 2e6
        # the first IMU record after the sweep is pushed under its id
        assert spans["imu_push"][0][0] >= put[0]
    assert tr.counters.get("gate_polls", 0) >= 0
    assert sweeps[0]["scan_put"] and "process_scan" not in sweeps[0]  # the init sweep


def test_replay_rows_are_traced_with_their_stages(seq):
    tr = Tracer()
    init_scan, chunks, scans, evicts, updates, _ = replay.pack_sequence(
        CFG, seq, max_scans=4, device="cpu")
    voxmap, _ = odometry.make_init_step(CFG, "cpu")(
        vm.VoxelMap.create(CFG.hash_capacity, CFG.map_delta_capacity, device="cpu"), init_scan)
    step = replay.make_replay_step(CFG, "cpu", tracer=tr)
    carry = (eskf.init_state(CFG, "cpu"), voxmap, torch.eye(3), torch.zeros(3))
    *carry, _, _, diags = step(*carry, chunks, scans, evicts, updates)
    *_, diags2 = step(*carry, chunks, scans, evicts, updates)
    sweeps = by_sweep(tr)
    n_rows = chunks.dt.shape[0]
    assert sorted(k for k in sweeps if "row" in sweeps[k]) == list(range(2 * n_rows))
    for k in range(2 * n_rows):
        (r0, r1, _, ri), = sweeps[k]["row"]
        copy_out = sweeps[k]["copy_out"][0]
        assert copy_out[2] == ri and r0 <= copy_out[0] <= copy_out[1] <= r1
        assert [sweeps[k][n][0][2] for n in STAGES] == [ri] * 5
    summary = tr.summary()
    assert summary["spans"]["row"]["count"] == 2 * n_rows
    assert summary["spans"]["gn"]["count"] == int(diags["icp_iterations"].sum()
                                                  + diags2["icp_iterations"].sum())


def test_cli_trace_out_writes_a_chrome_trace(tmp_path, capsys):
    path = tmp_path / "trace.json"
    assert cli.main(["--synthetic", "0.6", "--points-per-scan", "1500", "--stream",
                     "--device", "cpu", "--trace-out", str(path)]) == 0
    assert f"saved {path}" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"scan_put", "scan_queue", "gate", "process_scan", "read_back", "on_scan",
            "predict", "imu_push"} <= names
    assert np.all([e["dur"] >= 0 for e in events if e["ph"] == "X"])
